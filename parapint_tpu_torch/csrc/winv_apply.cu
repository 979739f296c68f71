// W-form block back solve: x_b = s_b * W_b^T D_b^{-1} W_b (s_b * rhs_b) for a
// batch of blocks, reading each W_b from device memory once.
//
// Replaces the TPU kernel parapint_tpu/ops/winv_apply.py::winv_apply_fused
// (Pallas body _apply_kernel).  Contract, identical to the Pallas kernel's:
//   in   W    (B, n, n) f32 or bf16, row-major (L^{-1} of the Ruiz-scaled
//              blocks; n % 8 == 0, n <= 4096)
//        d    (B, n)  f32 pivots (a zero pivot divides by 1)
//        s    (B, nk) f32 Ruiz scales, nk <= n (padded with 1 past nk)
//        rhs  (B, nk) f32 right-hand sides (padded with 0 past nk)
//   out  x    (B, nk) f32; every product accumulates in f32 (a bf16 W is
//              converted on load).
//
// What bounds it on an H100: bytes.  The work is two matrix-vector products
// per block, 4 n^2 flops against n^2 x sizeof(W) bytes of W: at the flagship
// shape W is (64, 1024, 1024) f32 = 268 MB, 80 us at 3.35 TB/s (40 us in
// bf16), while the arithmetic needs under 5 us.  Reading W once is the
// whole game.
//
// What the design does about it.  The TPU kernel holds a whole (C, n, n)
// chunk of W in VMEM for both products; 4 MB per block does not fit an SM.
// Here a CTA owns kRows rows of one block's W (grid = n/kRows tiles x B),
// and each thread owns fixed 4-wide column strips.  For a group of G rows
// the threads load their strips (16-byte loads, one 4 KB row per 256
// threads, fully coalesced), form the row dot products y_i = W[i,:] v with
// v = s * rhs by a warp shuffle and a shared-memory reduce over the 8 warps,
// scale z_i = y_i / d_i, and accumulate z_i W[i,:] into per-thread column
// accumulators while the rows are still in registers — so W is read once.
// Each CTA writes its column partial of W^T z to a (B, tiles, n) scratch;
// a second small kernel sums the tiles in a fixed order and applies s
// (deterministic: no atomics).  Right and simple first: TMA / cp.async
// pipelining and the bf16 16-byte loads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;                   // columns per thread per strip
constexpr int kChunk = kThreads * kVec;   // columns covered by one strip pass
constexpr int kRows = 64;                 // rows of W per CTA

__device__ inline void load4(const float* p, float out[kVec]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ inline void load4(const __nv_bfloat16* p, float out[kVec]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);  // 4 bf16, 8 bytes
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  out[0] = lo.x;
  out[1] = lo.y;
  out[2] = hi.x;
  out[3] = hi.y;
}

// NCH strips of kChunk columns cover n <= NCH * kChunk; G rows per group
// keep G * NCH * kVec floats of W in registers.
template <typename T, int NCH>
__global__ void __launch_bounds__(kThreads)
winv_rows_kernel(const T* __restrict__ W, const float* __restrict__ d,
                 const float* __restrict__ s, const float* __restrict__ rhs,
                 float* __restrict__ partial, int n, int nk, int ntiles) {
  constexpr int G = NCH == 1 ? 8 : (NCH == 2 ? 4 : 2);
  __shared__ float red[2][kWarps][G];

  const int blk = blockIdx.y;
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const T* Wb = W + static_cast<size_t>(blk) * n * n;
  const float* db = d + static_cast<size_t>(blk) * n;
  const float* sb = s + static_cast<size_t>(blk) * nk;
  const float* bb = rhs + static_cast<size_t>(blk) * nk;

  float v[NCH][kVec];
  float acc[NCH][kVec];
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const int c = k * kChunk + tid * kVec + e;
      v[k][e] = c < nk ? sb[c] * bb[c] : 0.0f;
      acc[k][e] = 0.0f;
    }
  }

  const int r0 = tile * kRows;
  const int r1 = min(n, r0 + kRows);
  int buf = 0;
  for (int g0 = r0; g0 < r1; g0 += G) {
    float wv[G][NCH][kVec];
    float p[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int i = g0 + g;
      p[g] = 0.0f;
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        const int c0 = k * kChunk + tid * kVec;
        if (i < r1 && c0 < n) {
          load4(Wb + static_cast<size_t>(i) * n + c0, wv[g][k]);
        } else {
#pragma unroll
          for (int e = 0; e < kVec; ++e) wv[g][k][e] = 0.0f;
        }
#pragma unroll
        for (int e = 0; e < kVec; ++e) p[g] += wv[g][k][e] * v[k][e];
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) p[g] += __shfl_xor_sync(0xffffffffu, p[g], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) red[buf][warp][g] = p[g];
    }
    // one barrier per group: red is double-buffered, so the next group's
    // writes never race this group's reads
    __syncthreads();
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int i = g0 + g;
      if (i < r1) {
        float y = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) y += red[buf][w][g];
        const float di = db[i];
        const float z = y / (fabsf(di) > 0.0f ? di : 1.0f);
#pragma unroll
        for (int k = 0; k < NCH; ++k) {
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[k][e] += z * wv[g][k][e];
        }
      }
    }
    buf ^= 1;
  }

  float* out = partial + (static_cast<size_t>(blk) * ntiles + tile) * n;
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    const int c0 = k * kChunk + tid * kVec;
    if (c0 < n) {
      *reinterpret_cast<float4*>(out + c0) =
          make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
    }
  }
}

// x[b, c] = s[b, c] * sum_t partial[b, t, c] for c < nk, tiles summed in order.
__global__ void winv_reduce_kernel(const float* __restrict__ partial,
                                   const float* __restrict__ s,
                                   float* __restrict__ x, int n, int nk,
                                   int ntiles) {
  const int blk = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nk) return;
  const float* p = partial + static_cast<size_t>(blk) * ntiles * n + c;
  float sum = 0.0f;
  for (int t = 0; t < ntiles; ++t) sum += p[static_cast<size_t>(t) * n];
  x[static_cast<size_t>(blk) * nk + c] = sum * s[static_cast<size_t>(blk) * nk + c];
}

template <typename T>
int launch(const T* W, const float* d, const float* s, const float* rhs,
           float* partial, float* x, int B, int n, int nk, void* stream) {
  if (B <= 0 || n <= 0) return 0;
  if (n % 8 != 0 || n > 4 * kChunk || nk > n) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ntiles = (n + kRows - 1) / kRows;
  const dim3 grid(ntiles, B);
  const int nch = (n + kChunk - 1) / kChunk;
  if (nch == 1) {
    winv_rows_kernel<T, 1><<<grid, kThreads, 0, st>>>(W, d, s, rhs, partial, n, nk, ntiles);
  } else if (nch == 2) {
    winv_rows_kernel<T, 2><<<grid, kThreads, 0, st>>>(W, d, s, rhs, partial, n, nk, ntiles);
  } else {
    winv_rows_kernel<T, 4><<<grid, kThreads, 0, st>>>(W, d, s, rhs, partial, n, nk, ntiles);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 rgrid((nk + kThreads - 1) / kThreads, B);
  winv_reduce_kernel<<<rgrid, kThreads, 0, st>>>(partial, s, x, n, nk, ntiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Rows per CTA: the caller allocates the (B, ceil(n / rows), n) f32 scratch.
int winv_apply_rows_per_cta() { return kRows; }

// Both launch on `stream` (row pass, then the tile reduction) and return
// cudaGetLastError() as an int (0 = launched).  Neither synchronises.
int winv_apply_f32(const float* W, const float* d, const float* s,
                   const float* rhs, float* partial, float* x, int B, int n,
                   int nk, void* stream) {
  return launch<float>(W, d, s, rhs, partial, x, B, n, nk, stream);
}

int winv_apply_bf16(const void* W, const float* d, const float* s,
                    const float* rhs, float* partial, float* x, int B, int n,
                    int nk, void* stream) {
  return launch<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(W), d, s, rhs,
                               partial, x, B, n, nk, stream);
}

}  // extern "C"
