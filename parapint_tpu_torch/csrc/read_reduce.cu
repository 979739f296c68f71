// Read-only streaming probe: the column sums out_b = sum_i W_b[i, :] of a
// batch of (n, n) float32 matrices, reading each W_b from device memory once.
//
// Replaces the TPU kernel tools/kernel_lab.py::cmd_bw, inner `kern` (the
// pl.pallas_call at kernel_lab.py:276): o = sum(w, axis=1, keepdims=True)
// over (C, n, n) chunks of W.  Contract:
//   in   W    (B, n, n) f32, row-major, n % 4 == 0, 16-byte aligned
//   out  out  (B, n) f32 (the caller views it as (B, 1, n))
//   scratch partial (B, ceil(n / rows), n) f32
// Summation order, which the plain version in ops/read_reduce.py repeats
// bit for bit: each tile of `rows` consecutive rows is summed down its rows
// in row order from 0.0f, then the tiles are summed in tile order from 0.0f.
// No atomics, so the result repeats bit for bit from run to run.
//
// What bounds it on an H100: bytes.  It does n^2 additions per matrix
// against 4 n^2 bytes of W: at (64, 1024, 1024) W is 268 MB, 80 us at
// 3.35 TB/s, while the additions need 1 us at the float32 rate.  The probe
// exists to measure what a pure read of W reaches on this card, the ceiling
// of the W-form back solve (csrc/winv_apply.cu), which moves the same bytes
// through the same nvcc -> ctypes route and launch path.
//
// The design is that kernel's read pattern without the GEMV: a CTA owns
// `rows` rows of one matrix (grid = column chunks x row tiles, by B) and
// each of its 256 threads owns 4 adjacent columns, read as 16-byte loads
// (one 4 KB row of a 1024-wide chunk per CTA row step, fully coalesced).
// Eight rows are loaded before they are added, so eight loads per thread
// are in flight.  The CTAs write their column partials to the scratch, and
// a second small kernel sums the tiles in order.  `rows` is a runtime
// argument, so one build sweeps it.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                  // columns per thread
constexpr int kChunk = kThreads * kVec;  // columns per CTA
constexpr int kUnroll = 8;               // rows loaded before they are added

__global__ void __launch_bounds__(kThreads)
read_rows_kernel(const float* __restrict__ W, float* __restrict__ partial, int n,
                 int rows, int ntiles, int nchunks) {
  const int blk = blockIdx.y;
  const int tile = blockIdx.x / nchunks;
  const int c0 = (blockIdx.x % nchunks) * kChunk + threadIdx.x * kVec;
  if (c0 >= n) return;
  const int r0 = tile * rows;
  const int r1 = min(n, r0 + rows);
  const float* p = W + (static_cast<size_t>(blk) * n + r0) * n + c0;

  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int r = r0;
  for (; r + kUnroll <= r1; r += kUnroll) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      v[u] = __ldg(reinterpret_cast<const float4*>(p + static_cast<size_t>(u) * n));
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      acc.x += v[u].x;
      acc.y += v[u].y;
      acc.z += v[u].z;
      acc.w += v[u].w;
    }
    p += static_cast<size_t>(kUnroll) * n;
  }
  for (; r < r1; ++r) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
    p += n;
  }
  *reinterpret_cast<float4*>(partial + (static_cast<size_t>(blk) * ntiles + tile) * n + c0) = acc;
}

// out[b, c] = sum_t partial[b, t, c], tiles summed in order.
__global__ void read_tiles_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                  int n, int ntiles) {
  const int blk = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  const float* p = partial + static_cast<size_t>(blk) * ntiles * n + c;
  float sum = 0.0f;
  for (int t = 0; t < ntiles; ++t) sum += p[static_cast<size_t>(t) * n];
  out[static_cast<size_t>(blk) * n + c] = sum;
}

}  // namespace

extern "C" {

// Launches both passes on `stream` and returns cudaGetLastError() as an int
// (0 = launched); does not synchronise.  The caller allocates `partial` as
// (B, ceil(n / rows), n) f32.
int read_reduce_f32(const float* W, float* partial, float* out, int B, int n, int rows,
                    void* stream) {
  if (B <= 0 || n <= 0) return 0;
  if (n % kVec != 0 || rows <= 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ntiles = (n + rows - 1) / rows;
  const int nchunks = (n + kChunk - 1) / kChunk;
  read_rows_kernel<<<dim3(ntiles * nchunks, B), kThreads, 0, st>>>(W, partial, n, rows, ntiles,
                                                                   nchunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  read_tiles_kernel<<<dim3((n + kThreads - 1) / kThreads, B), kThreads, 0, st>>>(partial, out, n,
                                                                                 ntiles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
