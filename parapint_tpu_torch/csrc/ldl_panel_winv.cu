// Batched unpivoted LDL^T of symmetric f32 panels, with or without
// W = L^{-1}: one kernel template, two instantiations, five entries.
//
// Replaces the TPU kernels of parapint_tpu/ops/pallas_ldl.py:
//   kWithW = true   ldl_panels_slab_winv (_make_slab_kernel(with_w=True)),
//                   b % 8 == 0, b <= 128                         [K1]
//                   ldl_panels_batched_winv (_panel_kernel_batched_winv),
//                   any 1 <= b <= 128                            [K3]
//   kWithW = false  ldl_panels_slab      (_make_slab_kernel(with_w=False)),
//                   b % 8 == 0, b <= 128                         [K2]
//                   ldl_panels_batched   (_panel_kernel_batched), any
//                   1 <= b <= 128                                [K4]
//                   ldl_panels           (_panel_kernel), any 1 <= b <= 128
//                                                                [K5]
// The Pallas kernels differ in how they block the sweep (8-column slabs
// for K1/K2, one column per step for K3/K4/K5) and in how many panels one
// grid step holds (a batch chunk, for the TPU's single core); their function
// on the lower triangle is the same, and this kernel computes it for every
// entry with the slab blocking of _make_slab_kernel.  Nothing here needs
// b % 8 == 0: the last slab is b % 8 wide when b is not a multiple of 8.
// Contract, identical to the Pallas kernels' on the lower triangle:
//   in   A  (B, b, b) f32, row-major, symmetric up to roundoff; only the
//            LOWER triangle is read (the factor follows the true pivot
//            column, never row j of the trailing block);
//   out  LD (B, b, b) packed factor: strict lower = unit L, diagonal = D,
//            strict upper written as 0 (the Pallas kernels leave garbage);
//        W  (B, b, b) = L^{-1}, unit lower triangular (kWithW only).
//   A zero pivot divides by 1 and is left for the inertia count.
//
// What bounds it on an H100: the factorization is a chain of b dependent
// rank-1 steps, each small (at most b^2 multiply-adds per panel).  Neither
// bytes (2 or 3 x b^2 x 4 bytes per panel moved once) nor arithmetic (b^3/3
// multiply-adds per panel, b^3/2 with W) comes close to the card's limits.
// The cost is first
// the serial chain of b steps, each ending in a barrier, then the
// shared-memory traffic of the updates.  At B = 1 (the dense LDL^T's one
// panel per step) one CTA runs on one SM and the call is pure latency.
//
// What the design does about it: one CTA per panel, the panel (and W)
// resident in shared memory for the whole sweep, and the b columns taken
// in slabs [j0, e) of kSlab = 8 columns.  Each slab has three phases.
//  1. The in-slab chain, one barrier per column.  Thread i owns row i.  At
//     step j, row i > j computes l_i = a[i][j] / d_j, keeps the raw a[i][j]
//     and l_i in the slab buffers craw/lmul, and updates only its own
//     entries of the slab's later columns, a[i][c] for j < c < e, c <= i.
//     Packing a[i][j] = l_i waits for the end of the slab, so column j is
//     read-only during step j and the step needs no second barrier.
//  2. The trailing update, one pass per slab: each entry (i, c), e <= c <=
//     i, is loaded once into a register, takes the slab's 8 updates
//     x -= lmul[i][jj] * craw[c][jj] in ascending jj and is stored once (a
//     warp per row, a lane per column).  The slab's columns are packed in
//     the same pass.  With W, the slab's own rows of W take the slab's
//     updates in the same pass too (a thread per column walks the rows in
//     order); after one barrier, the rows below take them from the now
//     final slab rows.
//  3. One barrier before the next slab.
// So a panel costs about b + ceil(b/8) barriers (b + 2 ceil(b/8) with W),
// and each trailing entry goes through shared memory once per 8 columns.
// Every entry still receives exactly the rank-1 updates of the plain sweep,
// in ascending j, with the same operands; each rounds the product before
// subtracting (msub: no fused multiply-add), as the plain version does.
// Only the grouping across entries differs from the plain sweep, never the
// sequence within an entry, so kernel and plain version agree bit for bit
// and are held to that.  A fused multiply-add would be slightly more
// accurate per step; changing the rounding is allowed, but then the
// exact-equality checks change with it and the bf16-W dense flagship, whose
// outcome depends on the factors' last bit (2 of 16 one-ulp perturbations
// of these outputs stop it with status error; bf16_rounding.py), must be
// re-run.
// Rows of A are padded to an odd stride, so the row-per-thread accesses of
// phase 1 hit distinct banks; craw and lmul are stored column by column
// (index jj * b + i), so phase 1 writes and the lanes' reads of craw in
// phase 2 are consecutive, and the reads of lmul are broadcasts.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlab = 8;

__host__ __device__ inline int row_stride(int b) { return b | 1; }

// x - l * c with the product rounded before the subtraction (no fused
// multiply-add): the same two roundings as the plain PyTorch version.
__device__ inline float msub(float x, float l, float c) {
  return __fsub_rn(x, __fmul_rn(l, c));
}

template <bool kWithW>
__global__ void __launch_bounds__(kThreads)
ldl_panel_kernel(const float* __restrict__ A, float* __restrict__ LD,
                 float* __restrict__ W, int b) {
  extern __shared__ float smem[];
  const int lda = row_stride(b);
  float* a = smem;                          // b x lda, working matrix
  float* w = a + b * lda;                   // b x b, W accumulation (kWithW)
  float* craw = kWithW ? w + b * b : w;     // kSlab x b, raw slab columns
  float* lmul = craw + kSlab * b;           // kSlab x b, their multipliers

  const size_t off = static_cast<size_t>(blockIdx.x) * b * b;
  const float* src = A + off;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = warp; i < b; i += kWarps) {
    for (int c = lane; c < b; c += 32) {
      a[i * lda + c] = src[i * b + c];
      if constexpr (kWithW) w[i * b + c] = (i == c) ? 1.0f : 0.0f;
    }
  }
  __syncthreads();

  for (int j0 = 0; j0 < b; j0 += kSlab) {
    const int e = min(j0 + kSlab, b);  // only the last slab is narrower

    // 1. the in-slab chain: thread i owns row i, one barrier per column
    for (int j = j0; j < e; ++j) {
      const int i = tid;
      if (i > j && i < b) {
        const float piv = a[j * lda + j];
        const float piv_safe = fabsf(piv) > 0.0f ? piv : 1.0f;
        const float cv = a[i * lda + j];
        const float li = cv / piv_safe;
        craw[(j - j0) * b + i] = cv;
        lmul[(j - j0) * b + i] = li;
        const int last = min(e - 1, i);
        for (int c = j + 1; c <= last; ++c) {
          a[i * lda + c] = msub(a[i * lda + c], li, a[c * lda + j]);
        }
      }
      __syncthreads();
    }

    // 2. the trailing block (a full slab: e < b only when e - j0 == kSlab),
    //    a warp per row, a lane per column, the slab's updates in order
    for (int i = e + warp; i < b; i += kWarps) {
      float l[kSlab];
#pragma unroll
      for (int jj = 0; jj < kSlab; ++jj) l[jj] = lmul[jj * b + i];
      for (int c = e + lane; c <= i; c += 32) {
        float x = a[i * lda + c];
#pragma unroll
        for (int jj = 0; jj < kSlab; ++jj) x = msub(x, l[jj], craw[jj * b + c]);
        a[i * lda + c] = x;
      }
    }
    // pack the slab's columns: a[i][j] = l_i for i > j
    for (int i = j0 + 1 + tid; i < b; i += kThreads) {
      const int cols = min(e, i) - j0;
      for (int jj = 0; jj < cols; ++jj) a[i * lda + j0 + jj] = lmul[jj * b + i];
    }
    if constexpr (kWithW) {
      // the slab's own rows of W: a thread per column c walks the rows
      // i in (j0, e) in order, W[i][c] -= l_i,j W[j][c] for c <= j < i
      for (int c = tid; c < e - 1; c += kThreads) {
        for (int i = max(j0, c) + 1; i < e; ++i) {
          float x = w[i * b + c];
          for (int j = max(j0, c); j < i; ++j) x = msub(x, lmul[(j - j0) * b + i], w[j * b + c]);
          w[i * b + c] = x;
        }
      }
      __syncthreads();
      // the rows below, from the final slab rows
      for (int i = e + warp; i < b; i += kWarps) {
        float l[kSlab];
#pragma unroll
        for (int jj = 0; jj < kSlab; ++jj) l[jj] = lmul[jj * b + i];
        for (int c = lane; c < e; c += 32) {
          float x = w[i * b + c];
#pragma unroll
          for (int jj = 0; jj < kSlab; ++jj) {
            if (c <= j0 + jj) x = msub(x, l[jj], w[(j0 + jj) * b + c]);
          }
          w[i * b + c] = x;
        }
      }
    }
    // 3. before the next slab overwrites craw/lmul
    __syncthreads();
  }

  float* ld_out = LD + off;
  for (int i = warp; i < b; i += kWarps) {
    for (int c = lane; c < b; c += 32) {
      ld_out[i * b + c] = (c <= i) ? a[i * lda + c] : 0.0f;
      if constexpr (kWithW) W[off + i * b + c] = w[i * b + c];
    }
  }
}

template <bool kWithW>
size_t smem_bytes(int b) {
  const size_t bb = static_cast<size_t>(b);
  return sizeof(float) * (bb * row_stride(b) + (kWithW ? bb * bb : 0) + 2 * kSlab * bb);
}

template <bool kWithW>
int launch(const float* A, float* LD, float* W, int B, int b, void* stream) {
  if (B <= 0) return 0;
  const size_t smem = smem_bytes<kWithW>(b);
  cudaError_t err = cudaFuncSetAttribute(
      ldl_panel_kernel<kWithW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ldl_panel_kernel<kWithW><<<B, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(A, LD, W, b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch one CTA per panel on `stream`; each returns cudaGetLastError() as
// an int (0 = launched).  Neither synchronises.

// LD and W = L^{-1} of (B, b, b) panels (K1 and K3).
int ldl_panel_winv_f32(const float* A, float* LD, float* W, int B, int b,
                       void* stream) {
  return launch<true>(A, LD, W, B, b, stream);
}

// LD only (K2, K4 and K5).
int ldl_panel_f32(const float* A, float* LD, int B, int b, void* stream) {
  return launch<false>(A, LD, nullptr, B, b, stream);
}

}  // extern "C"
