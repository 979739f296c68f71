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
// on the lower triangle is the same, and this kernel computes it column by
// column for every entry.  Nothing here needs b % 8 == 0: indexing is by b,
// and rows are padded to an odd stride whatever b is.
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
// rank-1 steps, each small (at most b^2 multiply-adds per panel).  It is
// latency-bound — neither bytes (2 or 3 x b^2 x 4 bytes per panel moved
// once) nor FLOPs (b^3/3 per panel, b^3 with W) come close to the card's
// limits; the cost is the per-step barrier plus the shared-memory round trip
// of each step.  At B = 1 (the dense LDL^T's one panel per step) one CTA
// runs on one SM and the call is pure latency.
//
// What the design does about it: one CTA per panel, with the panel (and W)
// resident in shared memory for the whole sweep, so the chain never touches
// device memory between steps and each step costs two __syncthreads.  Step
// j: (1) the b-j-1 pivot-column entries and their multipliers l = col / d_j
// go to two small shared vectors; (2) one pass over rows i > j applies, per
// element (i, c), the trailing rank-1 update A[i][c] -= l_i * col_c for
// j < c <= i, packs A[i][j] = l_i, and (kWithW) accumulates
// W[i][c] -= l_i * W[j][c] for c <= j (row j of W is final at step j).  The
// no-W pass walks only columns c >= j.  Each update rounds the product
// before subtracting, as the plain version does, so kernel and plain version
// agree bit for bit and are held to that.  A fused multiply-add would be
// slightly more accurate per step; changing the rounding is allowed, but
// then the exact-equality checks change with it and the bf16-W dense
// flagship, whose outcome depends on the factors' last bit (2 of 16
// one-ulp perturbations of these outputs stop it with status error;
// bf16_rounding.py), must be re-run.
// Rows of A are padded to an odd stride so the column reads of phase (1) hit
// distinct banks.  This is the simple, right first version: the
// slab/recursive blocking, wgmma trailing updates and several small panels
// per CTA are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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
  float* ccol = kWithW ? w + b * b : w;     // raw pivot column (rows > j)
  float* lcol = ccol + b;                   // multipliers l (rows > j)

  const size_t off = static_cast<size_t>(blockIdx.x) * b * b;
  const float* src = A + off;
  const int tid = threadIdx.x;
  const int nn = b * b;

  for (int idx = tid; idx < nn; idx += blockDim.x) {
    const int i = idx / b;
    const int c = idx - i * b;
    a[i * lda + c] = src[idx];
    if constexpr (kWithW) w[idx] = (i == c) ? 1.0f : 0.0f;
  }
  __syncthreads();

  for (int j = 0; j < b; ++j) {
    const float piv = a[j * lda + j];
    const float piv_safe = fabsf(piv) > 0.0f ? piv : 1.0f;
    for (int i = j + 1 + tid; i < b; i += blockDim.x) {
      const float cv = a[i * lda + j];
      ccol[i] = cv;
      lcol[i] = cv / piv_safe;
    }
    __syncthreads();
    const int rows = b - j - 1;
    if constexpr (kWithW) {
      const int work = rows * b;
      for (int idx = tid; idx < work; idx += blockDim.x) {
        const int r = idx / b;
        const int c = idx - r * b;
        const int i = j + 1 + r;
        const float li = lcol[i];
        if (c > j) {
          if (c <= i) a[i * lda + c] = msub(a[i * lda + c], li, ccol[c]);
        } else {
          if (c == j) a[i * lda + j] = li;
          w[i * b + c] = msub(w[i * b + c], li, w[j * b + c]);
        }
      }
    } else {
      const int width = b - j;  // columns j .. b-1
      const int work = rows * width;
      for (int idx = tid; idx < work; idx += blockDim.x) {
        const int r = idx / width;
        const int c = j + (idx - r * width);
        const int i = j + 1 + r;
        const float li = lcol[i];
        if (c == j) {
          a[i * lda + j] = li;
        } else if (c <= i) {
          a[i * lda + c] = msub(a[i * lda + c], li, ccol[c]);
        }
      }
    }
    __syncthreads();
  }

  float* ld_out = LD + off;
  for (int idx = tid; idx < nn; idx += blockDim.x) {
    const int i = idx / b;
    const int c = idx - i * b;
    ld_out[idx] = (c <= i) ? a[i * lda + c] : 0.0f;
    if constexpr (kWithW) W[off + idx] = w[idx];
  }
}

template <bool kWithW>
size_t smem_bytes(int b) {
  const size_t bb = static_cast<size_t>(b);
  return sizeof(float) * (bb * row_stride(b) + (kWithW ? bb * bb : 0) + 2 * bb);
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
