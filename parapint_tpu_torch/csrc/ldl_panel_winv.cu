// Batched unpivoted LDL^T of symmetric f32 panels, plus W = L^{-1}.
//
// Replaces the TPU kernel parapint_tpu/ops/pallas_ldl.py::_make_slab_kernel
// (with_w=True), entry ldl_panels_slab_winv.  Contract, identical to the
// Pallas kernel's:
//   in   A  (B, b, b) f32, row-major, symmetric up to roundoff; only the
//            LOWER triangle is read (the factor follows the true pivot
//            column, never row j of the trailing block);
//   out  LD (B, b, b) packed factor: strict lower = unit L, diagonal = D,
//            strict upper written as 0;
//        W  (B, b, b) = L^{-1}, unit lower triangular.
//   A zero pivot divides by 1 and is left for the inertia count.
//
// What bounds it on an H100: the factorization is a chain of b dependent
// rank-1 steps, each small (at most b^2 multiply-adds per panel).  It is
// latency-bound — neither bytes (2 x b^2 x 4 bytes per panel moved once) nor
// FLOPs (b^3/3 per panel) come close to the card's limits; the cost is the
// per-step barrier plus the shared-memory round trip of each step.
//
// What the design does about it: one CTA per panel, with the panel and its
// W resident in shared memory for the whole sweep, so the chain never
// touches device memory between steps and each step costs two
// __syncthreads.  Step j: (1) the b-j-1 pivot-column entries and their
// multipliers l = col / d_j go to two small shared vectors; (2) one pass over
// rows i > j applies, per element (i, c), the trailing rank-1 update
// A[i][c] -= l_i * col_c for j < c <= i, packs A[i][j] = l_i, and
// accumulates W[i][c] -= l_i * W[j][c] for c <= j (row j of W is final at
// step j).  Rows of A are padded by one float so the column reads of phase
// (1) hit distinct banks.  This is the simple, right first version: the
// slab/recursive blocking, wgmma trailing updates and several small panels
// per CTA are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
ldl_panel_winv_kernel(const float* __restrict__ A, float* __restrict__ LD,
                      float* __restrict__ W, int b) {
  extern __shared__ float smem[];
  const int lda = b + 1;
  float* a = smem;                 // b x lda, working matrix
  float* w = a + b * lda;          // b x b, W accumulation
  float* ccol = w + b * b;         // raw pivot column (rows > j)
  float* lcol = ccol + b;          // multipliers l (rows > j)

  const size_t off = static_cast<size_t>(blockIdx.x) * b * b;
  const float* src = A + off;
  const int tid = threadIdx.x;
  const int nn = b * b;

  for (int idx = tid; idx < nn; idx += blockDim.x) {
    const int i = idx / b;
    const int c = idx - i * b;
    a[i * lda + c] = src[idx];
    w[idx] = (i == c) ? 1.0f : 0.0f;
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
    const int work = rows * b;
    for (int idx = tid; idx < work; idx += blockDim.x) {
      const int r = idx / b;
      const int c = idx - r * b;
      const int i = j + 1 + r;
      const float li = lcol[i];
      if (c > j) {
        if (c <= i) a[i * lda + c] -= li * ccol[c];
      } else {
        if (c == j) a[i * lda + j] = li;
        w[i * b + c] -= li * w[j * b + c];
      }
    }
    __syncthreads();
  }

  float* ld_out = LD + off;
  float* w_out = W + off;
  for (int idx = tid; idx < nn; idx += blockDim.x) {
    const int i = idx / b;
    const int c = idx - i * b;
    ld_out[idx] = (c <= i) ? a[i * lda + c] : 0.0f;
    w_out[idx] = w[idx];
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA needs at panel size b.
size_t ldl_panel_winv_smem_bytes(int b) {
  return sizeof(float) * (static_cast<size_t>(b) * (b + 1) +
                          static_cast<size_t>(b) * b + 2 * static_cast<size_t>(b));
}

// Launches one CTA per panel on `stream`; returns cudaGetLastError() as an
// int (0 = launched).  Does not synchronise.
int ldl_panel_winv_f32(const float* A, float* LD, float* W, int B, int b,
                       void* stream) {
  if (B <= 0) return 0;
  const size_t smem = ldl_panel_winv_smem_bytes(b);
  cudaError_t err = cudaFuncSetAttribute(
      ldl_panel_winv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ldl_panel_winv_kernel<<<B, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(A, LD, W, b);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
