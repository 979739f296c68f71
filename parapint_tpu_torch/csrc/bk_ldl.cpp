// Host-side symmetric indefinite LDL^T factorization (Bunch-Kaufman
// partial pivoting, 1x1 and 2x2 pivots) with inertia extraction.
//
// This fills the role HSL MA27 plays for the reference parapint
// (parapint/linalg/ma27_interface.py): a robust *pivoted* factorization of
// symmetric indefinite KKT systems with an inertia readout, used as (a) the
// host execution path, and (b) the correctness oracle for the unpivoted
// panel kernels (parapint_tpu_torch/ops/ldl.py).  The batched entry point
// factors independent blocks in parallel with OpenMP, mirroring the
// reference's per-rank distribution of diagonal blocks.  The source is the
// JAX package's parapint_tpu/native/bk_ldl.cpp, kept here so that the port
// builds its own copy.
//
// Storage: dense column-major n x n.  On exit the lower triangle holds the
// unit-lower factor L and the (block) diagonal D; ipiv follows the LAPACK
// dsytrf convention for the lower-triangle variant:
//   ipiv[k] > 0  : 1x1 pivot, rows/cols k and ipiv[k]-1 were swapped
//   ipiv[k] = ipiv[k+1] < 0 : 2x2 pivot in rows/cols k, k+1; rows k+1 and
//                             -ipiv[k]-1 were swapped
//
// Build (ops/cuda_build.py, at first use): g++ -O3 -fopenmp -shared -fPIC

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

const double kAlpha = (1.0 + std::sqrt(17.0)) / 8.0;  // BK pivot constant

inline double& at(double* A, int lda, int i, int j) { return A[j * lda + i]; }

void swap_sym(double* A, int lda, int n, int p, int q) {
  // symmetric swap of rows/cols p < q, touching only the lower triangle
  if (p == q) return;
  std::swap(at(A, lda, p, p), at(A, lda, q, q));
  for (int i = 0; i < p; ++i) std::swap(at(A, lda, p, i), at(A, lda, q, i));
  for (int i = p + 1; i < q; ++i) std::swap(at(A, lda, i, p), at(A, lda, q, i));
  for (int i = q + 1; i < n; ++i) std::swap(at(A, lda, i, p), at(A, lda, i, q));
}

}  // namespace

extern "C" {

// returns 0 on success, k+1 if a zero pivot was met at column k
int bk_factor(double* A, int n, int lda, int* ipiv) {
  int k = 0;
  while (k < n) {
    // --- pivot selection (Bunch-Kaufman partial pivoting) ---
    double akk = std::fabs(at(A, lda, k, k));
    // lambda = max |A[i,k]| for i > k, r = argmax
    double lambda = 0.0;
    int r = k;
    for (int i = k + 1; i < n; ++i) {
      double v = std::fabs(at(A, lda, i, k));
      if (v > lambda) { lambda = v; r = i; }
    }
    int pivot_size = 1;
    if (lambda > 0.0 && akk < kAlpha * lambda) {
      // sigma = max |A[i,r]| over column/row r excluding (r,r)
      double sigma = 0.0;
      for (int i = k; i < n; ++i) {
        if (i == r) continue;
        double v = (i < r) ? std::fabs(at(A, lda, r, i)) : std::fabs(at(A, lda, i, r));
        if (v > sigma) sigma = v;
      }
      double arr = std::fabs(at(A, lda, r, r));
      if (akk * sigma >= kAlpha * lambda * lambda) {
        pivot_size = 1;                       // keep (k,k)
      } else if (arr >= kAlpha * sigma) {
        swap_sym(A, lda, n, k, r);            // bring (r,r) to (k,k)
        ipiv[k] = r + 1;
        pivot_size = 1;
      } else {
        if (r != k + 1) swap_sym(A, lda, n, k + 1, r);  // 2x2 pivot (k, k+1)
        ipiv[k] = -(r + 1);
        ipiv[k + 1] = -(r + 1);
        pivot_size = 2;
      }
    }
    if (pivot_size == 1 && ipiv[k] == 0) ipiv[k] = k + 1;

    if (pivot_size == 1) {
      double d = at(A, lda, k, k);
      if (d == 0.0) return k + 1;
      double inv = 1.0 / d;
      for (int i = k + 1; i < n; ++i) at(A, lda, i, k) *= inv;
      // trailing update: A[i,j] -= L[i,k] * d * L[j,k]
      for (int j = k + 1; j < n; ++j) {
        double ljk_d = at(A, lda, j, k) * d;
        if (ljk_d != 0.0) {
          double* col = &at(A, lda, 0, j);
          const double* lk = &at(A, lda, 0, k);
          for (int i = j; i < n; ++i) col[i] -= lk[i] * ljk_d;
        }
      }
    } else {
      // 2x2 pivot D = [a b; b c]
      double a = at(A, lda, k, k);
      double b = at(A, lda, k + 1, k);
      double c = at(A, lda, k + 1, k + 1);
      double det = a * c - b * b;
      if (det == 0.0) return k + 1;
      double inv_det = 1.0 / det;
      for (int i = k + 2; i < n; ++i) {
        double x = at(A, lda, i, k);
        double y = at(A, lda, i, k + 1);
        at(A, lda, i, k) = (c * x - b * y) * inv_det;
        at(A, lda, i, k + 1) = (a * y - b * x) * inv_det;
      }
      for (int j = k + 2; j < n; ++j) {
        double l1 = at(A, lda, j, k), l2 = at(A, lda, j, k + 1);
        double w1 = a * l1 + b * l2, w2 = b * l1 + c * l2;
        if (w1 != 0.0 || w2 != 0.0) {
          double* col = &at(A, lda, 0, j);
          const double* lk1 = &at(A, lda, 0, k);
          const double* lk2 = &at(A, lda, 0, k + 1);
          for (int i = j; i < n; ++i) col[i] -= lk1[i] * w1 + lk2[i] * w2;
        }
      }
    }
    k += pivot_size;
  }
  return 0;
}

// inertia from the factored (block) diagonal; the columns that a failed
// factorization never reached (ipiv 0, as bk_factor_batched leaves them)
// count as zero pivots.  (The JAX package's copy of this routine reads them
// as 2x2 blocks, past the end of the matrix at the last column.)
void bk_inertia(const double* A, int n, int lda, const int* ipiv,
                int* num_pos, int* num_neg, int* num_zero) {
  int pos = 0, neg = 0, zero = 0;
  int k = 0;
  while (k < n) {
    if (ipiv[k] == 0) {
      ++zero;
      ++k;
    } else if (ipiv[k] > 0) {
      double d = A[k * lda + k];
      if (d > 0) ++pos; else if (d < 0) ++neg; else ++zero;
      ++k;
    } else {
      // 2x2 block: eigenvalues of [a b; b c]; BK 2x2 pivots are always
      // indefinite (one +, one -) when det < 0, which the selection rule
      // guarantees; compute exactly anyway.
      double a = A[k * lda + k];
      double b = A[k * lda + k + 1];
      double c = A[(k + 1) * lda + k + 1];
      double tr = a + c, det = a * c - b * b;
      if (det < 0) { ++pos; ++neg; }
      else if (det > 0) { if (tr > 0) pos += 2; else neg += 2; }
      else { ++zero; if (tr > 0) ++pos; else if (tr < 0) ++neg; else ++zero; }
      k += 2;
    }
  }
  *num_pos = pos; *num_neg = neg; *num_zero = zero;
}

// solve with the factorization: x overwrites b (nrhs columns, ldb leading dim)
void bk_solve(const double* A, int n, int lda, const int* ipiv,
              double* B, int nrhs, int ldb) {
  // pivot-block start indices, shared by all right-hand sides
  int* starts = new int[n];
  int nblocks = 0;
  {
    int k = 0;
    while (k < n) {
      starts[nblocks++] = k;
      k += (ipiv[k] > 0) ? 1 : 2;
    }
  }
  for (int rhs = 0; rhs < nrhs; ++rhs) {
    double* b = B + rhs * ldb;
    // NOTE: unlike LAPACK's dsytrf, bk_factor applies FULL symmetric
    // row/column interchanges (including already-factored columns), so
    // P A P^T = L D L^T exactly, with P the swaps applied in ascending
    // order.  The solve is therefore x = P^T L^{-T} D^{-1} L^{-1} P b with
    // the permutation applied entirely up front and undone at the end.
    int k = 0;
    while (k < n) {
      if (ipiv[k] > 0) {
        int p = ipiv[k] - 1;
        if (p != k) std::swap(b[k], b[p]);
        ++k;
      } else {
        int p = -ipiv[k] - 1;
        if (p != k + 1) std::swap(b[k + 1], b[p]);
        k += 2;
      }
    }
    // forward: L^{-1}
    k = 0;
    while (k < n) {
      if (ipiv[k] > 0) {
        double bk = b[k];
        for (int i = k + 1; i < n; ++i) b[i] -= A[k * lda + i] * bk;
        ++k;
      } else {
        double bk = b[k], bk1 = b[k + 1];
        for (int i = k + 2; i < n; ++i)
          b[i] -= A[k * lda + i] * bk + A[(k + 1) * lda + i] * bk1;
        k += 2;
      }
    }
    // diagonal solve
    k = 0;
    while (k < n) {
      if (ipiv[k] > 0) {
        b[k] /= A[k * lda + k];
        ++k;
      } else {
        double a = A[k * lda + k];
        double bb = A[k * lda + k + 1];
        double c = A[(k + 1) * lda + k + 1];
        double det = a * c - bb * bb;
        double x = b[k], y = b[k + 1];
        b[k] = (c * x - bb * y) / det;
        b[k + 1] = (a * y - bb * x) / det;
        k += 2;
      }
    }
    // backward: L^{-T}, walking pivot blocks in reverse
    for (int bi = nblocks - 1; bi >= 0; --bi) {
      k = starts[bi];
      if (ipiv[k] > 0) {
        double s = 0.0;
        for (int i = k + 1; i < n; ++i) s += A[k * lda + i] * b[i];
        b[k] -= s;
      } else {
        double s0 = 0.0, s1 = 0.0;
        for (int i = k + 2; i < n; ++i) {
          s0 += A[k * lda + i] * b[i];
          s1 += A[(k + 1) * lda + i] * b[i];
        }
        b[k] -= s0;
        b[k + 1] -= s1;
      }
    }
    // undo the permutation (descending)
    for (int bi = nblocks - 1; bi >= 0; --bi) {
      k = starts[bi];
      if (ipiv[k] > 0) {
        int p = ipiv[k] - 1;
        if (p != k) std::swap(b[k], b[p]);
      } else {
        int p = -ipiv[k] - 1;
        if (p != k + 1) std::swap(b[k + 1], b[p]);
      }
    }
  }
  delete[] starts;
}

// batched: factor nb independent blocks in parallel (OpenMP)
void bk_factor_batched(double* A, int nb, int n, int* ipiv, int* infos) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(dynamic)
#endif
  for (int b = 0; b < nb; ++b) {
    std::memset(ipiv + (int64_t)b * n, 0, sizeof(int) * n);
    infos[b] = bk_factor(A + (int64_t)b * n * n, n, n, ipiv + (int64_t)b * n);
  }
}

void bk_solve_batched(const double* A, int nb, int n, const int* ipiv,
                      double* B, int nrhs) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(dynamic)
#endif
  for (int b = 0; b < nb; ++b) {
    bk_solve(A + (int64_t)b * n * n, n, n, ipiv + (int64_t)b * n,
             B + (int64_t)b * n * nrhs, nrhs, n);
  }
}

void bk_inertia_batched(const double* A, int nb, int n, const int* ipiv,
                        int* pos, int* neg, int* zero) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (int b = 0; b < nb; ++b) {
    bk_inertia(A + (int64_t)b * n * n, n, n, ipiv + (int64_t)b * n,
               pos + b, neg + b, zero + b);
  }
}

}  // extern "C"
