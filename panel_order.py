"""How the port's iteration counts depend on the summation order of the
float32 block-panel factorization (ROADMAP C13/C14), on one CUDA card.

    python3 panel_order.py [CONFIG ...] [--variants kernel,jax,dot,wrec,f64]
                           [--device cpu]

For each configuration of ``chip_smoke.PARITY`` (default: all five) and
each variant below, the fused solve from the initial point and from its
one-ulp perturbations (``chip_smoke._ensemble``: the points of the JAX
package's CPU ensemble), each optimal at the JAX objective; the counts are
printed beside the JAX package's with ``chip_smoke.sign_test`` (the lean
test of ``tests/test_torch_parity.py::verdict``).

A variant replaces the float32 panels of the batched factorizations
(``ops/ldl.py``'s ``_panel_factor_batch_winv`` and ``_panel_factor_batch``:
the block factors, cyclic reduction and PCG's blocks; the dense SC's
single panels keep K5, whose order is the JAX package's CPU one already)
for one run, without changing any module of the port:

  kernel  the port as shipped: K1, each of a slab's 8 rank-1 products
          rounded and subtracted on its own, W = L^-1 by the rank-1
          recurrence W[j+1:] -= l (x) W[j] (its plain version's order);
  jax     the JAX package's CPU order (``parapint_tpu/ops/ldl.py``
          ``_ldl_slab_batched_xla``: rank-1 steps inside each 8-column
          slab, then one rank-8 product for the trailing update; W by the
          halving recursion ``_unit_lower_inv_b``);
  dot     that slab LDL^T with the port's W recurrence;
  wrec    the port's LDL^T (K2) with the halving recursion for W;
  f64     the plain sweep in float64, rounded to float32: the float32
          factors nearest to the exact ones.

Everything goes to standard output; exits non-zero without CUDA unless
``--device cpu`` is given (the same ensembles on the CPU: the panels'
plain versions in place of the kernels; a 256-block solve takes minutes).
"""

import argparse
import contextlib
import json
import sys
import time

import torch

import chip_smoke as cs

VARIANTS = ("kernel", "jax", "dot", "wrec", "f64")


def slab_dot(A, r=8):
    """Packed LDL^T of (N, b, b) panels (b % r == 0) in the order of the
    JAX package's ``_ldl_slab_batched_xla``: per slab of r columns, r
    rank-1 steps on the slab's columns only, then one rank-r product for
    the trailing columns.  Only the lower triangle is returned (the strict
    upper is 0)."""
    N, b, _ = A.shape
    M = A.clone()
    rows = torch.arange(b, device=A.device)[None, :, None]
    lane = torch.arange(r, device=A.device)[None, None, :]
    zero = torch.zeros((), dtype=A.dtype, device=A.device)
    for j0 in range(0, b, r):
        S = M[:, :, j0 : j0 + r].clone()
        X = torch.zeros_like(S)  # the raw columns, masked below their pivots
        for jj in range(r):
            j = j0 + jj
            col = S[:, :, jj : jj + 1]
            piv = col[:, j : j + 1, :]
            piv_safe = torch.where(piv.abs() > 0, piv, torch.ones_like(piv))
            below = rows > j
            l = torch.where(below, col / piv_safe, zero)
            raw = torch.where(below, col, zero)
            X = torch.where(lane == jj, raw, X)
            xs = torch.where(lane > jj, raw[:, j0 : j0 + r, :].transpose(1, 2), zero)
            S = torch.where(lane == jj, torch.where(below, l, col), S - l * xs)
        M[:, :, j0 : j0 + r] = S
        L = torch.where(rows > j0 + lane, S, zero)
        M = M - torch.bmm(L, torch.where(rows >= j0 + r, X, zero).transpose(1, 2))
    return torch.tril(M)


def w_recurrence(F):
    """W = L^-1 of packed factors (N, b, b) by the port's recurrence
    W[j+1:, :j+1] -= l (x) W[j, :j+1] (bitwise the panel kernel's W for the
    kernel's own L)."""
    N, b, _ = F.shape
    W = torch.eye(b, dtype=F.dtype, device=F.device).expand(N, b, b).clone()
    for j in range(b):
        W[:, j + 1 :, : j + 1] -= F[:, j + 1 :, j, None] * W[:, None, j, : j + 1]
    return W


def w_recursion(F):
    """W = L^-1 of packed factors by the halving recursion (the JAX
    package's ``_unit_lower_inv_b``, the port's ``unit_lower_inv``)."""
    from parapint_tpu_torch.ops.ldl import unit_lower_inv

    eye = torch.eye(F.shape[-1], dtype=F.dtype, device=F.device)
    return unit_lower_inv(torch.tril(F, -1) + eye)


def rank1(A):
    """The port's LDL^T without W: K2 on the card, its plain version on the CPU."""
    from parapint_tpu_torch.ops import ldl_panel

    return ldl_panel.ldl_panels_slab(A) if A.is_cuda else ldl_panel.ldl_panels_plain(A)


def accurate(A):
    """(LD, W) of the plain sweep in float64, rounded to float32."""
    from parapint_tpu_torch.ops.ldl_panel import ldl_panels_slab_winv_plain

    return tuple(t.float() for t in ldl_panels_slab_winv_plain(A.double()))


PANELS = {
    "jax": lambda A: (lambda F: (F, w_recursion(F)))(slab_dot(A)),
    "dot": lambda A: (lambda F: (F, w_recurrence(F)))(slab_dot(A)),
    "wrec": lambda A: (lambda F: (F, w_recursion(F)))(rank1(A)),
    "f64": accurate,
}


@contextlib.contextmanager
def panel_order(variant):
    """The port's batched float32 panel factorizations in ``variant``'s
    order while the block runs ("kernel": unchanged)."""
    from parapint_tpu_torch.ops import ldl

    saved = ldl._panel_factor_batch_winv, ldl._panel_factor_batch
    if variant != "kernel":
        panels = PANELS[variant]

        def ours(A):
            return A.dtype == torch.float32 and A.shape[-1] % 8 == 0

        def batch_winv(A, slab_algo):
            return panels(A.contiguous()) if ours(A) else saved[0](A, slab_algo)

        def batch(A, slab_algo):
            return panels(A.contiguous())[0] if ours(A) else saved[1](A, slab_algo)

        ldl._panel_factor_batch_winv, ldl._panel_factor_batch = batch_winv, batch
    try:
        yield
    finally:
        ldl._panel_factor_batch_winv, ldl._panel_factor_batch = saved


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("configs", nargs="*", metavar="CONFIG", help=f"of {sorted(cs.PARITY)}")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    configs = args.configs or list(cs.PARITY)
    variants = args.variants.split(",")
    unknown = sorted(set(configs) - set(cs.PARITY)) + sorted(set(variants) - set(VARIANTS))
    if unknown:
        ap.error(f"unknown configurations or variants {unknown}")
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("panel_order: CUDA is not available", file=sys.stderr)
            sys.exit(1)
        torch.backends.cuda.matmul.allow_tf32 = False
        cs.phase_device()
        cs.phase_build()
    else:
        cs.SMI = "cpu"
    out = {}
    for name in configs:
        n, ref, jax_counts = cs.PARITY[name][:3]
        iface, solver = cs._parity_config(name, args.device)
        for variant in variants:
            t0 = time.perf_counter()
            try:
                with panel_order(variant):
                    counts, _ = cs._ensemble(iface, solver, f"{name} {variant}", n, ref)
            except AssertionError as e:  # a solve not optimal at the JAX objective
                out[f"{name} {variant}"] = dict(error=str(e))
                cs.say(f"{name} {variant}: {e}")
                continue
            up, down, p = cs.sign_test(jax_counts, counts)
            out[f"{name} {variant}"] = dict(counts=counts, sign_test=[up, down, p])
            cs.say(f"{name} {variant}: counts {counts} (JAX CPU {jax_counts}); {args.device} "
                   f"{cs._distribution(counts)}, JAX {cs._distribution(jax_counts)}; against JAX "
                   f"point by point {up} above, {down} below, sign test p {p:.4f}; "
                   f"{time.perf_counter() - t0:.1f} s")
        del iface, solver
        if args.device == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps({"panel_order": out}))


if __name__ == "__main__":
    main()
