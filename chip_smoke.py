"""Smoke run of the PyTorch port on one CUDA card: build the kernels, hold
each against its plain version, and drive the port's public entry points:
the Burgers flagship (nfe_x=50, nfe_t=256, 64 blocks) on the dense block
path, its solver variants and the banded path; the two-stage stochastic QP
at the JAX package's ``stochastic_qp_32scenarios_1k`` size; the farmer; and
the single-NLP examples through ``ip_solve``.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's exception is caught):

1. device          — require CUDA; print the card's name and power limit,
                     the torch/CUDA versions and ``nvcc --version``.
2. build           — compile ``parapint_tpu_torch/csrc/*.cu`` (one nvcc per
                     source, the three started together) into
                     ``parapint_tpu_torch/_build``.
3. kernels         — every kernel entry (K1 ``ldl_panels_slab_winv``, K2
                     ``ldl_panels_slab``, K3 ``ldl_panels_batched_winv``, K4
                     ``ldl_panels_batched``, K5 ``ldl_panels``, K6
                     ``winv_apply_fused``) vs its plain version on the card at
                     the paths' shapes plus edge cases; time kernel, plain
                     version and (K6) the two-matmul form.
3b. kernel lab     — K7 ``read_reduce`` (the read-only streaming probe) bit
                     for bit equal to its plain version at (64,1024,1024),
                     (3,8,8) and (5,56,56) for 16, 64 and 256 rows per CTA;
                     then, every count zeroed, the kernel lab's ``bw``,
                     ``solve``, ``mxu`` and ``dispatch`` in-process at their
                     default shapes: K7 launches > 0, and the matmul
                     precision policy restored afterwards.
4. dense flagship  — dense block form, float32 KKT, ``SchurComplementSolver``
                     in W form with cyclic-reduction coupling (the JAX
                     package's ``burgers_64blocks_cr``), tol 1e-8, through
                     ``make_fused_ip_solve``: status optimal, the JAX
                     objective, K1 launches == 14 x numerics, K6 launches ==
                     2 x back solves.
5. dense SC        — the same with the dense ``DenseLDLSolver`` coupling:
                     K5 launches == 25 x numerics.
6. bf16 W          — W stored in bf16, adaptive refinement with the
                     auto-gate: optimal, bf16 K6 launches > 0.
7. LD mode         — the first-iteration KKT through the packed-LDL^T
                     ``SchurComplementSolver(block_size=128)`` on the card
                     and on a CPU copy: inertia equal, solutions close, K2 ==
                     8 and K5 == 25 launches.
8. column          — ``PT_PANEL_ALGO=column`` (restored afterwards): the
                     dense flagship with K3 == 14 x numerics, K1 == 0, and
                     the slab run's iterations and objective bit for bit;
                     the LD-mode first KKT with K4 == 8, K2 == 0 and the slab
                     run's LD bit for bit.  Then, under the default algorithm,
                     one ``SchurComplementSolver(block_size=100)`` W-form
                     numeric of the first KKT: K3 at width 100 (10 x per
                     numeric), inertia equal to a CPU copy's.
9. stochastic QP   — 32 scenarios x (n=768, me=192, n_first=64), float32
                     KKT, the hybrid ``SchurComplementSolver`` (float64 pivot
                     sweep, float32 W, adaptive refinement), tol 1e-8: one
                     warm and one timed ``make_fused_ip_solve`` solve and one
                     ``ip_solve``, each optimal with the JAX objective and
                     iterations within 1 of JAX's; the timed solve repeats the
                     warm one bit for bit; K6 == 2 x back solves, K5 ==
                     numerics (the 64-wide Schur complement).
10. farmer         — ``examples/stochastic.main()`` (170/80/250 acres) and the
                     32-scenario farmer family through the fused driver, its
                     timed solve bit for bit equal to the counted one.
11. single NLP     — ``examples/interior_point.main()`` (x = (0, 1)) and
                     ``examples/dynamics.main()`` (the golden p(t)).
12. banded flagship — the banded block form, ``BandedSchurComplementSolver``
                     (the bench flagship): optimal, K1 launches == 22 x numerics.

Every measurement line carries the card's name and power limit; kernel
times are medians of CUDA-event windows (``tools/kernel_lab.py::timed_loop``).
The lines before the last give each bytes-bound kernel's time against K7's
measured read rate and list each kernel with launches, error, times and
bound; the last line of standard output is the JSON result.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from parapint_tpu_torch.tools.kernel_lab import PEAK_BYTES, bound, card_line, timed_loop

# JAX package's objective for the flagship, banded path on the CPU:
#   JAX_PLATFORMS=cpu python - <<'EOF'
#   import jax.numpy as jnp, parapint_tpu as pt
#   from parapint_tpu.examples import burgers
#   spec = burgers.build_spec(nfe_x=50, nfe_t=256, num_time_blocks=64)
#   iface = pt.DynamicSchurComplementInteriorPointInterface(
#       spec, kkt_dtype=jnp.float32, block_form="banded")
#   opts = pt.IPOptions(); opts.tol = 1e-8
#   opts.linalg.solver = pt.BandedSchurComplementSolver(
#       tile_size=128, schur_complement_solver=pt.BlockTridiagSolver(ns=iface.ns))
#   status, res = pt.ip_solve_fused(iface, opts)
#   print(status, int(res.iterations), repr(float(iface.evaluate_objective())))
#   EOF
# -> InteriorPointStatus.optimal 6 0.04755768812300182
# The same NLP has the same optimum whatever the linear algebra, so every
# phase holds its objective against this value.  The JAX dense path
# (bench.py with PT_BENCH_BLOCK=dense: the script above with the default
# block form and
#   pt.SchurComplementSolver(block_size=128, explicit_inverse=True,
#       factor_dtype=jnp.float32, refine_steps=0,
#       schur_complement_solver=pt.BlockTridiagSolver())
# ) -> InteriorPointStatus.optimal 7 0.04755768812300328
JAX_OBJECTIVE = 0.04755768812300182
JAX_ITERATIONS = 6
JAX_DENSE_ITERATIONS = 7
OBJ_REL_GAP = 1e-6
FLAGSHIP = dict(nfe_x=50, nfe_t=256, num_time_blocks=64)
TILE_SIZE = 128
TOL = 1e-8
BANDED_PANELS_PER_NUMERIC = 22  # 8 tiles x 2 panels (Thomas) + 6 CR levels
DENSE_K1_PER_NUMERIC = 14  # 8 block panels (1024 = 8 x 128) + 6 CR levels
SC_PANELS_PER_NUMERIC = 25  # dense SC: 3087 -> 3200 = 25 x 128
LD_K2_PER_NUMERIC = 8
W100_K3_PER_NUMERIC = 10  # block_size=100: nk 922 -> 1000 = 10 x 100
W100_K1_PER_NUMERIC = 6  # the CR levels' 56-wide tiles stay on K1

# JAX package's results for the stochastic families on the CPU (the QP at
# bench_all's stochastic_qp_32scenarios_1k size, its farmer family
# stochastic_32), with JAX_PLATFORMS=cpu:
#   import jax.numpy as jnp, parapint_tpu as pt, bench_all
#   from parapint_tpu.utils.timer import HierarchicalTimer
#   def run(iface, solver, fused):
#       opts = pt.IPOptions(); opts.tol = 1e-8; opts.linalg.solver = solver
#       if fused:
#           status, res = pt.ip_solve_fused(iface, opts); n = int(res.iterations)
#       else:
#           timer = HierarchicalTimer(); status = pt.ip_solve(iface, opts, timer=timer)
#           n = timer._root.children["IP solve"].children["convergence check"].count
#       print(status, n, repr(float(iface.evaluate_objective())))
#   hybrid = lambda: pt.SchurComplementSolver(block_size=128, explicit_inverse=True,
#                                             factor_dtype=jnp.float64, apply_dtype=jnp.float32)
#   run(bench_all.stochastic_qp(), hybrid(), True)   # -> optimal 18 61.205618968982115
#   run(bench_all.stochastic_qp(), hybrid(), False)  # -> optimal 18 61.20561896896718
#   # the farmer family with the default tol:
#   #   pt.ip_solve_fused(bench_all.stochastic_32(), opts) with
#   #   pt.SchurComplementSolver(block_size=64, explicit_inverse=True)
#   #   -> optimal 63 -109642.32191097125
# ``ip_solve`` iterations are counted as its convergence checks.
QP = dict(n_scenarios=32, n=768, me=192, n_first=64)
QP_JAX_OBJECTIVE = 61.205618968982115
QP_JAX_ITERATIONS = 18
QP_JAX_IP_ITERATIONS = 18
FARMER32_JAX_OBJECTIVE = -109642.32191097125
FARMER32_JAX_ITERATIONS = 63
FARMER_ACRES = (170.0, 80.0, 250.0)  # reference golden, tests/test_examples.py
FARMER_ATOL = 1e-4
# reference golden p(t), tests/test_examples.py:10-21
DYNAMICS_GOLDEN_P = (1.6046242850486279, 2.0, 1.4792062911745605, 0.5082444341496647,
                     -0.009859487375413882, 0.40043954978583834, 1.3619861771562247,
                     1.99059057528143, 1.7102013685364827)

# Panel kernels: kernel and plain version run the same float32 operations in
# the same order per entry (each product rounded before its subtraction, no
# fused multiply-add, IEEE division), so the lower triangle of LD and W must
# be bitwise equal; inertia then is too.  A kernel that reorders or fuses
# that arithmetic must change this check together with it (ROADMAP C5).
# K6: kernel and plain version sum n products twice in float32 in different
# orders.  Rounding errors of such sums grow as a random walk, so each entry
# of either result lies within about sqrt(n) eps_f32 of the exact value,
# relative to the same computation on absolute values (|ref|); the two are
# held to K6_TOL of that unit per entry.  On the CPU, float32 against float64
# at this script's K6 shapes reached at most 0.15 unit, while an f32 W read
# as bf16 reaches 46 to 1354 units (and the check below shows it fails).
F32_EPS = float(np.finfo(np.float32).eps)
K6_TOL = 2.0
# LD mode: card and CPU solve the same float32-factored system and refine it
# in float64 to the adaptive probe's 1e-5 relative residual; the two
# solutions may differ by that residual times the system's conditioning.
LD_SOLUTION_RTOL = 1e-3

SMI = ""


def say(*parts):
    print(*parts, f"[{SMI}]")


def panel_bound(B, b, with_w):
    """LDL^T of B panels: read A, write LD (and W); b^3/3 multiply-adds for
    the factor, b^3/6 more for W."""
    return bound((3 if with_w else 2) * B * b * b * 4, B * b**3 * (1.0 if with_w else 2.0 / 3.0))


def winv_bound(B, n, nk, itemsize):
    """Read W, d, s, b once, write x; two GEMVs (4 n^2 flops) per block."""
    return bound(B * n * n * itemsize + B * n * 4 + 3 * B * nk * 4, 4.0 * B * n * n)


def phase_device():
    global SMI
    SMI = card_line(torch.device("cuda"))
    print(SMI)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    from parapint_tpu_torch.ops.cuda_build import nvcc

    out = subprocess.run([nvcc(), "--version"], capture_output=True, text=True, check=True)
    print(out.stdout.strip().splitlines()[-1])


def phase_build():
    from parapint_tpu_torch.ops import cuda_build, ldl_panel, read_reduce, winv_apply

    t0 = time.perf_counter()
    paths = cuda_build.build_all([ldl_panel.SOURCE, winv_apply.SOURCE, read_reduce.SOURCE])
    for module in (ldl_panel, winv_apply, read_reduce):
        module._load()
    print(f"build: {sorted(p.name for p in paths.values())} in {time.perf_counter() - t0:.2f} s")
    for name, log in cuda_build.build_logs.items():
        print(f"--- {name}\n{log.strip()}")


def _inertia(LD):
    d = torch.diagonal(LD, dim1=1, dim2=2)
    return ((d > 0).sum().item(), (d < 0).sum().item(), (d == 0).sum().item())


def _check_panel(name, shape, out_k, out_p):
    """Kernel vs plain panel outputs ((LD,) or (LD, W)): the lower triangle
    of LD and all of W bitwise equal; returns the max error (0)."""
    errs = []
    for i, (k, p) in enumerate(zip(out_k, out_p)):
        kk, pp = (torch.tril(k), torch.tril(p)) if i == 0 else (k, p)
        e = (kk - pp).abs().max().item()
        if not torch.equal(kk, pp):
            raise AssertionError(f"{name} disagrees at {shape}: max|d| {e}, tolerance 0")
        errs.append(e)
    if _inertia(out_k[0]) != _inertia(out_p[0]):
        raise AssertionError(f"{name}: inertia differs at {shape}")
    if torch.triu(out_k[0], 1).abs().max().item() != 0.0:
        raise AssertionError(f"{name} wrote the strict upper triangle")
    say(f"{name} {shape}: max|d| {[f'{e:.3e}' for e in errs]} inertia {_inertia(out_k[0])} "
        f"(tolerance 0: bitwise equal)")
    return max(errs)


def _winv_inputs(B, n, nk, seed, zero_pivot=False):
    rng = np.random.default_rng(seed)
    W = np.tril(rng.standard_normal((B, n, n)) / np.sqrt(n), -1) + np.eye(n)
    d = rng.choice([-1.0, 1.0], (B, n)) * rng.uniform(0.1, 10.0, (B, n))
    if zero_pivot:
        d[:, n // 3] = 0.0
    s = rng.uniform(0.5, 2.0, (B, nk))
    b = rng.standard_normal((B, nk))
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device="cuda")
    return t(W), t(d), t(s), t(b)


def phase_kernels():
    from parapint_tpu_torch.ops.ldl_panel import (
        ldl_panels,
        ldl_panels_batched,
        ldl_panels_batched_plain,
        ldl_panels_batched_winv,
        ldl_panels_batched_winv_plain,
        ldl_panels_plain,
        ldl_panels_slab,
        ldl_panels_slab_plain,
        ldl_panels_slab_winv,
        ldl_panels_slab_winv_plain,
        random_panels,
    )
    from parapint_tpu_torch.ops.winv_apply import winv_apply_fused, winv_apply_plain

    cuda = lambda a: torch.as_tensor(a, device="cuda")
    err = {"K1": 0.0, "K2": 0.0, "K3": 0.0, "K4": 0.0, "K5": 0.0, "K6": 0.0}
    entries = {
        "K1": (ldl_panels_slab_winv, ldl_panels_slab_winv_plain),
        "K2": (lambda A: (ldl_panels_slab(A),), lambda A: (ldl_panels_slab_plain(A),)),
        "K3": (ldl_panels_batched_winv, ldl_panels_batched_winv_plain),
        "K4": (lambda A: (ldl_panels_batched(A),), lambda A: (ldl_panels_batched_plain(A),)),
        "K5": (lambda A: (ldl_panels(A),), lambda A: (ldl_panels_plain(A),)),
    }
    # K3/K4: the column phase's widths (128, and 56 for the CR tiles), the
    # odd widths a block_size that is not a multiple of 8 gives (50, 100,
    # 127) and the degenerate 1-wide panel
    batched = [((64, 128, 128), {}), ((32, 56, 56), {}), ((32, 50, 50), {}), ((64, 100, 100), {}),
               ((16, 127, 127), {}), ((3, 1, 1), {}), ((32, 50, 50), {"garbage_upper": True}),
               ((64, 100, 100), {"zero_pivot": True}), ((16, 127, 127), {"garbage_upper": True}),
               ((3, 1, 1), {"zero_pivot": True})]
    cases = {
        "K1": [((64, 64, 64), {}), ((64, 128, 128), {}), ((32, 56, 56), {}), ((1, 56, 56), {}),
               ((3, 8, 8), {}), ((64, 64, 64), {"garbage_upper": True}),
               ((32, 56, 56), {"zero_pivot": True})],
        "K2": [((64, 128, 128), {}), ((32, 56, 56), {}), ((3, 8, 8), {}),
               ((64, 128, 128), {"garbage_upper": True}), ((32, 56, 56), {"zero_pivot": True})],
        "K3": batched,
        "K4": batched,
        "K5": [((1, 128, 128), {}), ((1, 13, 13), {}), ((4, 15, 15), {}),
               ((1, 128, 128), {"garbage_upper": True}), ((4, 15, 15), {"zero_pivot": True})],
    }
    for key, shapes in cases.items():
        kern, plain = entries[key]
        for i, (shape, kw) in enumerate(shapes):
            A = cuda(random_panels(*shape[:2], seed=i, **kw))
            out_k = kern(A)
            torch.cuda.synchronize()
            err[key] = max(err[key], _check_panel(f"{key} {kw or ''}", shape, out_k, plain(A)))

    # the dense flagship's shape, the stochastic QP's (32 scenarios, nk = n =
    # 1024, no padding) and edge cases
    winv_cases = [((64, 1024, 922), False), ((32, 1024, 1024), False), ((13, 256, 200), False),
                  ((7, 64, 64), True), ((3, 24, 20), True)]
    for (B, n, nk), zp in winv_cases:
        W, d, s, b = _winv_inputs(B, n, nk, seed=n, zero_pivot=zp)
        for Wt in (W, W.to(torch.bfloat16)):
            x_k = winv_apply_fused(Wt, d, s, b)
            x_p = winv_apply_plain(Wt, d, s, b)
            unit = np.sqrt(n) * F32_EPS * winv_apply_plain(Wt.abs(), d.abs(), s.abs(), b.abs())
            e = (x_k - x_p).abs().max().item()
            ratio = ((x_k - x_p).abs() / unit).max().item()
            if not ratio <= K6_TOL:
                raise AssertionError(f"K6 disagrees at {(B, n, nk)} {Wt.dtype}: "
                                     f"{ratio} units > {K6_TOL}")
            power = ""
            if Wt.dtype == torch.float32:
                # the tolerance must reject an f32 W read as bf16
                x_bf = winv_apply_plain(Wt.to(torch.bfloat16), d, s, b)
                bf_ratio = ((x_bf - x_p).abs() / unit).max().item()
                if not bf_ratio > K6_TOL:
                    raise AssertionError(f"K6 tolerance passes a bf16 read of W at {(B, n, nk)}")
                power = f"; this W read as bf16: {bf_ratio:.1f} units"
            err["K6"] = max(err["K6"], e)
            say(f"K6 {(B, n, nk)} W {Wt.dtype} zero_pivot={zp}: max|d| {e:.3e}, max "
                f"|d|/unit {ratio:.4f} (tol {K6_TOL} units per entry, unit sqrt(n) eps_f32 |ref| "
                f"on |W|,|d|,|s|,|b|{power})")

    # times at the dense path's shapes (median of 7 CUDA-event windows)
    timing = {}

    def time_panel(key, shape):
        kern, plain = entries[key]
        A = cuda(random_panels(*shape[:2], seed=100))
        ms = timed_loop(lambda: kern(A), 20)
        plain_ms = timed_loop(lambda: plain(A), 2, trials=3)
        bd, by = panel_bound(shape[0], shape[1], key in ("K1", "K3"))
        say(f"time {key} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bd:.5f} ms ({by})")
        return dict(ms=ms, plain_ms=plain_ms, bound_ms=bd, bound_by=by, library_ms=None, shape=shape)

    timing["K1"] = time_panel("K1", (64, 128, 128))
    for shape in [(64, 64, 64)] + [(e, 56, 56) for e in (32, 16, 8, 4, 2, 1)]:
        time_panel("K1", shape)
    timing["K2"] = time_panel("K2", (64, 128, 128))
    timing["K3"] = time_panel("K3", (64, 128, 128))
    time_panel("K3", (64, 100, 100))
    timing["K4"] = time_panel("K4", (64, 128, 128))
    timing["K5"] = time_panel("K5", (1, 128, 128))

    def time_winv(key, B, n, nk, bf16=False):
        W, d, s, b = _winv_inputs(B, n, nk, seed=7)
        Wt = W.to(torch.bfloat16) if bf16 else W
        Wf = Wt.float()
        v = torch.nn.functional.pad(b * s, (0, n - nk))[:, :, None]
        dsafe = torch.where(d.abs() > 0, d, torch.ones_like(d))[:, :, None]
        ms = timed_loop(lambda: winv_apply_fused(Wt, d, s, b), 20)
        plain_ms = timed_loop(lambda: winv_apply_plain(Wt, d, s, b), 5)
        # the library yardstick: the same function as two torch.matmul calls
        # on an f32 W (the port never calls it)
        lib_ms = timed_loop(lambda: Wf.transpose(1, 2) @ ((Wf @ v) / dsafe), 20)
        bd, by = winv_bound(B, n, nk, Wt.element_size())
        say(f"time {key} {(B, n, nk)}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library (two calls) {lib_ms:.4f} ms, bound {bd:.5f} ms ({by}), "
            f"{B * n * n * Wt.element_size() / (ms * 1e-3) / 1e9:.1f} GB/s of W")
        return dict(ms=ms, plain_ms=plain_ms, bound_ms=bd, bound_by=by,
                    library_ms=lib_ms, library="two torch.matmul calls", shape=(B, n, nk))

    timing["K6"] = time_winv("K6", 64, 1024, 922)
    timing["K6 bf16"] = time_winv("K6 bf16", 64, 1024, 922, bf16=True)
    timing["K6 QP"] = time_winv("K6 QP", 32, 1024, 1024)
    return err, timing


def _panel_entries():
    from parapint_tpu_torch.ops import ldl_panel

    return dict(K1=ldl_panel.ldl_panels_slab_winv, K2=ldl_panel.ldl_panels_slab,
                K3=ldl_panel.ldl_panels_batched_winv, K4=ldl_panel.ldl_panels_batched,
                K5=ldl_panel.ldl_panels)


def _reset_counts():
    from parapint_tpu_torch.ops.read_reduce import read_reduce
    from parapint_tpu_torch.ops.winv_apply import winv_apply_fused

    for fn in (*_panel_entries().values(), winv_apply_fused, read_reduce):
        fn.launches = 0
    winv_apply_fused.launches_bf16 = 0


def _counts():
    from parapint_tpu_torch.ops.read_reduce import read_reduce
    from parapint_tpu_torch.ops.winv_apply import winv_apply_fused

    counts = {k: fn.launches for k, fn in _panel_entries().items()}
    counts.update(K6=winv_apply_fused.launches, K6_bf16=winv_apply_fused.launches_bf16,
                  K7=read_reduce.launches)
    return counts


def phase_kernel_lab():
    """K7 against its plain version, then the kernel lab's measurement path
    (``bw``, ``solve``, ``mxu``, ``dispatch`` at their default shapes) with
    every count zeroed just before it and read just after.  Returns (K7
    launches, K7's timing row, K7's best measured read rate in bytes/s)."""
    from parapint_tpu_torch.ops.read_reduce import ROWS_PER_CTA, read_reduce, read_reduce_plain
    from parapint_tpu_torch.tools import kernel_lab

    rng = np.random.default_rng(7)
    for B, n in ((64, 1024), (3, 8), (5, 56)):
        W = torch.as_tensor(rng.standard_normal((B, n, n), dtype=np.float32), device="cuda")
        for rows in kernel_lab.BW_ROWS:
            out_k = read_reduce(W, rows)
            torch.cuda.synchronize()
            out_p = read_reduce_plain(W, rows)
            e = (out_k - out_p).abs().max().item()
            if not torch.equal(out_k, out_p):
                raise AssertionError(f"K7 disagrees at {(B, n, n)} rows_per_cta={rows}: max|d| {e}")
            say(f"K7 {(B, n, n)} rows_per_cta={rows}: max|d| {e:.3e} (tolerance 0: bitwise equal)")
        if B == 64:
            plain_ms = timed_loop(lambda: read_reduce_plain(W), 3, trials=3)
    del W

    _reset_counts()
    torch.cuda.synchronize()
    lab = {cmd: getattr(kernel_lab, f"cmd_{cmd}")(kernel_lab.parse_args([cmd]))
           for cmd in ("bw", "solve", "mxu", "dispatch")}
    torch.cuda.synchronize()
    c = _counts()
    say(f"kernel lab: launches {c}")
    if not c["K7"] > 0:
        raise AssertionError("kernel lab: no K7 launch")
    if torch.get_float32_matmul_precision() != "highest" or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("kernel lab: mxu left the matmul precision changed")
    bw = lab["bw"]
    B, n, _ = bw["shape"]
    bd, by = bound(B * n * n * 4 + B * n * 4, B * n * n)
    timing = dict(ms=bw["rows"][ROWS_PER_CTA]["ms"], plain_ms=plain_ms, bound_ms=bd, bound_by=by,
                  library_ms=bw["library_ms"], library="torch.sum(W, dim=1, keepdim=True)",
                  shape=bw["shape"])
    say(f"time K7 {bw['shape']} rows_per_cta={ROWS_PER_CTA}: kernel {timing['ms']:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library {timing['library_ms']:.4f} ms, bound {bd:.5f} ms ({by})")
    rate = max(r["gbps"] for r in bw["rows"].values()) * 1e9
    return c["K7"], timing, rate


def _dense_solver(coupling="cr", w_store=None, refine=0):
    import parapint_tpu_torch as ptt

    return ptt.SchurComplementSolver(
        block_size=128, explicit_inverse=True, factor_dtype=torch.float32,
        refine_steps=refine, w_store_dtype=w_store,
        schur_complement_solver=ptt.BlockTridiagSolver() if coupling == "cr" else None,
    )


def _dense_iface():
    import parapint_tpu_torch as ptt
    from parapint_tpu_torch.examples import burgers

    t0 = time.perf_counter()
    spec = burgers.build_spec(**FLAGSHIP)  # the card is the default device
    iface = ptt.DynamicSchurComplementInteriorPointInterface(spec, kkt_dtype=torch.float32)
    print(f"dense interface {FLAGSHIP}: nk {iface.nk} ns {iface.ns} ncv {iface.ncv} "
          f"setup {time.perf_counter() - t0:.2f} s")
    return iface


def _objective_gap(iface, result, label, ref=JAX_OBJECTIVE):
    import parapint_tpu_torch as ptt

    if result.status != ptt.InteriorPointStatus.optimal.value:
        raise AssertionError(f"{label}: status {result.status} after {result.iterations} iterations")
    for v in result.state.primals.values():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{label}: non-finite primals")
    iface._current_state = result.state
    obj = float(iface.evaluate_objective())
    gap = abs(obj - ref) / max(1.0, abs(ref))
    if gap > OBJ_REL_GAP:
        raise AssertionError(f"{label}: objective {obj!r}, gap {gap} to JAX {ref!r} > {OBJ_REL_GAP}")
    return obj, gap


def _counted_solve(iface, solver, label, timed=0, ref=JAX_OBJECTIVE, tol=TOL, repeat=False):
    """One counted solve through ``make_fused_ip_solve`` (every count zeroed
    just before, read just after), then ``timed`` timed solves; returns
    (result, counts) with the counted solve's iterations and objective in
    the counts and whether the timed solves repeated its objective bit for
    bit, which ``repeat`` requires."""
    import parapint_tpu_torch as ptt

    opts = ptt.IPOptions()
    opts.tol = tol
    opts.linalg.solver = solver
    solve = ptt.make_fused_ip_solve(iface, opts)
    iface.set_bounds_relaxation_factor(opts.bounds_relaxation_factor)
    state0 = iface.init_state()
    _reset_counts()
    for attr in ("n_numeric", "n_solves"):
        if hasattr(solver, attr):
            setattr(solver, attr, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = solve(state0)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    counts = _counts()
    counts["numerics"] = solver.n_numeric
    counts["solves"] = getattr(solver, "n_solves", None)
    obj, gap = _objective_gap(iface, result, label, ref)
    counts["iterations"], counts["objective"] = result.iterations, obj
    walls, repeats = [], []
    for _ in range(timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = solve(state0)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        repeats.append(_objective_gap(iface, result, label, ref)[0] == obj)
    counts["repeats_bitwise"] = all(repeats)
    say(f"{label}: status optimal, iterations {counts['iterations']}, objective {obj!r} "
        f"(JAX {ref!r}, rel gap {gap:.3e}), primal_inf {float(result.primal_inf):.3e}, "
        f"untimed counted solve {first:.3f} s, launches {counts}")
    if walls:
        wall = min(walls)
        say(f"{label}: wall per solve {wall:.4f} s (min of {[round(w, 4) for w in walls]}), "
            f"iter/s {(result.iterations - 1) / wall:.3f} ((n_iter-1)/wall); timed solves "
            f"repeat the objective bit for bit: {counts['repeats_bitwise']}")
    if repeat and not (walls and counts["repeats_bitwise"]):
        raise AssertionError(f"{label}: a solve from the same state did not repeat bit for bit")
    return result, counts


def phase_dense(iface):
    result, c = _counted_solve(iface, _dense_solver("cr"), "dense flagship", timed=3)
    print(f"dense flagship: iterations {result.iterations} (JAX dense path {JAX_DENSE_ITERATIONS})")
    if not (c["K1"] > 0 and c["K1"] == DENSE_K1_PER_NUMERIC * c["numerics"]):
        raise AssertionError(f"K1: {c['K1']} launches for {c['numerics']} numerics")
    if not (c["K6"] > 0 and c["K6"] == 2 * c["solves"]):
        raise AssertionError(f"K6: {c['K6']} launches for {c['solves']} back solves")
    return c


def phase_dense_sc(iface):
    _, c = _counted_solve(iface, _dense_solver("dense"), "dense SC")
    if not (c["K5"] > 0 and c["K5"] == SC_PANELS_PER_NUMERIC * c["numerics"]):
        raise AssertionError(f"K5: {c['K5']} launches for {c['numerics']} numerics")
    return c


def phase_bf16(iface):
    solver = _dense_solver("cr", w_store=torch.bfloat16, refine=None)
    _, c = _counted_solve(iface, solver, "bf16 W")
    print(f"bf16 W: auto-gate fell back to the f32 W in {solver.n_gate_fallbacks} solve(s)")
    if not c["K6_bf16"] > 0:
        raise AssertionError("bf16 W: no bf16 K6 launch")
    return c


def _to_cpu(obj):
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).cpu()
        for f in dataclasses.fields(obj) if isinstance(getattr(obj, f.name), torch.Tensor)
    })


def _first_kkt(iface):
    """The flagship's first-iteration KKT and rhs (initial state, initial
    barrier)."""
    import parapint_tpu_torch as ptt

    state0 = iface.init_state()
    mu0 = torch.tensor(ptt.IPOptions().init_barrier_parameter, dtype=torch.float64, device=iface.device)
    data = iface.kkt_from_ad(state0, iface.eval_ad(state0), mu0)
    return iface.assemble_kkt(data, 0.0, 0.0), iface.kkt_rhs(data)


def phase_ld(iface):
    import parapint_tpu_torch as ptt

    kkt, rhs = _first_kkt(iface)
    solver = ptt.SchurComplementSolver(block_size=128)
    _reset_counts()
    fact = solver.numeric(kkt)
    x, status = solver.solve_with_status(fact, rhs)
    torch.cuda.synchronize()
    c = _counts()
    cpu = ptt.SchurComplementSolver(block_size=128)
    fact_p = cpu.numeric(_to_cpu(kkt))
    x_p, status_p = cpu.solve_with_status(fact_p, _to_cpu(rhs))
    inert_k = tuple(int(v) for v in fact.inertia.cpu())
    inert_p = tuple(int(v) for v in fact_p.inertia)
    dx = max((x.blocks.cpu() - x_p.blocks).abs().max().item(),
             (x.coupling.cpu() - x_p.coupling).abs().max().item())
    scale = max(x_p.blocks.abs().max().item(), x_p.coupling.abs().max().item())
    say(f"LD mode first KKT: inertia card {inert_k} cpu {inert_p}, status {int(status)}/{int(status_p)}, "
        f"max|dx| {dx:.3e} (max|x| {scale:.3e}, tol {LD_SOLUTION_RTOL} x max|x|), launches {c}")
    if inert_k != inert_p:
        raise AssertionError("LD mode: inertia differs between card and CPU")
    if dx > LD_SOLUTION_RTOL * scale:
        raise AssertionError(f"LD mode: solutions differ by {dx}")
    if c["K2"] != LD_K2_PER_NUMERIC or c["K5"] != SC_PANELS_PER_NUMERIC:
        raise AssertionError(f"LD mode: K2 {c['K2']} K5 {c['K5']} launches for one numeric")
    return c, fact.block_LD


def phase_column(iface, slab, slab_LD):
    """``PT_PANEL_ALGO=column`` sends every float32 panel to the
    column-by-column entries: K3 and K4 run the same kernel instantiations as
    K1 and K2, so the dense flagship and the LD-mode factor must repeat the
    slab runs bit for bit.  Then a block_size of 100 sends the block panels
    to K3 under the default algorithm."""
    import parapint_tpu_torch as ptt

    before = os.environ.get("PT_PANEL_ALGO")
    os.environ["PT_PANEL_ALGO"] = "column"
    try:
        _, c = _counted_solve(iface, _dense_solver("cr"), "column dense flagship")
        print(f"column dense flagship: iterations {c['iterations']} objective {c['objective']!r} "
              f"(slab run: {slab['iterations']} {slab['objective']!r})")
        if not (c["K3"] > 0 and c["K3"] == DENSE_K1_PER_NUMERIC * c["numerics"] and c["K1"] == 0):
            raise AssertionError(f"column: K3 {c['K3']} K1 {c['K1']} launches for {c['numerics']} numerics")
        if (c["iterations"], c["objective"]) != (slab["iterations"], slab["objective"]):
            raise AssertionError("column: the dense flagship differs from the slab run")
        kkt, rhs = _first_kkt(iface)
        _reset_counts()
        fact = ptt.SchurComplementSolver(block_size=128).numeric(kkt)
        torch.cuda.synchronize()
        c_ld = _counts()
        same = torch.equal(fact.block_LD, slab_LD)
        say(f"column LD mode first KKT: launches {c_ld}, LD equal to the slab run's bit for bit: {same}")
        if c_ld["K4"] != LD_K2_PER_NUMERIC or c_ld["K2"] != 0 or not same:
            raise AssertionError(f"column LD mode: K4 {c_ld['K4']} K2 {c_ld['K2']} equal {same}")
        del fact
    finally:
        if before is None:
            os.environ.pop("PT_PANEL_ALGO")
        else:
            os.environ["PT_PANEL_ALGO"] = before

    def w100():
        return ptt.SchurComplementSolver(
            block_size=100, explicit_inverse=True, factor_dtype=torch.float32,
            schur_complement_solver=ptt.BlockTridiagSolver(),
        )

    _reset_counts()
    fact = w100().numeric(kkt)
    torch.cuda.synchronize()
    c100 = _counts()
    fact_p = w100().numeric(_to_cpu(kkt))
    inert_k = tuple(int(v) for v in fact.inertia.cpu())
    inert_p = tuple(int(v) for v in fact_p.inertia)
    status = (int(fact.status), int(fact_p.status))
    say(f"block_size=100 W-form numeric of the first KKT: inertia card {inert_k} cpu {inert_p}, "
        f"status {status}, launches {c100}")
    if c100["K3"] != W100_K3_PER_NUMERIC or c100["K1"] != W100_K1_PER_NUMERIC:
        raise AssertionError(f"block_size=100: K3 {c100['K3']} K1 {c100['K1']} launches")
    if inert_k != inert_p or status != (0, 0):
        raise AssertionError("block_size=100: inertia or status differs between card and CPU")
    return c, c_ld


def phase_banded():
    import parapint_tpu_torch as ptt
    from parapint_tpu_torch.examples import burgers

    t0 = time.perf_counter()
    spec = burgers.build_spec(**FLAGSHIP)
    iface = ptt.DynamicSchurComplementInteriorPointInterface(
        spec, kkt_dtype=torch.float32, block_form="banded"
    )
    solver = ptt.BandedSchurComplementSolver(
        tile_size=TILE_SIZE, schur_complement_solver=ptt.BlockTridiagSolver(ns=iface.ns)
    )
    print(f"banded interface {FLAGSHIP}: nk {iface.nk} p {iface.banded_plan.p} "
          f"setup {time.perf_counter() - t0:.2f} s")
    result, c = _counted_solve(iface, solver, "banded flagship", timed=1)
    print(f"banded flagship: iterations {result.iterations} (JAX {JAX_ITERATIONS})")
    if not (c["K1"] > 0 and c["K1"] == BANDED_PANELS_PER_NUMERIC * c["numerics"]):
        raise AssertionError(f"banded: {c['K1']} K1 launches for {c['numerics']} numerics")
    return c


def _timer_lines(timer, depth=3):
    """The timer's phases down to ``depth`` levels, as one line."""
    out = []

    def walk(node, prefix, level):
        for name, child in node.children.items():
            out.append(f"{prefix}{name} {child.total:.3f} s (n={child.count})")
            if level < depth:
                walk(child, prefix + name + "/", level + 1)

    walk(timer._root, "", 1)
    return "; ".join(out)


def phase_stochastic_qp(device="cuda", shape=QP, ref=QP_JAX_OBJECTIVE,
                        ref_iters=(QP_JAX_ITERATIONS, QP_JAX_IP_ITERATIONS)):
    """The two-stage stochastic QP through both drivers.  The float32 KKT
    with a float64 factor makes ``check_precision_compat`` warn, as it does
    in the JAX package for the same configuration."""
    import parapint_tpu_torch as ptt
    from parapint_tpu_torch.examples import stochastic
    from parapint_tpu_torch.utils.timer import HierarchicalTimer

    def solver():
        return ptt.SchurComplementSolver(
            block_size=128, explicit_inverse=True, factor_dtype=torch.float64,
            apply_dtype=torch.float32,
        )

    def kernels_ok(c, label):
        panels = {k: c[k] for k in ("K1", "K2", "K3", "K4")}
        if not (c["K6"] > 0 and c["K6"] == 2 * c["solves"] and c["K5"] == c["numerics"] > 0
                and not any(panels.values())):
            raise AssertionError(f"{label}: launches {c}")

    t0 = time.perf_counter()
    iface = ptt.StochasticSchurComplementInteriorPointInterface(
        stochastic.qp_spec(**shape, device=device), kkt_dtype=torch.float32
    )
    print(f"stochastic QP {shape}: nk {iface.nk} ncv {iface.ncv} blocks {iface.N} "
          f"setup {time.perf_counter() - t0:.2f} s")
    result, c = _counted_solve(iface, solver(), "stochastic QP fused", timed=1, ref=ref, repeat=True)
    print(f"stochastic QP fused: iterations {c['iterations']} (JAX {ref_iters[0]}); "
          f"K5 {c['K5']} for {c['numerics']} numerics, K6 {c['K6']} for {c['solves']} back solves")
    kernels_ok(c, "stochastic QP fused")
    if abs(c["iterations"] - ref_iters[0]) > 1:
        raise AssertionError(f"stochastic QP fused: {c['iterations']} iterations, JAX {ref_iters[0]}")

    s = solver()
    opts = ptt.IPOptions()
    opts.tol = TOL
    opts.linalg.solver = s
    timer = HierarchicalTimer()
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    status = ptt.ip_solve(iface, opts, timer=timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c_ip = _counts()
    c_ip["numerics"], c_ip["solves"] = s.n_numeric, s.n_solves
    n_iter = timer._root.children["IP solve"].children["convergence check"].count
    obj = float(iface.evaluate_objective())
    gap = abs(obj - ref) / max(1.0, abs(ref))
    say(f"stochastic QP ip_solve: status {status.name}, iterations {n_iter} (JAX {ref_iters[1]}), "
        f"objective {obj!r} (JAX {ref!r}, rel gap {gap:.3e}), wall {wall:.4f} s, "
        f"K5 {c_ip['K5']} for {c_ip['numerics']} numerics, K6 {c_ip['K6']} for "
        f"{c_ip['solves']} back solves, launches {c_ip}")
    say(f"stochastic QP ip_solve phases: {_timer_lines(timer)}")
    if status != ptt.InteriorPointStatus.optimal or gap > OBJ_REL_GAP:
        raise AssertionError(f"stochastic QP ip_solve: {status.name}, gap {gap}")
    if abs(n_iter - ref_iters[1]) > 1:
        raise AssertionError(f"stochastic QP ip_solve: {n_iter} iterations, JAX {ref_iters[1]}")
    kernels_ok(c_ip, "stochastic QP ip_solve")
    return c, c_ip


def phase_farmer(device="cuda", family_ref=(FARMER32_JAX_OBJECTIVE, FARMER32_JAX_ITERATIONS),
                 n_scenarios=32):
    """The farmer through ``examples/stochastic.main`` (``ip_solve``) and the
    farmer family through the fused driver."""
    import parapint_tpu_torch as ptt
    from parapint_tpu_torch.examples import stochastic

    _reset_counts()
    t0 = time.perf_counter()
    acre = stochastic.main(device=device).get_first_stage_values().cpu().numpy()
    wall = time.perf_counter() - t0
    err = float(np.abs(acre - np.asarray(FARMER_ACRES)).max())
    say(f"farmer (examples/stochastic.main): acreage {acre.tolist()}, max|d| to "
        f"{FARMER_ACRES} {err:.3e} (tol {FARMER_ATOL}), wall {wall:.3f} s, launches {_counts()}")
    if not err <= FARMER_ATOL:
        raise AssertionError(f"farmer: acreage {acre.tolist()}")
    iface = ptt.StochasticSchurComplementInteriorPointInterface(
        stochastic.farmer_family(num_scenarios=n_scenarios, device=device)
    )
    solver = ptt.SchurComplementSolver(block_size=64, explicit_inverse=True)
    _, c = _counted_solve(iface, solver, "farmer family", timed=1, ref=family_ref[0],
                          tol=ptt.IPOptions().tol, repeat=True)
    if abs(c["iterations"] - family_ref[1]) > 1:
        raise AssertionError(f"farmer family: {c['iterations']} iterations, JAX {family_ref[1]}")
    return c


def phase_single(device="cuda"):
    """The single-NLP examples through ``ip_solve``."""
    from parapint_tpu_torch.examples import dynamics, interior_point

    t0 = time.perf_counter()
    x = interior_point.main(device=device).get_primals().cpu().numpy()
    wall = time.perf_counter() - t0
    err = float(np.abs(x - np.array([0.0, 1.0])).max())
    say(f"interior_point example: x {x.tolist()}, max|d| to (0, 1) {err:.3e} (tol 1e-7), "
        f"wall {wall:.3f} s")
    if not err <= 1e-7:
        raise AssertionError(f"interior_point example: x {x.tolist()}")
    t0 = time.perf_counter()
    _, _, p = dynamics.main(device=device)
    wall = time.perf_counter() - t0
    err = float(np.abs(p[: len(DYNAMICS_GOLDEN_P)] - np.asarray(DYNAMICS_GOLDEN_P)).max())
    say(f"dynamics example: p(t)[:9] max|d| to the golden values {err:.3e} (tol 1e-6), "
        f"wall {wall:.3f} s")
    if not err <= 1e-6:
        raise AssertionError(f"dynamics example: p(t) {p.tolist()}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(1)

    t_start = time.perf_counter()
    phase_device()
    phase_build()
    err, timing = phase_kernels()
    k7_launches, timing["K7"], k7_rate = phase_kernel_lab()
    err["K7"] = 0.0
    iface = _dense_iface()
    dense = phase_dense(iface)
    dense_sc = phase_dense_sc(iface)
    phase_bf16(iface)
    ld, ld_LD = phase_ld(iface)
    column, column_ld = phase_column(iface, dense, ld_LD)
    del iface, ld_LD
    torch.cuda.empty_cache()
    phase_stochastic_qp()
    torch.cuda.empty_cache()
    phase_farmer()
    phase_single()
    banded = phase_banded()
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")

    src = "parapint_tpu_torch/csrc/ldl_panel_winv.cu"
    rows = [
        ("K1", "ldl_panels_slab_winv", src, "parapint_tpu/ops/pallas_ldl.py:408", dense["K1"]),
        ("K2", "ldl_panels_slab", src, "parapint_tpu/ops/pallas_ldl.py:364", ld["K2"]),
        ("K3", "ldl_panels_batched_winv", src, "parapint_tpu/ops/pallas_ldl.py:495", column["K3"]),
        ("K4", "ldl_panels_batched", src, "parapint_tpu/ops/pallas_ldl.py:554", column_ld["K4"]),
        ("K5", "ldl_panels", src, "parapint_tpu/ops/pallas_ldl.py:583", dense_sc["K5"]),
        ("K6", "winv_apply_fused", "parapint_tpu_torch/csrc/winv_apply.cu",
         "parapint_tpu/ops/winv_apply.py:138", dense["K6"]),
        ("K7", "read_reduce", "parapint_tpu_torch/csrc/read_reduce.cu",
         "tools/kernel_lab.py:276", k7_launches),
    ]
    # each bytes-bound kernel's time against the bytes it moves at K7's
    # measured read rate, beside the spec bound (3.35 TB/s)
    for key in ("K1", "K2", "K3", "K4", "K5", "K6", "K6 bf16", "K6 QP", "K7"):
        t = timing[key]
        if t["bound_by"] == "bytes":
            at_k7 = t["bound_ms"] * PEAK_BYTES / k7_rate
            say(f"{key} {tuple(t['shape'])}: {t['ms']:.4f} ms; at K7's read rate "
                f"{k7_rate / 1e9:.1f} GB/s the bytes take {at_k7:.5f} ms "
                f"({at_k7 / t['ms'] * 100:.1f}% of its time), at 3.35 TB/s {t['bound_ms']:.5f} ms "
                f"({t['bound_ms'] / t['ms'] * 100:.1f}%)")
    kernels = []
    for key, name, source, replaces, launches in rows:
        t = timing[key]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err[key], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "library": t.get("library"),
            "shape": list(t["shape"]),
        })
    print(f"banded flagship K1 launches {banded['K1']} for {banded['numerics']} numerics [{SMI}]")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
