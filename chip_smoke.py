"""Smoke run of the PyTorch port on one CUDA card: build the panel kernel,
hold it against its plain version, and solve the 64-block Burgers flagship
through the port's public entry points.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's exception is caught):

1. device   — require CUDA; print the card's name and power limit, the
              torch/CUDA versions and ``nvcc --version``.
2. build    — compile the LDL^T + L^{-1} panel kernel from
              ``parapint_tpu_torch/csrc`` into ``parapint_tpu_torch/_build``.
3. kernel   — kernel vs ``ldl_panels_slab_winv_plain`` on the card, at the
              flagship's panel shapes plus edge cases; time both.
4. flagship — Burgers nfe_x=50, nfe_t=256, 64 blocks, banded KKT in
              float32, 128-wide tiles, cyclic-reduction coupling solve, tol
              1e-8, through ``make_fused_ip_solve``; require status optimal,
              the JAX package's objective, and that every panel
              factorization of the run went through the kernel.

The last line of standard output is the JSON result; the line before it
lists each kernel with its launches, error and times.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

# JAX package's objective for the flagship configuration below, on the CPU:
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
JAX_OBJECTIVE = 0.04755768812300182
JAX_ITERATIONS = 6
OBJ_REL_GAP = 1e-6
FLAGSHIP = dict(nfe_x=50, nfe_t=256, num_time_blocks=64)
TILE_SIZE = 128
TOL = 1e-8
PANELS_PER_NUMERIC = 22  # 8 tiles x 2 panels (Thomas) + 6 CR levels

# kernel-vs-plain shapes: the flagship's (64, 64, 64) Thomas panels and
# (E, 56, 56) CR panels, the largest supported panel, and the smallest
KERNEL_SHAPES = [(64, 64, 64), (32, 56, 56), (1, 56, 56), (64, 128, 128), (3, 8, 8)]
TIMED_SHAPES = [(64, 64, 64)] + [(e, 56, 56) for e in (32, 16, 8, 4, 2, 1)]
# Both versions run the same float32 algorithm; they differ only in
# rounding (fused multiply-adds, evaluation order), so entries agree to a few
# float32 ulps of the panel's largest factor entry.  Inertia must be equal.
KERNEL_RTOL = 3e-5


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    from parapint_tpu_torch.ops.ldl_panel import _nvcc

    nvcc = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True, check=True)
    print(nvcc.stdout.strip().splitlines()[-1])
    return smi


def phase_build():
    from parapint_tpu_torch.ops import ldl_panel

    t0 = time.perf_counter()
    path = ldl_panel.build()
    ldl_panel._load()
    print(f"build: {path.name} in {time.perf_counter() - t0:.2f} s")
    if ldl_panel.build_log:
        print(ldl_panel.build_log.strip())


def _inertia(LD):
    d = torch.diagonal(LD, dim1=1, dim2=2)
    return ((d > 0).sum().item(), (d < 0).sum().item(), (d == 0).sum().item())


def compare_kernel(A_np, device):
    """Kernel vs plain on the same panels; returns max abs errors."""
    from parapint_tpu_torch.ops.ldl_panel import (
        ldl_panels_slab_winv,
        ldl_panels_slab_winv_plain,
    )

    A = torch.as_tensor(A_np, device=device)
    LD_k, W_k = ldl_panels_slab_winv(A)
    LD_p, W_p = ldl_panels_slab_winv_plain(A)
    torch.cuda.synchronize()
    e_ld = (torch.tril(LD_k) - torch.tril(LD_p)).abs().max().item()
    e_w = (W_k - W_p).abs().max().item()
    s_ld = max(1.0, torch.tril(LD_p).abs().max().item())
    s_w = max(1.0, W_p.abs().max().item())
    if not (e_ld <= KERNEL_RTOL * s_ld and e_w <= KERNEL_RTOL * s_w):
        raise AssertionError(f"kernel disagrees at {tuple(A.shape)}: LD {e_ld} W {e_w}")
    if _inertia(LD_k) != _inertia(LD_p):
        raise AssertionError(f"inertia differs at {tuple(A.shape)}")
    if torch.triu(LD_k, 1).abs().max().item() != 0.0:
        raise AssertionError("kernel wrote the strict upper triangle")
    return e_ld, e_w, _inertia(LD_k)


def _median_ms(fn, calls, trials=7):
    """Median over trials of the CUDA-event time of ``calls`` back-to-back
    calls, per call, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / calls)
    return float(np.median(times))


def phase_kernel(device="cuda"):
    from parapint_tpu_torch.ops.ldl_panel import (
        ldl_panels_slab_winv,
        ldl_panels_slab_winv_plain,
        random_panels,
    )

    max_err = 0.0
    cases = [(s, {}) for s in KERNEL_SHAPES]
    cases += [((64, 64, 64), {"garbage_upper": True}), ((32, 56, 56), {"zero_pivot": True})]
    for i, (shape, kw) in enumerate(cases):
        e_ld, e_w, inert = compare_kernel(random_panels(*shape[:2], seed=i, **kw), device)
        max_err = max(max_err, e_ld, e_w)
        print(f"kernel {shape} {kw or ''}: max|dLD| {e_ld:.3e} max|dW| {e_w:.3e} "
              f"inertia {inert} (tol {KERNEL_RTOL} x max(1, max|ref|))")
    timings = {}
    for shape in TIMED_SHAPES:
        A = torch.as_tensor(random_panels(*shape[:2], seed=100), device=device)
        ms = _median_ms(lambda: ldl_panels_slab_winv(A), 50)
        plain_ms = _median_ms(lambda: ldl_panels_slab_winv_plain(A), 3)
        timings[shape] = (ms, plain_ms)
        print(f"time {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
              "(per call, median of 7 warm back-to-back runs)")
    return max_err, timings


def _kkt_to(kkt, device):
    import dataclasses

    return dataclasses.replace(
        kkt, **{
            f.name: getattr(kkt, f.name).to(device)
            for f in dataclasses.fields(kkt)
            if isinstance(getattr(kkt, f.name), torch.Tensor)
        }
    )


def phase_flagship(device="cuda", config=FLAGSHIP, reference_objective=JAX_OBJECTIVE):
    import parapint_tpu_torch as ptt
    from parapint_tpu_torch.examples import burgers
    from parapint_tpu_torch.ops.ldl_panel import ldl_panels_slab_winv

    t0 = time.perf_counter()
    spec = burgers.build_spec(**config, device=device)
    iface = ptt.DynamicSchurComplementInteriorPointInterface(
        spec, kkt_dtype=torch.float32, block_form="banded", device=device
    )
    solver = ptt.BandedSchurComplementSolver(
        tile_size=TILE_SIZE,
        schur_complement_solver=ptt.BlockTridiagSolver(ns=iface.ns),
        device=device,
    )
    print(f"flagship {config}: nk {iface.nk} p {iface.banded_plan.p} ns {iface.ns} "
          f"ncv {iface.ncv} setup {time.perf_counter() - t0:.2f} s")
    opts = ptt.IPOptions()
    opts.tol = TOL
    opts.linalg.solver = solver
    solve = ptt.make_fused_ip_solve(iface, opts)
    iface.set_bounds_relaxation_factor(opts.bounds_relaxation_factor)
    state0 = iface.init_state()

    # the counted run: every count is zeroed just before it, read just after
    ldl_panels_slab_winv.launches = 0
    solver.n_numeric = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    result = solve(state0)
    torch.cuda.synchronize()
    first_wall = time.perf_counter() - t1
    launches = ldl_panels_slab_winv.launches
    n_numeric = solver.n_numeric
    print(f"untimed run: {first_wall:.3f} s, numeric factorizations {n_numeric}, "
          f"panel kernel launches {launches}")
    if result.status != ptt.InteriorPointStatus.optimal.value:
        raise AssertionError(f"status {result.status} after {result.iterations} iterations")
    if not (launches > 0 and launches == PANELS_PER_NUMERIC * n_numeric):
        raise AssertionError(f"{launches} launches for {n_numeric} numeric factorizations")

    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        result = solve(state0)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    wall = min(walls)
    n_iter = result.iterations
    iface._current_state = result.state
    obj = float(iface.evaluate_objective())
    gap = abs(obj - reference_objective) / max(1.0, abs(reference_objective))
    for v in result.state.primals.values():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError("non-finite primals")
    print(f"flagship: status optimal, iterations {n_iter} (JAX {JAX_ITERATIONS}), "
          f"objective {obj!r} (JAX {reference_objective!r}, rel gap {gap:.3e}), "
          f"primal_inf {float(result.primal_inf):.3e}")
    print(f"flagship: wall per solve {wall:.4f} s (min of {[round(w, 4) for w in walls]}), "
          f"iter/s {(n_iter - 1) / wall:.3f} ((n_iter-1)/wall)")
    if gap > OBJ_REL_GAP:
        raise AssertionError(f"objective gap {gap} > {OBJ_REL_GAP}")

    # first iteration's KKT: kernel on the card vs the plain version (the
    # same solver on a CPU copy of the KKT)
    mu0 = torch.tensor(opts.init_barrier_parameter, dtype=torch.float64, device=device)
    data = iface.kkt_from_ad(state0, iface.eval_ad(state0), mu0)
    kkt = iface.assemble_kkt(data, 0.0, 0.0)
    fact_k = solver.numeric(kkt)
    solver_cpu = ptt.BandedSchurComplementSolver(
        tile_size=TILE_SIZE, schur_complement_solver=ptt.BlockTridiagSolver(ns=iface.ns)
    )
    fact_p = solver_cpu.numeric(_kkt_to(kkt, "cpu"))
    inert_k = tuple(int(v) for v in fact_k.inertia.cpu())
    inert_p = tuple(int(v) for v in fact_p.inertia)
    dtinv = (fact_k.thomas.tinv.cpu() - fact_p.thomas.tinv).abs().max().item()
    scale = fact_p.thomas.tinv.abs().max().item()
    print(f"first KKT: inertia kernel {inert_k} plain {inert_p}, "
          f"max|d tinv| {dtinv:.3e} (max|tinv| {scale:.3e})")
    if inert_k != inert_p:
        raise AssertionError("inertia of the first KKT differs between kernel and plain")
    return launches, n_iter, wall, obj


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    import parapint_tpu_torch  # noqa: F401  (fails outside a checkout)

    phase_device()
    phase_build()
    max_err, timings = phase_kernel()
    launches, n_iter, wall, obj = phase_flagship()
    ms, plain_ms = timings[(64, 64, 64)]
    print(json.dumps({"kernels": [{
        "name": "ldl_panels_slab_winv",
        "route": "cuda",
        "source": "parapint_tpu_torch/csrc/ldl_panel_winv.cu",
        "replaces": "parapint_tpu/ops/pallas_ldl.py:127",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
