"""Where the time of the port's flagship solves goes, on one CUDA card.

    python3 profile_flagship.py [dense] [banded] [qp] [heterogeneous] [pcg]

Builds the configurations of ``chip_smoke.py`` named (dense, banded and qp
by default): "dense" — the Burgers flagship (50/256/64, float32 KKT,
cyclic-reduction coupling solve, tol 1e-8) on dense blocks,
``SchurComplementSolver`` in W form (the JAX package's
``burgers_64blocks_cr``); "banded" — the same on band stores,
``BandedSchurComplementSolver`` with 128-wide tiles; "qp" — the two-stage
stochastic QP (32 scenarios, nk 1024, float32 KKT, tol 1e-8) through the
hybrid ``SchurComplementSolver`` (float64 pivot sweep, float32 W);
"heterogeneous" — the dense flagship as two kinds
(``HeterogeneousDynamicInterface``) with the dense solver; "pcg" — the
JAX package's ``burgers_pcg_coupling_8blocks`` (50/32/8, float32 KKT,
``PCGSchurComplementSolver``).  For each it prints, all from this one run:

1. the card's name and power limit;
2. the wall time of five warm solves (host clock, synchronised);
3. per phase, the host wall time of one solve in which every phase call
   is bracketed by ``torch.cuda.synchronize()`` (so each phase's time
   includes its device work);
4. one solve under ``torch.profiler``: its wall time, the summed device
   time of its kernels, their busy share of that traced wall, the number of
   kernel launches, the kernels with the most device time, and the device
   time under each of the solver's ``sc_solver.*`` phase labels.

Writes nothing; everything goes to standard output.
"""

import collections
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import (
    FLAGSHIP, LAUNCH_CALLS, PCG_SHAPE, QP, TILE_SIZE, TOL, _dense_solver, _pcg_solver,
    burgers_two_kinds,
)
from parapint_tpu_torch.tools.kernel_lab import card_line


def _timed(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t, out


def _bracket_phases(objs_names, host, calls):
    """Replace each bound method by one that synchronises around the call
    and adds its wall time to ``host``; returns a function undoing it."""
    saved = []
    for obj, name in objs_names:
        f = getattr(obj, name)

        def wrapped(*a, _f=f, _name=name, **k):
            dt, out = _timed(lambda: _f(*a, **k))
            host[_name] += dt
            calls[_name] += 1
            return out

        saved.append((obj, name))
        setattr(obj, name, wrapped)
    return lambda: [delattr(obj, name) for obj, name in saved]


def profile_path(path):
    import parapint_tpu_torch as ptt
    from parapint_tpu_torch.examples import burgers

    print(f"===== {path} path")
    if path == "qp":
        from parapint_tpu_torch.examples import stochastic

        iface = ptt.StochasticSchurComplementInteriorPointInterface(
            stochastic.qp_spec(**QP), kkt_dtype=torch.float32
        )
        solver = ptt.SchurComplementSolver(
            block_size=128, explicit_inverse=True, factor_dtype=torch.float64,
            apply_dtype=torch.float32,
        )
    elif path == "heterogeneous":
        iface = burgers_two_kinds(burgers.build_spec(**FLAGSHIP), kkt_dtype=torch.float32)
        solver = _dense_solver("cr")
    elif path == "pcg":
        iface = ptt.DynamicSchurComplementInteriorPointInterface(
            burgers.build_spec(**PCG_SHAPE), kkt_dtype=torch.float32
        )
        solver = _pcg_solver()
    else:
        iface = ptt.DynamicSchurComplementInteriorPointInterface(
            burgers.build_spec(**FLAGSHIP), kkt_dtype=torch.float32, block_form=path
        )
        solver = _dense_solver("cr") if path == "dense" else ptt.BandedSchurComplementSolver(
            tile_size=TILE_SIZE, schur_complement_solver=ptt.BlockTridiagSolver(ns=iface.ns)
        )
    opts = ptt.IPOptions()
    opts.tol = TOL
    opts.linalg.solver = solver
    solve = ptt.make_fused_ip_solve(iface, opts)
    iface.set_bounds_relaxation_factor(opts.bounds_relaxation_factor)
    s0 = iface.init_state()

    first, res = _timed(lambda: solve(s0))
    print(f"first solve (loads the kernels, building them if _build/ has none) {first:.4f} s, "
          f"iterations {res.iterations}, status {res.status}")
    walls = [_timed(lambda: solve(s0))[0] for _ in range(5)]
    print("warm solve walls (s):", [round(w, 4) for w in walls])

    phases = [(iface, n) for n in (
        "eval_ad", "convergence_from_ad", "kkt_from_ad", "assemble_kkt",
        "extract_deltas", "fraction_to_the_boundary", "apply_step",
    )] + [(solver, n) for n in ("numeric", "solve_with_status")]
    host, calls = collections.defaultdict(float), collections.Counter()
    undo = _bracket_phases(phases, host, calls)
    if hasattr(solver, "cg_iterations"):
        solver.cg_iterations = []
    wall, _ = _timed(lambda: solve(s0))
    undo()
    print(f"phase-synchronised solve {wall:.4f} s")
    if hasattr(solver, "cg_iterations"):
        print(f"CG iterations per back solve {solver.cg_iterations}")
    print(f"{'phase':28s} {'host ms (sync)':>15s} {'calls':>6s}")
    for _, name in sorted(phases, key=lambda p: -host[p[1]]):
        print(f"{name:28s} {host[name] * 1e3:15.2f} {calls[name]:6d}")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pwall, _ = _timed(lambda: solve(s0))
    ka = prof.key_averages()
    # the sc_solver.* labels also appear as device-side ranges; they are
    # spans, not kernels, and are kept out of the sums
    kernels = [
        e for e in ka
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.key.startswith("sc_solver.")
    ]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in ka if e.key in LAUNCH_CALLS)
    print(f"traced solve wall {pwall * 1e3:.2f} ms; summed kernel device time "
          f"{dev_ms:.2f} ms; device busy share of the traced solve "
          f"{dev_ms / (pwall * 1e3):.4f}; kernel launches {launches}")
    print(f"{'kernel':60s} {'device ms':>10s} {'calls':>6s} {'us/call':>8s}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        ms = e.self_device_time_total / 1e3
        print(f"{e.key[:60]:60s} {ms:10.3f} {e.count:6d} {ms * 1e3 / e.count:8.2f}")
    labels = [
        e for e in ka
        if e.key.startswith("sc_solver.") and e.device_type == torch.autograd.DeviceType.CPU
    ]
    if labels:
        # device ms: kernel time launched inside the label; host ms: its
        # wall on the host (the traced solve, so slowed by the tracer)
        print(f"{'solver phase label':28s} {'device ms':>10s} {'host ms':>10s} {'calls':>6s}")
        for e in sorted(labels, key=lambda e: -e.device_time_total):
            print(f"{e.key:28s} {e.device_time_total / 1e3:10.3f} "
                  f"{e.cpu_time_total / 1e3:10.3f} {e.count:6d}")


def main():
    if not torch.cuda.is_available():
        print("profile_flagship: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    print(card_line(torch.device("cuda")))
    for path in sys.argv[1:] or ("dense", "banded", "qp"):
        profile_path(path)


if __name__ == "__main__":
    main()
