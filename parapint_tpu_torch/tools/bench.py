"""Benchmark: interior-point iterations/s of the 64-block Burgers flagship
(the port's counterpart of the JAX package's root ``bench.py``).

    python -m parapint_tpu_torch.tools.bench [--device cuda|cpu]
        [--nfe_x 50] [--nfe_t 256] [--blocks 64]

Prints ONE JSON line, as ``bench.py`` does, after the card's line:

  {"metric": "ip_iterations_per_s_burgers_64blocks", "value": N,
   "unit": "iter/s", "vs_baseline": N, "detail": {...}}

with ``detail.backend`` ("cuda" or "cpu") and ``detail.device`` (the
card's name and power limit from ``nvidia-smi``, or "cpu") added.

Measurement (ours)
------------------
``make_fused_ip_solve`` of Burgers optimal control (nfe_x=50, nfe_t=256,
64 time blocks) at tol 1e-8, float32 KKT.  By default the banded block form:
``BandedSchurComplementSolver(tile_size=128)`` with the cyclic-reduction
coupling ``BlockTridiagSolver(ns=iface.ns)``.  Knobs (read from the
environment, as ``bench.py`` reads them):

  PT_BENCH_BLOCK=dense     the dense block form: ``SchurComplementSolver``
                           in W form, float32 factors, refine_steps=0
  PT_BENCH_TS=<int>        the banded tile size (default 128)
  PT_BENCH_SC=dense        dense form: the dense ``DenseLDLSolver``
                           coupling instead of cyclic reduction
  PT_BENCH_W=bf16          dense form: W stored in bf16
  PT_BENCH_REFINE=adaptive dense form: adaptive refinement (with the bf16
                           auto-gate) instead of refine_steps=0

One solve, then the best of 3 regions of 3 back-to-back solves; the clock
is read after the card has finished (a synchronise).  iterations/s =
(n_iter - 1) / wall, all evaluation, assembly, factorization and
convergence work included.

Baseline
--------
The reference (sandialabs/parapint) cannot run here, so the baseline
rebuilds its per-iteration KKT linear algebra with scipy on the port's own
float64 KKT blocks at the same size, idealized to perfect n_blocks-rank MPI
scaling (no communication, no model evaluation):

  time/iter = max over blocks of (SuperLU factorization of the block + one
              back solve per nonzero border row for the SC contribution)
              + the dense SC's SuperLU factorization
              + the back-solve phase (2 block solves + one SC solve)

It runs in a child process that sees no card (``CUDA_VISIBLE_DEVICES=""``,
``device="cpu"``) and reports that it saw none.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from parapint_tpu_torch.tools.kernel_lab import card_line
from parapint_tpu_torch.utils.device import require_device

NFE_X = 50
NFE_T = 256
N_BLOCKS = 64
TOL = 1e-8
REPO = Path(__file__).resolve().parents[2]


def build_problem(nfe_x=NFE_X, nfe_t=NFE_T, n_blocks=N_BLOCKS, kkt_dtype=torch.float32,
                  block_form=None, device="cuda"):
    """The flagship's interface; ``kkt_dtype=None`` assembles the KKT in
    float64 (the scipy baseline's input)."""
    import parapint_tpu_torch as ptt
    from parapint_tpu_torch.examples import burgers

    spec = burgers.build_spec(nfe_x=nfe_x, nfe_t=nfe_t, num_time_blocks=n_blocks, device=device)
    kw = {} if block_form is None else {"block_form": block_form}
    return ptt.DynamicSchurComplementInteriorPointInterface(spec, kkt_dtype=kkt_dtype, **kw)


def block_form() -> str:
    """PT_BENCH_BLOCK: "banded" (default) or "dense"."""
    return os.environ.get("PT_BENCH_BLOCK", "banded")


def make_solver(iface):
    """The solver the knobs select (module docstring)."""
    import parapint_tpu_torch as ptt

    if block_form() == "banded":
        return ptt.BandedSchurComplementSolver(
            schur_complement_solver=ptt.BlockTridiagSolver(ns=iface.ns),
            tile_size=int(os.environ.get("PT_BENCH_TS", "128")),
        )
    sc = None if os.environ.get("PT_BENCH_SC") == "dense" else ptt.BlockTridiagSolver()
    return ptt.SchurComplementSolver(
        block_size=128, explicit_inverse=True, factor_dtype=torch.float32,
        refine_steps=None if os.environ.get("PT_BENCH_REFINE") == "adaptive" else 0,
        schur_complement_solver=sc,
        w_store_dtype=torch.bfloat16 if os.environ.get("PT_BENCH_W") == "bf16" else None,
    )


def finish(result) -> None:
    """Wait until the card has finished the work behind ``result``."""
    device = next(iter(result.state.primals.values())).device
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_ours(nfe_x=NFE_X, nfe_t=NFE_T, n_blocks=N_BLOCKS, tol=TOL, device="cuda"):
    """(iterations/s, n_iter, wall s per solve, set-up s, first solve s) of
    the warm fused solve; set-up is the spec, interface and solver, the
    first solve carries the process's one-time costs."""
    import parapint_tpu_torch as ptt

    t0 = time.perf_counter()
    banded = block_form() == "banded"
    iface = build_problem(nfe_x, nfe_t, n_blocks, block_form="banded" if banded else None,
                          device=device)
    options = ptt.IPOptions()
    options.tol = tol
    options.linalg.solver = make_solver(iface)
    solve = ptt.make_fused_ip_solve(iface, options)
    iface.set_bounds_relaxation_factor(options.bounds_relaxation_factor)
    state0 = iface.init_state()
    setup = time.perf_counter() - t0

    t0 = time.perf_counter()
    result = solve(state0)
    finish(result)
    first = time.perf_counter() - t0
    if result.status != ptt.InteriorPointStatus.optimal.value:
        raise RuntimeError(
            f"bench: status {result.status} after {result.iterations} iterations "
            f"(primal_inf {float(result.primal_inf)}, dual_inf {float(result.dual_inf)}, "
            f"compl_inf {float(result.compl_inf)})"
        )
    K = 3
    wall = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(K):
            result = solve(state0)
        finish(result)
        wall = min(wall, (time.perf_counter() - t0) / K)
    n_iter = result.iterations
    return max(1, n_iter - 1) / wall, n_iter, wall, setup, first


def baseline_kkt(nfe_x=NFE_X, nfe_t=NFE_T, n_blocks=N_BLOCKS):
    """The port's float64 block KKT at the initial state (barrier 0.1,
    regularization 1e-8 / 1e-8) on the CPU, as numpy arrays: ``diag``
    (N, nk, nk), ``border`` (N, L, nk), ``row_idx`` (N, L), ``ncv`` and
    ``rhs_blocks`` (N, nk)."""
    iface = build_problem(nfe_x, nfe_t, n_blocks, kkt_dtype=None, device="cpu")
    state = iface.init_state()
    iface._current_state = state
    data = iface.eval_kkt_data(state, 0.1)
    # light regularization so the unregularized zero pivots do not
    # penalize the baseline's SuperLU either
    kkt = iface.assemble_kkt(data, 1e-8, 1e-8)
    return dict(
        diag=kkt.diag.numpy(), border=kkt.border_loc.numpy(), row_idx=kkt.row_idx.numpy(),
        ncv=int(kkt.q.shape[0]), rhs_blocks=iface.kkt_rhs(data).blocks.numpy(),
    )


def _timed(fn, reps=4):
    """(best seconds of ``reps`` calls, the last output)."""
    best, out = float("inf"), None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return best, out


def measure_reference_baseline(kkt):
    """(baseline iterations/s, time per iteration, the assembled Schur
    complement) of the idealized reference path on ``kkt`` (module doc)."""
    import scipy.sparse as sps
    import scipy.sparse.linalg as spla

    diag, border, row_idx, ncv = kkt["diag"], kkt["border"], kkt["row_idx"], kkt["ncv"]
    block_times, lus = [], []
    sc = np.zeros((ncv, ncv))
    for i in range(diag.shape[0]):
        K = sps.csc_matrix(diag[i])

        def block_work():
            lu = spla.splu(K)
            # SC contribution: one back solve per nonzero border row
            # (reference explicit_schur_complement.py:108-122)
            cols = {}
            for l in range(border.shape[1]):
                r = row_idx[i, l]
                if r < ncv and np.any(border[i, l] != 0.0):
                    cols[r] = border[i] @ lu.solve(border[i, l])
            return lu, cols

        t, (lu, cols) = _timed(block_work)
        local = row_idx[i] < ncv
        for r, contrib in cols.items():
            sc[row_idx[i][local], r] -= contrib[local]
        block_times.append(t)
        lus.append(lu)

    sc_mat = sps.csc_matrix(sc + 1e-10 * np.eye(ncv))
    sc_factor_time, sc_lu = _timed(lambda: spla.splu(sc_mat))
    rhs0 = kkt["rhs_blocks"][0]
    # back-solve phase: 2 block solves + SC solve (reference :363-402)
    block_solve_time, _ = _timed(lambda: (lus[0].solve(rhs0), lus[0].solve(rhs0)))
    sc_solve_time, _ = _timed(lambda: sc_lu.solve(np.ones(ncv)))
    time_per_iter = max(block_times) + sc_factor_time + block_solve_time + sc_solve_time
    return 1.0 / time_per_iter, time_per_iter, sc


def _baseline_child(args) -> dict:
    """Run the baseline in a child process that sees no card."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "parapint_tpu_torch.tools.bench", "--baseline-only",
         "--nfe_x", str(args.nfe_x), "--nfe_t", str(args.nfe_t), "--blocks", str(args.blocks)],
        cwd=REPO, env=env, capture_output=True, text=True,
    )
    if out.returncode != 0:
        raise RuntimeError(f"bench: the baseline child exited {out.returncode}:\n{out.stderr[-3000:]}")
    return dict(json.loads(out.stdout.strip().splitlines()[-1]), wall_s=time.perf_counter() - t0)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--nfe_x", type=int, default=NFE_X)
    p.add_argument("--nfe_t", type=int, default=NFE_T)
    p.add_argument("--blocks", type=int, default=N_BLOCKS)
    p.add_argument("--baseline-only", action="store_true",
                   help="run only the scipy baseline on the CPU (the child's mode)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    sizes = (args.nfe_x, args.nfe_t, args.blocks)
    if args.baseline_only:
        t0 = time.perf_counter()
        kkt = baseline_kkt(*sizes)
        t1 = time.perf_counter()
        ips, titer, _ = measure_reference_baseline(kkt)
        result = {"baseline_ips": ips, "time_per_iter": titer, "kkt_s": t1 - t0,
                  "scipy_s": time.perf_counter() - t1,
                  "cuda_available": torch.cuda.is_available()}
        print(json.dumps(result))
        return result

    device = require_device(args.device)
    card = card_line(device)
    print(card, flush=True)
    ours_ips, n_iter, wall, setup, first = measure_ours(*sizes, device=device)
    base = _baseline_child(args)
    result = {
        "metric": f"ip_iterations_per_s_burgers_{args.blocks}blocks",
        "value": ours_ips,
        "unit": "iter/s",
        "vs_baseline": ours_ips / base["baseline_ips"],
        "detail": {
            "n_iter": n_iter,
            "wall_s": wall,
            "setup_s": setup,
            "first_solve_s": first,
            "block_form": block_form(),
            "baseline_time_per_iter_s": base["time_per_iter"],
            "baseline": f"idealized {args.blocks}-rank parapint KKT path (scipy SuperLU), "
                        "zero comm + zero eval cost",
            "baseline_saw_cuda": base["cuda_available"],
            # the child's wall: start-up, its float64 KKT and the scipy path
            "baseline_child_s": base["wall_s"],
            "backend": device.type,
            "device": card,
        },
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
