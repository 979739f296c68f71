"""The benchmark matrix of the port (counterpart of the JAX package's root
``bench_all.py``, with its twelve rows, names, sizes, interfaces and
solvers).

    python -m parapint_tpu_torch.tools.bench_all [filters...] [--device cuda|cpu]
        [--timeout 600]

Prints the card's line, then one JSON line with the launch floor, then one
JSON line per row, in the JAX tool's order:

  1. ``burgers_serial_4blocks``         Burgers (50, 16, 4), dense SC
  2. ``burgers_ssc_8blocks``            Burgers (50, 32, 8), dense SC
  3. ``stochastic_32scenarios``         the farmer family, 32 scenarios
  4. ``stochastic_qp_32scenarios_1k``   the two-stage QP, nk=1024 per scenario
  5. ``burgers_pcg_coupling_8blocks``   Burgers (50, 32, 8), matrix-free PCG coupling
  6. ``burgers_64blocks_cr``            the flagship, dense blocks, cyclic reduction
  7. ``burgers_64blocks_banded_cr``     the flagship, banded blocks (``bench.py``'s)
  8. ``burgers_256blocks_banded_cr``    Burgers (50, 512, 256), banded, cyclic reduction
  9. ``burgers_256blocks_cr``           the same NLP, dense blocks, cyclic reduction
 10. ``burgers_256blocks_dense_sc``     the same NLP, dense blocks, dense SC
 11. ``burgers_banded_nfex200_64blocks`` Burgers (200, 256, 64), banded (nk=3622)
 12. ``condensed_lsq_refscale_605k_vars_per_block`` the performance
     harness's csc at the reference's default scale, warm

Burgers rows: float32 KKT, tol 1e-8.  Solve rows are timed by
:func:`fused_iters_per_s`.  Positional arguments are substring filters on
the row names (a row runs when any filter is part of its name).

Each row runs in a child process of its own (``--row NAME``, in a new
process group) under ``--timeout`` seconds.  A row that raises or runs out
of time prints ``{"config": ..., "error": ...}``, its whole process group is
killed so that nothing keeps the card, and the matrix goes on.  The tool
exits non-zero when any row failed, after printing every line.
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import time

import torch

from parapint_tpu_torch.tools.bench import REPO, TOL, build_problem, finish
from parapint_tpu_torch.tools.kernel_lab import card_line
from parapint_tpu_torch.utils.device import require_device
from parapint_tpu_torch.utils.profile import dispatch_floor

TIMEOUT = 600  # seconds per row
CONDENSED = "condensed_lsq_refscale_605k_vars_per_block"
# the reference's default perf-harness scale (605,010 variables per block;
# reference examples/performance/schur_complement/main.py:63-73)
CONDENSED_SIZE = dict(n_blocks=3, n_q_per_block=5000, n_y_multiplier=120)


def fused_iters_per_s(interface, solver, tol=TOL):
    """(iterations/s, n_iter, wall, band_s): one solve, then warm solves.

    Rows whose single solve is under 1 s time 3 back-to-back solves per
    region; every row reports the best of 3 regions and the max-min band
    across them.  The clock is read after the card has finished."""
    import parapint_tpu_torch as ptt

    options = ptt.IPOptions()
    options.tol = tol
    options.linalg.solver = solver
    solve = ptt.make_fused_ip_solve(interface, options)
    interface.set_bounds_relaxation_factor(options.bounds_relaxation_factor)
    state0 = interface.init_state()
    result = solve(state0)
    if result.status != ptt.InteriorPointStatus.optimal.value:
        raise RuntimeError(f"status {result.status} after {result.iterations} iterations")
    t0 = time.perf_counter()
    result = solve(state0)
    finish(result)
    k = 3 if time.perf_counter() - t0 < 1.0 else 1
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(k):
            result = solve(state0)
        finish(result)
        walls.append((time.perf_counter() - t0) / k)
    wall = min(walls)
    return max(1, result.iterations - 1) / wall, result.iterations, wall, max(walls) - wall


def stochastic_32(device="cuda"):
    """The farmer family at 32 scenarios (the JAX tool's ``stochastic_32``)."""
    import parapint_tpu_torch as ptt
    from parapint_tpu_torch.examples import stochastic

    return ptt.StochasticSchurComplementInteriorPointInterface(
        stochastic.farmer_family(num_scenarios=32, device=device)
    )


def _fast(coupling=None):
    """W form, float32 factors, no refinement; ``coupling`` None is the
    dense SC."""
    import parapint_tpu_torch as ptt

    return ptt.SchurComplementSolver(
        block_size=128, explicit_inverse=True, factor_dtype=torch.float32, refine_steps=0,
        schur_complement_solver=coupling,
    )


def _banded_cr(nfe_x, nfe_t, n_blocks, device):
    import parapint_tpu_torch as ptt

    iface = build_problem(nfe_x, nfe_t, n_blocks, block_form="banded", device=device)
    return iface, ptt.BandedSchurComplementSolver(
        schur_complement_solver=ptt.BlockTridiagSolver(ns=iface.ns), tile_size=128
    )


def _row_factories():
    """name -> factory(device) -> (interface, solver), in the JAX order."""
    import parapint_tpu_torch as ptt
    from parapint_tpu_torch.examples import stochastic

    cr = ptt.BlockTridiagSolver
    return {
        "burgers_serial_4blocks": lambda d: (build_problem(50, 16, 4, device=d), _fast()),
        "burgers_ssc_8blocks": lambda d: (build_problem(50, 32, 8, device=d), _fast()),
        "stochastic_32scenarios": lambda d: (
            stochastic_32(d), ptt.SchurComplementSolver(block_size=64, explicit_inverse=True)
        ),
        # nk=1024 per scenario: the batched LDL^T at the production panel
        # shape, where the farmer's ~3-variable blocks measure dispatch
        # overhead.  Hybrid precision (float64 pivot sweep, float32
        # applies) with adaptive refinement: the QP's active bounds make
        # the barrier ill-conditioned, and an all-float32 sweep stalled the
        # JAX package's run at iteration 13
        "stochastic_qp_32scenarios_1k": lambda d: (
            ptt.StochasticSchurComplementInteriorPointInterface(
                stochastic.qp_spec(device=d), kkt_dtype=torch.float32
            ),
            ptt.SchurComplementSolver(block_size=128, explicit_inverse=True,
                                      factor_dtype=torch.float64, apply_dtype=torch.float32),
        ),
        "burgers_pcg_coupling_8blocks": lambda d: (
            build_problem(50, 32, 8, device=d),
            ptt.PCGSchurComplementSolver(block_size=128, factor_dtype=torch.float32),
        ),
        "burgers_64blocks_cr": lambda d: (build_problem(50, 256, 64, device=d), _fast(cr())),
        "burgers_64blocks_banded_cr": lambda d: _banded_cr(50, 256, 64, d),
        "burgers_256blocks_banded_cr": lambda d: _banded_cr(50, 512, 256, d),
        "burgers_256blocks_cr": lambda d: (build_problem(50, 512, 256, device=d), _fast(cr())),
        "burgers_256blocks_dense_sc": lambda d: (build_problem(50, 512, 256, device=d), _fast()),
        # the reference's scaling knob at a size where the dense block form
        # would hold 64 dense 3622-wide blocks for the diagonal and as many
        # for W; the banded form stores bands of width 84
        "burgers_banded_nfex200_64blocks": lambda d: (
            build_problem(200, 256, 64, block_form="banded", device=d),
            ptt.BandedSchurComplementSolver(schur_complement_solver=cr(), factor_dtype=torch.float32),
        ),
    }


ROWS = (*_row_factories(), CONDENSED)


def make_row(name, device="cuda"):
    """(interface, solver) of the solve row ``name`` on ``device``."""
    return _row_factories()[name](require_device(device))


def run_condensed(device="cuda") -> dict:
    """The condensed row: the harness's csc at the reference's scale, warm
    (numeric and back solve timed on their second call)."""
    from parapint_tpu_torch.examples.performance import schur_complement as perf

    r = perf.run(method="csc", **CONDENSED_SIZE, verbose=False, warm=True, device=device)
    return {
        "config": CONDENSED,
        "theta_max_err": r.max_err,
        "theta_recovered": bool(r.max_err < 1.0),
        "symbolic_s": r.symbolic_time,
        "warm_numeric_s": r.numeric_time,
        "warm_back_solve_s": r.back_solve_time,
        "status": r.status,
    }


def run_row(name, device="cuda") -> dict:
    """One row in this process: its JSON record."""
    device = require_device(device)
    if name == CONDENSED:
        record = run_condensed(device)
    else:
        interface, solver = make_row(name, device)
        ips, n_iter, wall, band = fused_iters_per_s(interface, solver)
        record = {"config": name, "ip_iterations_per_s": ips, "n_iter": n_iter, "wall_s": wall,
                  "band_s": band, "dispatch_floor_ms": dispatch_floor(device=device) * 1e3}
    record["device"] = card_line(device)
    return record


def _kill_group(proc) -> None:
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def run_row_child(name, device, timeout) -> dict:
    """``name`` in a child process in a new process group; on a timeout or
    a failure, an error record (the group killed either way)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
    proc = subprocess.Popen(
        [sys.executable, "-m", "parapint_tpu_torch.tools.bench_all", "--row", name,
         "--device", str(device)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True,
    )
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        _kill_group(proc)
        return {"config": name,
                "error": f"timed out after {timeout} s; process group {proc.pid} killed"}
    _kill_group(proc)
    lines = out.strip().splitlines()
    if proc.returncode != 0 or not lines:
        sys.stderr.write(err[-4000:])
        tail = (err.strip().splitlines() or ["no output"])[-1]
        return {"config": name, "error": f"exit {proc.returncode}: {tail}"[:200]}
    return json.loads(lines[-1])


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("filters", nargs="*", help="substrings of the row names to run")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--timeout", type=float, default=TIMEOUT, help="seconds per row")
    p.add_argument("--row", help="run this one row in this process (the child's mode)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = require_device(args.device)
    if args.row:
        print(json.dumps(run_row(args.row, device)), flush=True)
        return 0
    rows = [n for n in ROWS if not args.filters or any(f in n for f in args.filters)]
    print(card_line(device), flush=True)
    print(json.dumps({"dispatch_floor_ms": dispatch_floor(device=device) * 1e3}), flush=True)
    failed = 0
    for name in rows:
        record = run_row_child(name, device, args.timeout)
        failed += "error" in record
        print(json.dumps(record), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
