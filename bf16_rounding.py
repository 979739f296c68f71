"""How the bf16-W dense flagship depends on the last bit of the block
factors, on one CUDA card (or, with ``--device cpu``, on the CPU).

    python3 bf16_rounding.py [--seeds N] [--device cuda|cpu]

The bf16-W phase of ``chip_smoke.py`` (Burgers 50/256/64, float32 KKT, W
stored in bf16 for the back solves, adaptive refinement with the auto-gate,
cyclic-reduction coupling) either ends optimal or stops with status error,
depending on rounding.  This script shows where and how often:

1. trace: one solve as shipped.  Per numeric factorization, the smallest
   |pivot| and the largest |W| entry over the blocks; per linear solve, the
   refinement probe's residual over its threshold (sqrt(rn2 / thresh); the
   probe fails above 1) after the first solve and after every refinement
   pass, on the bf16 W and, after a gate fallback, on the full W.
2. ulp witness: N solves in which every nonzero entry of the panel kernel's
   outputs (LD, and W below its unit diagonal) is moved by -1, 0 or +1
   float32 ulp at random (seeded; N = 32 by default): a stand-in for another
   summation order or fused multiply-adds.  The same N perturbations on the
   f32-W dense flagship (``refine_steps=0``) as the control.  Each tally is
   held against the JAX package's under the same nudge
   (``chip_smoke.BF16_WITNESS_JAX``, from tests/test_torch_parity.py) by the
   exact one-sided Fisher test (``chip_smoke.fisher_greater``; ROADMAP C5's
   rule (c): a fault below p 0.05).
3. accurate-factor witness: one solve with the panel kernel replaced by its
   plain sweep run in float64 and rounded to float32.

Everything goes to standard output; exits non-zero without CUDA unless
``--device cpu`` is given, and non-zero when rule (c) fires.
"""

import argparse
import subprocess
import sys

import torch

import chip_smoke as cs


def _solve(iface, solver):
    """One fused solve from the initial point: (result, objective)."""
    import parapint_tpu_torch as ptt

    opts = ptt.IPOptions()
    opts.tol = cs.TOL
    opts.linalg.solver = solver
    solve = ptt.make_fused_ip_solve(iface, opts)
    iface.set_bounds_relaxation_factor(opts.bounds_relaxation_factor)
    result = solve(iface.init_state())
    iface._current_state = result.state
    return result, float(iface.evaluate_objective())


def _status(result):
    import parapint_tpu_torch as ptt

    return ptt.InteriorPointStatus(int(result.status)).name


def _traced_solve(iface, solver, panel_fn=None):
    """One solve with the probe and the block factors instrumented (and,
    with ``panel_fn``, the panel entry of the block factorization
    replaced): (result, objective, events)."""
    from parapint_tpu_torch.linalg import schur
    from parapint_tpu_torch.ops import ldl as ldl_ops

    it = [0]
    events = []
    eval_ad, probe, factor = iface.eval_ad, schur._refine_probe, schur._factor_blocks_winv
    panels = ldl_ops.ldl_panels_slab_winv

    def eval_ad_counted(*a, **k):
        it[0] += 1
        return eval_ad(*a, **k)

    def probe_traced(fact, rhs, x, trigger, group=None):
        rn2, thresh = schur._refine_residual(fact, rhs, x, trigger, group)
        events.append((it[0], "probe", solver.n_solves, solver.n_gate_fallbacks,
                       float(torch.sqrt(rn2 / thresh))))
        return probe(fact, rhs, x, trigger, group)

    def factor_traced(diag, mask, *a, **k):
        W, d, s, inertia, status = factor(diag, mask, *a, **k)
        m = mask.bool()
        events.append((it[0], "numeric", float(d[m].abs().min()), float(W[m].abs().amax()),
                       [int(v) for v in inertia]))
        return W, d, s, inertia, status

    iface.eval_ad = eval_ad_counted
    schur._refine_probe, schur._factor_blocks_winv = probe_traced, factor_traced
    ldl_ops.ldl_panels_slab_winv = panel_fn or panels
    try:
        result, obj = _solve(iface, solver)
    finally:
        del iface.eval_ad
        schur._refine_probe, schur._factor_blocks_winv = probe, factor
        ldl_ops.ldl_panels_slab_winv = panels
    return result, obj, events


def _print_events(events):
    for ev in events:
        if ev[1] == "numeric":
            print(f"  iteration {ev[0]} numeric: min|pivot| {ev[2]:.3e} max|W| {ev[3]:.3e} "
                  f"block inertia {ev[4]}")
        else:
            print(f"  iteration {ev[0]} back solve {ev[2]} (gate fallbacks so far {ev[3]}): "
                  f"probe residual / threshold {ev[4]:.3e}")


def _trace(iface):
    solver = cs._bf16_solver()
    result, obj, events = _traced_solve(iface, solver)
    print(f"trace: {_status(result)} in {result.iterations} iterations, objective {obj!r}, "
          f"{solver.n_gate_fallbacks} gate fallbacks, {solver.n_numeric} numerics")
    _print_events(events)


def _nudge(X, gen, unit_diag):
    """X with each nonzero entry moved by -1, 0 or +1 ulp (seeded); a unit
    diagonal stays exact."""
    r = torch.randint(-1, 2, X.shape, generator=gen, device=X.device)
    keep = (X == 0) | (r == 0)
    if unit_diag:
        keep |= torch.eye(X.shape[-1], dtype=torch.bool, device=X.device)
    moved = torch.nextafter(X, torch.where(r > 0, torch.inf, -torch.inf).to(X.dtype))
    return torch.where(keep, X, moved)


# the bf16-W flagship's solver and the f32-W control
WITNESS_SOLVERS = {"bf16 W": cs._bf16_solver, "f32 W": cs._dense_solver}


def witness(iface, seeds):
    """The ulp witness: per solver of ``WITNESS_SOLVERS`` and seed in
    ``range(seeds)``, one fused solve with the panel kernel's outputs
    nudged (``_nudge``, a generator seeded with the seed): {label: [(status
    name, iterations, gate fallbacks)]}."""
    from parapint_tpu_torch.ops.ldl_panel import ldl_panels_slab_winv

    tally = {label: [] for label in WITNESS_SOLVERS}
    for seed in range(seeds):
        for label, make in WITNESS_SOLVERS.items():
            gen = torch.Generator(device=iface.device).manual_seed(seed)

            def nudged(A):
                LD, W = ldl_panels_slab_winv(A)
                return _nudge(LD, gen, False), _nudge(W, gen, True)

            solver = make()
            result, obj, events = _traced_solve(iface, solver, nudged)
            status = _status(result)
            tally[label].append((status, result.iterations, getattr(solver, "n_gate_fallbacks", 0)))
            print(f"ulp witness seed {seed} {label}: {status} in {result.iterations} "
                  f"iterations, objective {obj!r}, gate fallbacks "
                  f"{getattr(solver, 'n_gate_fallbacks', 0)}")
            if status != "optimal":  # the last iteration's events
                _print_events([ev for ev in events if ev[0] == events[-1][0]])
    return tally


def witness_faults(tally):
    """Rule (c) of ROADMAP C5 on a ``witness`` tally against the JAX
    package's (``chip_smoke.BF16_WITNESS_JAX``): the labels whose share of
    solves stopping with another status than optimal is significantly
    above the JAX package's."""
    faults = []
    for label, runs in tally.items():
        bad = sum(st != "optimal" for st, *_ in runs)
        ref = cs.BF16_WITNESS_JAX[label]
        ref_bad, ref_n = sum(st != "optimal" for st, _ in ref), len(ref)
        p = cs.fisher_greater(bad, len(runs), ref_bad, ref_n)
        print(f"ulp witness {label}: {len(runs) - bad} of {len(runs)} optimal; JAX package "
              f"{ref_n - ref_bad} of {ref_n}; one-sided Fisher p {p:.4f}"
              f"{' (rule (c): a fault)' if p < cs.LEAN_P else ''}")
        if p < cs.LEAN_P:
            faults.append(label)
    return faults


def _accurate(iface):
    from parapint_tpu_torch.ops.ldl_panel import ldl_panels_slab_winv_plain

    def accurate(A):
        return tuple(t.float() for t in ldl_panels_slab_winv_plain(A.double()))

    solver = cs._bf16_solver()
    result, obj, events = _traced_solve(iface, solver, accurate)
    print(f"accurate-factor witness bf16 W: {_status(result)} in {result.iterations} "
          f"iterations, objective {obj!r}, gate fallbacks {solver.n_gate_fallbacks}")
    _print_events(events)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=32)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args()
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("bf16_rounding: CUDA is not available", file=sys.stderr)
            sys.exit(1)
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0])
    iface = cs._dense_iface(args.device)
    _trace(iface)
    faults = witness_faults(witness(iface, args.seeds))
    _accurate(iface)
    if faults:
        sys.exit(f"bf16_rounding: rule (c) fires for {faults}")


if __name__ == "__main__":
    main()
