"""Step-by-step parity of the port with the JAX package on the paths whose
iteration counts the card and the JAX package's CPU run disagreed on
(ROADMAP C13/C14): the W-form ``SchurComplementSolver`` with float32
factors and no refinement over the dense SC (bench_all rows 2 and 10) and
over cyclic reduction (row 9), the PCG coupling solver (row 5) and the
dense flagship as two kinds (``HeterogeneousDynamicInterface``).

The comparison uses only what both packages already have: ``ip_solve``'s
log table and inertia-correction lines (``logging``), and the public pieces
its loop is made of (``convergence_info``, ``eval_kkt_data``,
``numeric_factorization``, ``solve_with_status``, ``extract_deltas``,
``fraction_to_the_boundary``, ``apply_step``).

- ``jax_trace`` runs the JAX package's ``ip_solve`` loop from those pieces
  and keeps every iterate; ``port_step`` takes one port step from a JAX
  iterate carried over with ``convert.ipstate_from_numpy`` (teacher
  forcing), and ``compare_step`` holds the two steps to the bars below.
- ``chip_smoke.ulp_perturbations`` makes the one-ulp perturbations of the
  initial primal point from which both packages' count distributions are
  drawn (``fused_counts``); the card runs the same points.

Bars of the teacher-forced step (``BARS``): the discrete decisions equal
(the barrier update, each inertia-correction retry with its coefficient
and inertia, the coefficient used, the KKT inertia, the back solve's
status, gate fallbacks and CG iterations); the convergence numbers of the
shared iterate within 1e-10 of max(1, |JAX|) (float64 in both packages);
each family of the step direction within 1e-4 relative to its largest
entry (float32 factors); alpha_primal and alpha_dual within 1e-6
relative; the directions from the same KKT factored in float64 within
1e-10 where the two KKT systems are bitwise equal.

What is a fault of the port (``compare_step``, ``verdict``): a decision
that differs where the JAX package's own float32 and float64
factorizations of that KKT have the same inertia; convergence numbers or
float64-factored directions outside their bars; and, over a whole run,
the port's float32 directions farther from the float64-factored one than
the JAX package's at significantly more steps (``chip_smoke.sign_test``,
p < ``chip_smoke.LEAN_P``).  A single float32 step outside 1e-4 is
reported (``first_fail``) but is no fault alone: the JAX package's own
float32 direction lies 1e-5 to 1 from its float64 one at the full-size
rows.  The counts are flagged, not judged: the port's count from the
initial point outside the JAX ensemble's set, and the port's counts from
the same points leaning against the JAX package's (the same test).
``panel_order.py`` showed on the card that reordering the float32 panel
arithmetic alone trips both flags on some configuration, the JAX
package's own order and the float64-accurate panels included (PERF.md
§6, ROADMAP C13-C15).

Tier-1 cases run at the ``entry()`` shape (nfe_x=8, nfe_t=8, 4 blocks);
the full-size rows are marked ``slow`` (run them with ``-m slow -s``; each
prints one JSON line of counts, ensembles and the first failing step).
"""

import contextlib
import dataclasses
import hashlib
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parapint_tpu as pt
import parapint_tpu_torch as ptt
from parapint_tpu.algorithms.interior_point import numeric_factorization as j_numeric_factorization
from parapint_tpu.examples import burgers as jburgers
from parapint_tpu.interfaces.heterogeneous import HeterogeneousDynamicInterface as JHet
from parapint_tpu.interfaces.heterogeneous import KindSpec as JKind
from parapint_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint
from parapint_tpu_torch.algorithms.interior_point import numeric_factorization
from parapint_tpu_torch.convert import ipstate_from_numpy, ipstate_to_numpy
from parapint_tpu_torch.examples import burgers
from parapint_tpu_torch.interfaces.base import STATE_FIELDS
from parapint_tpu_torch.utils.checkpoint import save_checkpoint

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
import panel_order  # noqa: E402
from chip_smoke import captured_log, sign_test  # noqa: E402
from test_torch_pcg_schur import jax_cg_iterations  # noqa: E402

TOL = 1e-8
ENTRY = dict(nfe_x=8, nfe_t=8, num_time_blocks=4)
JAX_LOGGER = "parapint_tpu.algorithms.interior_point"
PORT_LOGGER = "parapint_tpu_torch.algorithms.interior_point"
BARS = dict(conv=1e-10, direction=1e-4, alpha=1e-6, f64=1e-10)
DECISIONS = ("converged", "barrier", "retries", "coef_used", "inertia", "solve_status",
             "gate_fallbacks", "cg")


# -- the configurations ---------------------------------------------------------------------

def _fast(pkg, fdt, coupling):
    """bench_all's W form: float32 factors, no refinement; ``coupling`` "cr"
    (cyclic reduction) or "dense" (the dense SC through DenseLDLSolver)."""
    return pkg.SchurComplementSolver(
        block_size=128, explicit_inverse=True, factor_dtype=fdt, refine_steps=0,
        schur_complement_solver=pkg.BlockTridiagSolver() if coupling == "cr" else None,
    )


SOLVERS = {
    "dense_sc": lambda pkg, fdt: _fast(pkg, fdt, "dense"),
    "cr": lambda pkg, fdt: _fast(pkg, fdt, "cr"),
    "pcg": lambda pkg, fdt: pkg.PCGSchurComplementSolver(block_size=128, factor_dtype=fdt),
    "two_kinds": lambda pkg, fdt: _fast(pkg, fdt, "cr"),
}
# configuration -> (solver key, full-size shape); rows of tools/bench_all.py
FULL = {
    "burgers_ssc_8blocks": ("dense_sc", dict(nfe_x=50, nfe_t=32, num_time_blocks=8)),
    "burgers_256blocks_cr": ("cr", dict(nfe_x=50, nfe_t=512, num_time_blocks=256)),
    "burgers_pcg_coupling_8blocks": ("pcg", dict(nfe_x=50, nfe_t=32, num_time_blocks=8)),
    "burgers_two_kinds": ("two_kinds", chip_smoke.FLAGSHIP),
    "burgers_256blocks_dense_sc": ("dense_sc", dict(nfe_x=50, nfe_t=512, num_time_blocks=256)),
}


def jax_two_kinds(spec, kkt_dtype=None):
    """``chip_smoke.burgers_two_kinds`` in the JAX package: block 0 keeps
    every equality row, the other blocks lack the initial-condition rows
    that the uniform spec masks out there."""
    keep = np.nonzero(np.asarray(spec.eq_mask[1]))[0]
    t0 = np.asarray(spec.params["t0"])
    kw = dict(objective=spec.objective, n_x=spec.n_x, xl=spec.xl[0], xu=spec.xu[0],
              start_state_idx=spec.start_state_idx, end_state_idx=spec.end_state_idx,
              example_params={"t0": t0[0]})
    kinds = [JKind(eq_constraints=spec.eq_constraints, **kw),
             JKind(eq_constraints=lambda x, p: spec.eq_constraints(x, p)[keep], **kw)]
    N = spec.num_blocks
    return JHet(kinds, [0] + [1] * (N - 1), [{"t0": t0[b]} for b in range(N)],
                [np.asarray(spec.x0[b]) for b in range(N)], kkt_dtype=kkt_dtype)


def jax_config(key, shape):
    """(interface, solver) of the JAX package on the CPU."""
    spec = jburgers.build_spec(**shape)
    if key == "two_kinds":
        iface = jax_two_kinds(spec, kkt_dtype=jnp.float32)
    else:
        iface = pt.DynamicSchurComplementInteriorPointInterface(spec, kkt_dtype=jnp.float32)
    return iface, SOLVERS[key](pt, jnp.float32)


def port_config(key, shape, device="cpu"):
    """(interface, solver) of the port on ``device``."""
    spec = burgers.build_spec(**shape, device=device)
    if key == "two_kinds":
        iface = chip_smoke.burgers_two_kinds(spec, kkt_dtype=torch.float32)
    else:
        iface = ptt.DynamicSchurComplementInteriorPointInterface(spec, kkt_dtype=torch.float32)
    return iface, SOLVERS[key](ptt, torch.float32)


def _options(pkg, solver):
    opts = pkg.IPOptions()
    opts.tol = TOL
    opts.linalg.solver = solver
    return opts


# -- the log table ---------------------------------------------------------------------------

TABLE_KEYS = ("objective", "primal_inf", "dual_inf", "compl_inf", "barrier", "alpha_primal",
              "alpha_dual", "alpha", "reg")


def parse_log_table(lines):
    """``ip_solve``'s log (either package) as {"iterations": [row], "inertia":
    [[retry]]}: a row per convergence check (its iteration and the nine
    numbers of the table, the time column dropped), and per call of
    ``numeric_factorization`` its lines (retry, coefficient, pos, neg,
    zero, status; None where the factorization failed)."""
    out = {"iterations": [], "inertia": []}
    for line in lines:
        f = line.split()
        if not f:
            continue
        if f[0] == "reg_iter":
            out["inertia"].append([])
        elif f[0] == "Iter":
            continue
        elif len(f) == 11 and _is_int(f[0]):
            row = dict(zip(TABLE_KEYS, map(float, f[1:10])))
            out["iterations"].append(dict(iter=int(f[0]), **row))
        elif len(f) == 6 and _is_int(f[0]) and out["inertia"]:
            vals = [None if v == "None" else int(v) for v in f[2:5]]
            out["inertia"][-1].append((int(f[0]), float(f[1]), *vals, int(f[5])))
    return out


def _is_int(s):
    return s.lstrip("-").isdigit()


# -- the JAX reference loop and the teacher-forced port step ---------------------------------

def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _conv(info):
    return [float(info.primal_inf), float(info.dual_inf), float(info.compl_inf_0),
            float(info.compl_inf_mu)]


def _next_barrier(opts, mu, conv):
    """``ip_solve``'s monotone barrier rule (both packages)."""
    if max(conv[0], conv[1], conv[3]) <= opts.barrier_decrease * mu:
        return max(opts.minimum_barrier_parameter, min(0.5 * mu, mu**1.5))
    return mu


def _retries(lines):
    return [r for block in parse_log_table(lines)["inertia"] for r in block]


def jax_trace(iface, opts, f64_solver=None, max_steps=None):
    """The JAX package's ``ip_solve`` loop (interior_point.py:298-431, line
    search disabled, monotone barrier) from its public pieces, keeping
    every iterate: (records, final iterate, iterations, optimal).  A record
    holds the iterate k (numpy), the barrier before and after the update,
    the inertia coefficient handed to ``numeric_factorization``, and what
    the step decided and computed; with ``f64_solver`` (the same solver
    factoring in float64) also the inertia of the step's first KKT
    factored in float64 and, where the step needed no inertia correction,
    the direction from it: the float32 factors' own distance from these is
    the reach of their rounding."""
    solver = opts.linalg.solver
    iface.set_bounds_relaxation_factor(opts.bounds_relaxation_factor)
    ic = opts.inertia_correction
    mu, coef = opts.init_barrier_parameter, ic.init_coef
    state = iface.init_state()
    records = []
    for k in range(opts.max_iter if max_steps is None else max_steps):
        conv = _conv(iface.convergence_info(state, mu, opts.error_scaling))
        if max(conv[:3]) <= opts.tol:
            return records, _np_tree(state), k + 1, True
        mu_in, mu = mu, _next_barrier(opts, mu, conv)
        data = iface.eval_kkt_data(state, mu)
        if k == 0:
            solver.symbolic(iface.assemble_kkt(data, 0.0, 0.0))
        with captured_log(JAX_LOGGER) as lines:
            fact, used = j_numeric_factorization(iface, data, opts, coef)
        rhs = iface.kkt_rhs(data)
        sol, status = solver.solve_with_status(fact, rhs)
        cg = jax_cg_iterations(solver, fact, rhs) if hasattr(solver, "cg_tol") else None
        deltas = iface.extract_deltas(state, sol, mu)
        a_p, a_d = iface.fraction_to_the_boundary(state, deltas, 1.0 - mu)
        deltas64 = alpha64 = inertia64 = None
        kkt = iface.assemble_kkt(data, 0.0, 0.0)
        kkt_digest = _digest(kkt.diag, rhs.blocks)
        if f64_solver is not None:
            if k == 0:
                f64_solver.symbolic(kkt)
            fact64 = f64_solver.numeric(kkt)
            inertia64 = tuple(int(v) for v in f64_solver.inertia(fact64))
        if f64_solver is not None and float(used) == 0.0:
            sol64, _ = f64_solver.solve_with_status(fact64, rhs)
            d64 = iface.extract_deltas(state, sol64, mu)
            deltas64 = _np_tree(d64)
            alpha64 = tuple(float(a) for a in iface.fraction_to_the_boundary(state, d64, 1.0 - mu))
        records.append(dict(
            k=k, state=_np_tree(state), conv=conv, converged=False, mu_in=mu_in, barrier=mu,
            coef=coef, retries=_retries(lines), coef_used=float(used),
            inertia=tuple(int(v) for v in solver.inertia(fact)), solve_status=int(status),
            # these configurations refine no solve (refine_steps=0 or PCG),
            # so the JAX solver has no gate to fall back from
            gate_fallbacks=0, cg=cg, deltas=_np_tree(deltas), alpha_primal=float(a_p),
            alpha_dual=float(a_d), deltas64=deltas64, alpha64=alpha64, inertia64=inertia64,
            kkt_digest=kkt_digest,
        ))
        coef = max(ic.init_coef, float(used) * ic.factor_decrease)
        state = iface.apply_step(state, deltas, float(a_p), float(a_d), 1.0)
    return records, _np_tree(state), len(records), False


def _digest(*arrays):
    """SHA-256 of the arrays' bytes (either package's): equal digests, a
    bitwise-equal KKT block diagonal and right-hand side."""
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a.cpu() if torch.is_tensor(a) else a).tobytes())
    return h.hexdigest()


def port_converged(iface, opts, state_np, mu):
    """Whether the port's convergence check at the JAX iterate ``state_np``
    ends the solve (``ip_solve``'s test, at barrier ``mu``)."""
    conv = _conv(iface.convergence_info(ipstate_from_numpy(state_np, iface.device), mu,
                                        opts.error_scaling))
    return max(conv[:3]) <= opts.tol


def port_step(iface, opts, rec, first, f64_solver=None):
    """One port step from the JAX iterate of ``rec`` with its barrier and
    inertia coefficient: the record's quantities as the port computes
    them; with ``f64_solver``, where the record has its float64-factored
    direction, the port's from the same first KKT too."""
    solver = opts.linalg.solver
    if first:
        iface.set_bounds_relaxation_factor(opts.bounds_relaxation_factor)
    state = ipstate_from_numpy(rec["state"], iface.device)
    conv = _conv(iface.convergence_info(state, rec["mu_in"], opts.error_scaling))
    mu = rec["barrier"]
    data = iface.eval_kkt_data(state, mu)
    if first:
        solver.symbolic(iface.assemble_kkt(data, 0.0, 0.0))
    fallbacks = getattr(solver, "n_gate_fallbacks", 0)
    with captured_log(PORT_LOGGER) as lines:
        fact, used = numeric_factorization(iface, data, opts, rec["coef"])
    sol, status = solver.solve_with_status(fact, iface.kkt_rhs(data))
    deltas = iface.extract_deltas(state, sol, mu)
    a_p, a_d = iface.fraction_to_the_boundary(state, deltas, 1.0 - mu)
    kkt, rhs = iface.assemble_kkt(data, 0.0, 0.0), iface.kkt_rhs(data)
    deltas64 = None
    if f64_solver is not None and first:
        f64_solver.symbolic(kkt)
    if f64_solver is not None and rec.get("deltas64") is not None:
        sol64, _ = f64_solver.solve_with_status(f64_solver.numeric(kkt), rhs)
        deltas64 = ipstate_to_numpy(iface.extract_deltas(state, sol64, mu))
    return dict(
        k=rec["k"], conv=conv, converged=max(conv[:3]) <= opts.tol,
        barrier=_next_barrier(opts, rec["mu_in"], conv),
        retries=_retries(lines), coef_used=float(used),
        inertia=tuple(int(v) for v in solver.inertia(fact)), solve_status=int(status),
        gate_fallbacks=getattr(solver, "n_gate_fallbacks", 0) - fallbacks,
        cg=solver.cg_iterations[-1] if hasattr(solver, "cg_iterations") else None,
        deltas=ipstate_to_numpy(deltas), alpha_primal=float(a_p), alpha_dual=float(a_d),
        deltas64=deltas64, kkt_digest=_digest(kkt.diag, rhs.blocks),
    )


def _leaves(tree):
    out = {}
    for f in STATE_FIELDS:
        v = tree[f] if isinstance(tree, dict) else getattr(tree, f)
        for key, a in (v.items() if isinstance(v, dict) else [("", v)]):
            out[f"{f}.{key}" if key else f] = np.asarray(a, dtype=np.float64)
    return out


def _rel(a, b, floor=1e-300):
    return abs(a - b) / max(abs(b), floor)


def direction_gap(a, ref):
    """The largest, over the state's families, of max|a - ref| / max|ref|
    (families of ``ref`` that are empty or zero left out)."""
    a, ref = _leaves(a), _leaves(ref)
    return max((float(np.abs(a[k] - ref[k]).max() / np.abs(ref[k]).max()) for k in ref
                if ref[k].size and np.abs(ref[k]).max() > 0), default=0.0)


def compare_step(jrec, prec):
    """(errors, fail, fault) of one teacher-forced step: ``fail`` names the
    first quantity outside the bars of ``BARS`` (a decision that differs
    included), ``fault`` the first that rounding cannot explain (None:
    none).  ``direction`` is the port's gap to the JAX direction and
    ``alpha`` to the JAX step sizes; where the JAX record has the
    float64-factored direction, ``jax_f64``/``port_f64`` are the two
    float32 directions' gaps to it (``verdict`` holds them against each
    other over the run) and ``jax_alpha64``/``port_alpha64`` their step
    sizes' gaps to its.  Where both packages assembled a bitwise-equal KKT
    block diagonal and right-hand side, their float64-factored directions
    (``f64``) must agree within 1e-10.  A different inertia-correction
    decision (retries, coefficient) is a fault unless the JAX package's own
    float32 factorization of that KKT has another inertia than its float64
    one: there rounding decides the first factorization's inertia.  Every
    quantity is compared in every case."""
    errs = {"conv": max(_rel(a, b, 1.0) for a, b in zip(prec["conv"], jrec["conv"]))}
    errs["direction"] = direction_gap(prec["deltas"], jrec["deltas"])
    alphas = ("alpha_primal", "alpha_dual")
    errs["alpha"] = max(_rel(prec[a], jrec[a]) for a in alphas)
    if prec.get("deltas64") is not None:
        errs["f64"] = direction_gap(prec["deltas64"], jrec["deltas64"])
    if jrec.get("deltas64") is not None:
        errs["jax_f64"] = direction_gap(jrec["deltas"], jrec["deltas64"])
        errs["port_f64"] = direction_gap(prec["deltas"], jrec["deltas64"])
        errs["jax_alpha64"] = max(_rel(jrec[a], jrec["alpha64"][i]) for i, a in enumerate(alphas))
        errs["port_alpha64"] = max(_rel(prec[a], jrec["alpha64"][i]) for i, a in enumerate(alphas))
    fail = fault = None
    for name in DECISIONS:
        if name == "cg" and jrec["cg"] is None:
            continue
        if name == "retries":
            p, j = prec[name], jrec[name]
            same = [r[:1] + r[2:] for r in p] == [r[:1] + r[2:] for r in j] and all(
                _rel(a[1], b[1]) <= 1e-12 for a, b in zip(p, j))
        else:
            same = prec[name] == jrec[name]
        if not same:
            msg = f"{name}: port {prec[name]!r}, JAX {jrec[name]!r}"
            fail = fail or msg
            rounding = (name in ("retries", "coef_used") and jrec.get("inertia64") is not None
                        and tuple(jrec["retries"][0][2:5]) != jrec["inertia64"])
            if not rounding:
                fault = fault or msg
    if jrec.get("kkt_digest") == prec["kkt_digest"] and not errs.get("f64", 0.0) <= BARS["f64"]:
        msg = f"f64: {errs['f64']:.3e} > {BARS['f64']:.0e} on a bitwise-equal KKT"
        fail, fault = fail or msg, fault or msg
    for name in ("conv", "direction", "alpha"):
        if not errs[name] <= BARS[name]:
            fail = fail or f"{name}: {errs[name]:.3e} > {BARS[name]:.0e}"
            if name == "conv":
                fault = fault or fail
    return errs, fail, fault


def accuracy_lean(rows):
    """``sign_test`` of the port's float32 directions' gaps to the
    float64-factored one against the JAX package's, over the steps of
    ``teacher_forced`` that have both: (steps where the port's is farther,
    nearer, p)."""
    both = [r for r in rows if r.get("jax_f64") is not None and r.get("port_f64") is not None]
    return sign_test([r["jax_f64"] for r in both], [r["port_f64"] for r in both])


def verdict(res):
    """A ``compare_config`` result read by this file's rule: {"faults":
    the first teacher-forced step fault and a lean of the port's float32
    directions away from the float64 one; "count_flags": the port's count
    from the initial point outside the JAX ensemble's set, and a lean of
    the port's counts against the JAX package's from the same points (the
    fused solves'; row 10's JAX ones from its ``ip_solve``)}, each a list
    of strings (empty: none).  A lean is ``chip_smoke.sign_test`` at p <
    ``chip_smoke.LEAN_P``."""
    faults, flags = [], []
    if res["first_fault"] is not None:
        faults.append(f"step {res['first_fault'][0]}: {res['first_fault'][1]}")
    up, down, p = res["accuracy_lean"]
    if up > down and p < chip_smoke.LEAN_P:
        faults.append(f"float32 directions farther from float64 than JAX's at {up} of {up + down} "
                      f"steps (p {p:.4f})")
    jax_counts = [n for _, n, *_ in res.get("jax_fused") or res["jax_ip"]]
    port_counts = [n for _, n, *_ in res["port_fused"]]
    if port_counts[0] not in jax_counts:
        flags.append(f"count {port_counts[0]} outside the JAX set {sorted(set(jax_counts))}")
    up, down, p = res["count_lean"]
    if p < chip_smoke.LEAN_P:
        flags.append(f"counts lean: port above JAX at {up} points, below at {down} (p {p:.4f})")
    return dict(faults=faults, count_flags=flags)


def teacher_forced(records, final, iface, solver, f64_solver=None):
    """Every JAX record's step taken by the port (``iface`` and ``solver``,
    with ``f64_solver`` the same solver factoring in float64, where the
    records have float64-factored directions) from the JAX
    iterate, and the port's convergence check at the JAX final iterate
    ``final``: (per-k errors, first fail, first fault), each (k, quantity)
    or None (see ``compare_step``; ``f64`` is the gap between the two
    packages' float64-factored directions, which shows the same function
    computed apart from float32 rounding, and ``kkt_equal`` whether the two
    KKT block diagonals and right-hand sides were bitwise equal)."""
    opts = _options(ptt, solver)
    rows, first_fail, first_fault = [], None, None
    for i, rec in enumerate(records):
        prec = port_step(iface, opts, rec, first=i == 0, f64_solver=f64_solver)
        errs, fail, fault = compare_step(rec, prec)
        rows.append(dict(k=rec["k"], **{n: float(f"{v:.3e}") for n, v in errs.items()},
                         kkt_equal=rec.get("kkt_digest") == prec["kkt_digest"],
                         inertia=prec["inertia"], retries=len(prec["retries"]), cg=prec["cg"],
                         alphas=(prec["alpha_primal"], prec["alpha_dual"]),
                         first_inertia=prec["retries"][0][2:5],
                         jax_first_inertia=rec["retries"][0][2:5],
                         inertia64=rec.get("inertia64"), fail=fail, fault=fault))
        if fail is not None and first_fail is None:
            first_fail = (rec["k"], fail)
        if fault is not None and first_fault is None:
            first_fault = (rec["k"], fault)
    if records and not port_converged(iface, opts, final, records[-1]["barrier"]):
        first_fail = first_fail or (len(records), "converged: port False, JAX True")
        first_fault = first_fault or first_fail
    return rows, first_fail, first_fault


# -- the two drivers' counts and the perturbation ensembles ----------------------------------

def ip_solve_run(pkg, iface, opts, primals=None):
    """(status name, iterations, objective, log lines) of ``pkg``'s (``pt``
    or ``ptt``) ``ip_solve``; with ``primals``, from ``start_state``
    through a checkpoint at iteration 0 (``resume_from``)."""
    logger, save = (JAX_LOGGER, j_save_checkpoint) if pkg is pt else (PORT_LOGGER, save_checkpoint)
    with contextlib.ExitStack() as stack:
        lines = stack.enter_context(captured_log(logger))
        kw = {}
        if primals is not None:
            d = stack.enter_context(tempfile.TemporaryDirectory())
            kw["resume_from"] = os.path.join(d, "state0.npz")
            save(kw["resume_from"], start_state(pkg, iface, primals), opts.init_barrier_parameter,
                 opts.inertia_correction.init_coef, 0)
        status = pkg.ip_solve(iface, opts, **kw)
    n = len(parse_log_table(lines)["iterations"])
    return status.name, n, float(iface.evaluate_objective()), lines


def start_state(pkg, iface, primals=None):
    """``iface.init_state()`` of package ``pkg`` with ``primals`` (a dict
    of numpy arrays; None: unchanged) in place of its primals."""
    s0 = iface.init_state()
    if primals is None:
        return s0
    if pkg is pt:
        leaf = jnp.asarray
    else:
        leaf = lambda a: torch.as_tensor(np.array(a), dtype=torch.float64, device=iface.device)  # noqa: E731
    return dataclasses.replace(s0, primals={k: leaf(v) for k, v in primals.items()})


def fused_counts(pkg, iface, opts, primal_points):
    """(status, iterations) of ``pkg``'s fused solve from the initial
    iterate with each of ``primal_points`` (dicts of numpy primals; None:
    unperturbed) in its place, one ``make_fused_ip_solve`` for all."""
    iface.set_bounds_relaxation_factor(opts.bounds_relaxation_factor)
    solve = pkg.make_fused_ip_solve(iface, opts)
    out = []
    for p in primal_points:
        res = solve(start_state(pkg, iface, p))
        out.append((int(res.status), int(res.iterations)))
    return out


def initial_primals(iface):
    """The initial primal point of either package's interface as numpy."""
    p = iface.init_state().primals
    return {k: np.asarray(v.cpu() if torch.is_tensor(v) else v) for k, v in p.items()}


def run_options(name):
    """How ``compare_config`` runs a configuration of ``FULL`` at full size:
    the perturbations from ``chip_smoke.PARITY`` (8 on the 256-block rows,
    for the CPU's time), the JAX fused solve except on row 10 (XLA's CPU
    compile of it does not finish: the JAX ensemble comes from its
    ``ip_solve``), and the ``ip_solve`` ensembles only on the 8-block rows
    (the others run ``ip_solve`` from the initial point alone)."""
    return dict(n_ensemble=chip_smoke.PARITY[name][0],
                jax_fused=name != "burgers_256blocks_dense_sc",
                ip_ensemble=FULL[name][1]["num_time_blocks"] == 8)


def compare_config(name, n_ensemble, jax_fused, ip_ensemble, shape=None, say=print):
    """The whole comparison of one configuration of ``FULL`` (at ``shape``,
    default its full size; the other options from ``run_options``) on the
    CPU, as a dict: the JAX package's and
    the port's iterations through both drivers; the teacher-forced steps,
    the first that fails its bar and the first fault, and the sign test of
    the port's float32 directions' accuracy against the JAX package's
    (``accuracy_lean``); the same steps with the port's block panels in the
    JAX package's summation order (``panel_order.panel_order("jax")``:
    "forced_jax_order", the direction gaps per step and their sign test),
    which shows how much of the gap to the JAX step is the panels' order;
    the count distributions of both packages' fused
    solves (and, with ``ip_ensemble``, of their ``ip_solve``) from the
    unperturbed point and ``n_ensemble`` one-ulp perturbations of it, and
    the sign test of the port's fused counts against the JAX package's
    (``count_lean``).  ``jax_fused=False`` leaves out the JAX fused solve
    and draws the JAX ensemble from its ``ip_solve`` instead.
    ``verdict`` reads the result."""
    key, full = FULL[name]
    shape = full if shape is None else shape
    res = {"config": name, "shape": shape, "ensemble": n_ensemble, "seed": chip_smoke.ENSEMBLE_SEED}
    t0 = time.perf_counter()

    def lap(what):
        shown = {k: v for k, v in res.items() if not k.endswith("_table")}
        say(f"{name}: {what} at {time.perf_counter() - t0:.1f} s: {json.dumps(shown)}", flush=True)

    ji, js = jax_config(key, shape)
    jopts = _options(pt, js)
    res["init_digest"] = chip_smoke.primal_digest(initial_primals(ji))
    records, final, n, ok = jax_trace(ji, jopts, f64_solver=SOLVERS[key](pt, jnp.float64))
    res["jax_trace"] = (ok, n)
    lap("JAX trace")
    res["forced"], res["first_fail"], res["first_fault"] = teacher_forced(
        records, final, *port_config(key, shape), SOLVERS[key](ptt, torch.float64))
    res["accuracy_lean"] = accuracy_lean(res["forced"])
    with panel_order.panel_order("jax"):
        rows, _, _ = teacher_forced(records, final, *port_config(key, shape),
                                    SOLVERS[key](ptt, torch.float64))
    res["forced_jax_order"] = dict(
        rows=[{k: r.get(k) for k in ("k", "direction", "port_f64", "fail", "fault")} for r in rows],
        accuracy_lean=accuracy_lean(rows))
    del records
    lap("teacher-forced steps")
    points = [None] + chip_smoke.ulp_perturbations(initial_primals(ji), n_ensemble)
    ens = points if ip_ensemble else points[:1]
    res["jax_ip"] = []
    for p in ens if jax_fused else points:
        *r, lines = ip_solve_run(pt, ji, jopts, p)
        res["jax_ip"].append(r)
        if p is None:
            res["jax_ip_table"] = lines
        if not jax_fused:
            lap(f"JAX ip_solve point {len(res['jax_ip']) - 1}")
    lap("JAX ip_solve")
    if jax_fused:
        res["jax_fused"] = fused_counts(pt, ji, jopts, points)
        lap("JAX fused")
    del ji, js, jopts
    pi, ps = port_config(key, shape)
    popts = _options(ptt, ps)
    res["port_ip"] = []
    for p in ens:
        *r, lines = ip_solve_run(ptt, pi, popts, p)
        res["port_ip"].append(r)
        if p is None:
            res["port_ip_table"] = lines
    lap("port ip_solve")
    res["port_fused"] = fused_counts(ptt, pi, popts, points)
    res["count_lean"] = sign_test([n for _, n, *_ in res.get("jax_fused") or res["jax_ip"]],
                                  [n for _, n in res["port_fused"]])
    lap("port fused")
    return res


# -- tier 1: the entry() shape ----------------------------------------------------------------

def test_parse_log_table():
    """The parser reads both packages' lines: table rows, the header, and
    the inertia-correction lines (a failed factorization's inertia None)."""
    lines = [
        "Iter  Objective  Prim Inf   Dual Inf   Comp Inf   Barrier    Prim Step  Dual Step  "
        "LS Step    Reg        Time   ",
        "0     0.00e+00   3.36e+00   0.00e+00   0.00e+00   1.00e-01   1.00e+00   1.00e+00   "
        "1.00e+00   0.00e+00   0.645  ",
        "reg_iter  reg_coef  pos_eig   neg_eig   zero_eig  status    ",
        "0         0.00e+00  None      None      None      3         ",
        "1         1.00e-08  237       216       0         0         ",
        "1     6.56e-02   1.52e+00   5.18e-03   0.00e+00   1.00e-01   5.00e-01   1.00e+00   "
        "1.00e+00   1.00e-08   2.341  ",
    ]
    t = parse_log_table(lines)
    assert [r["iter"] for r in t["iterations"]] == [0, 1]
    assert t["iterations"][1]["alpha_primal"] == 0.5 and t["iterations"][1]["reg"] == 1e-8
    assert t["inertia"] == [[(0, 0.0, None, None, None, 3), (1, 1e-8, 237, 216, 0, 0)]]


def test_ulp_perturbations():
    """Each nonzero entry of the block primals moves exactly one ulp, zeros
    and the coupling stay, the same seed gives the same points, and the
    digest of the initial point tells points apart."""
    x = np.array([[1.0, 0.0, -2.5], [3.0e-7, 0.0, 7.0]])
    p0 = {"blocks": x, "coupling": np.zeros(2)}
    a = chip_smoke.ulp_perturbations(p0, 3, seed=5)
    b = chip_smoke.ulp_perturbations(p0, 3, seed=5)
    for pa, pb in zip(a, b):
        np.testing.assert_array_equal(pa["blocks"], pb["blocks"])
        assert pa["coupling"] is p0["coupling"]
        nz = x != 0
        ulps = np.abs(pa["blocks"] - x)[nz] / np.spacing(np.abs(x[nz]))
        assert np.all((ulps == 1.0) | (ulps == 0.5))  # an ulp down from a power of 2 is half
        assert np.all(pa["blocks"][~nz] == 0) and np.all(pa["blocks"][nz] != x[nz])
    assert len({chip_smoke.primal_digest(p) for p in [p0, *a]}) == 4


def test_sign_test():
    """The exact two-sided sign test: ties dropped, p = 2 P(X <= min) under
    Binomial(n, 1/2), capped at 1; the two-kinds ensembles of the JAX
    package's CPU run and the card's (``chip_smoke.PARITY``, PERF.md §6)
    lean (7 above, none below)."""
    assert sign_test([7, 7, 7], [7, 7, 7]) == (0, 0, 1.0)
    assert sign_test([1, 2, 3, 4], [2, 3, 4, 5]) == (4, 0, 2 / 16)
    assert sign_test([5] * 6, [6, 6, 6, 6, 4, 5]) == (4, 1, 2 * 6 / 32)
    up, down, p = sign_test([3, 3], [2, 4])
    assert (up, down, p) == (1, 1, 1.0)
    jax = chip_smoke.PARITY["burgers_two_kinds"][2]
    card = [8, 8, 7, 7, 8, 8, 8, 8, 8, 8, 7, 8, 8, 8, 8, 8, 8]
    up, down, p = sign_test(jax, card)
    assert (up, down) == (7, 0) and p == 2 / 2**7 < chip_smoke.LEAN_P
    with pytest.raises(ValueError):
        sign_test([1, 2], [1])


def test_panel_order_variants():
    """``panel_order``'s variants of the float32 block panels: the "jax"
    LDL^T follows the JAX package's ``_ldl_slab_batched_xla`` (the two
    differ only where a rank-8 product is summed in another order) and its
    W is ``_unit_lower_inv_b``'s recursion; the "dot" W recurrence is
    bitwise the panel kernel's plain W; every variant's W inverts its L;
    the swap is undone after the block."""
    from parapint_tpu.ops import ldl as jldl
    from parapint_tpu_torch.ops import ldl
    from parapint_tpu_torch.ops.ldl_panel import ldl_panels_slab_winv_plain, random_panels

    A = random_panels(4, 64, seed=1)
    F, W = ldl_panels_slab_winv_plain(torch.from_numpy(A))
    np.testing.assert_array_equal(panel_order.w_recurrence(F), W)
    low = np.tril(np.ones((64, 64), dtype=bool))
    F_jax = np.asarray(jldl._ldl_slab_batched_xla(jnp.asarray(A)))[:, low]
    F_ours = panel_order.slab_dot(torch.from_numpy(A)).numpy()[:, low]
    assert np.mean(F_ours == F_jax) > 0.9
    np.testing.assert_allclose(F_ours, F_jax, rtol=0, atol=1e-6 * np.abs(F_jax).max())
    eye = torch.eye(64)
    for name, panels in panel_order.PANELS.items():
        LD, Wv = panels(torch.from_numpy(A))
        assert torch.allclose(Wv @ (torch.tril(LD, -1) + eye), eye, atol=1e-6), name
    saved = ldl._panel_factor_batch_winv
    with panel_order.panel_order("jax"):
        LD, Wv = ldl._panel_factor_batch_winv(torch.from_numpy(A), True)
        assert torch.equal(LD, panel_order.slab_dot(torch.from_numpy(A)))
    assert ldl._panel_factor_batch_winv is saved


def _deltas(x):
    """A made-up step: ``x`` as the block primals, the other families empty."""
    return {**{f: np.zeros(0) for f in STATE_FIELDS}, "primals": {"blocks": np.asarray(x)}}


def _record(**kw):
    rec = dict(conv=[1.0, 2.0, 0.0, 3.0], deltas=_deltas(np.ones(3)),
               alpha_primal=0.5, alpha_dual=1.0, converged=False, barrier=0.1,
               retries=[(0, 0.0, 3, 2, 0, 0)], coef_used=0.0, inertia=(3, 2, 0), solve_status=0,
               gate_fallbacks=0, cg=None, kkt_digest="a", inertia64=(3, 2, 0))
    rec.update(kw)
    return rec


def test_compare_step_rules():
    """``compare_step``'s rules on made-up records: equal steps pass; a
    float32 direction past 1e-4 fails its bar but is no fault alone; a
    different convergence number is a fault; a different inertia
    correction is a fault unless the JAX package's float32 and float64
    inertias of that KKT differ, and the rest of the step is compared
    either way."""
    j = _record()
    assert compare_step(j, _record())[1:] == (None, None)
    far = _record(deltas=_deltas([1.0, 1.0, 1.001]))
    errs, fail, fault = compare_step(j, far)
    assert fail.startswith("direction") and fault is None and errs["direction"] == pytest.approx(1e-3)
    errs, fail, fault = compare_step(j, _record(conv=[1.0, 2.0, 0.0, 3.0 + 1e-9]))
    assert fail.startswith("conv") and fault == fail
    retry = [(0, 0.0, 2, 3, 0, 0), (1, 1e-8, 3, 2, 0, 0)]
    jr = _record(retries=retry, coef_used=1e-8, inertia64=(2, 3, 0))
    errs, fail, fault = compare_step(jr, far)
    assert fail.startswith("retries") and fault.startswith("retries")
    assert errs["direction"] == pytest.approx(1e-3)
    errs, fail, fault = compare_step(dict(jr, inertia64=(3, 2, 0)), far)
    assert fail.startswith("retries") and fault is None


def test_verdict():
    """``verdict`` names each kind of fault and count flag of a full-size
    result, and none for a result whose counts and float32 accuracy do not
    lean."""
    rows = [dict(jax_f64=1e-3, port_f64=1e-3 * (1 + i % 2)) for i in range(8)]
    res = dict(first_fault=None, accuracy_lean=accuracy_lean(rows),
               jax_fused=[(0, n) for n in [6, 6, 7, 7, 7]], port_fused=[(0, n) for n in [7, 6, 6, 7, 7]])
    res["count_lean"] = sign_test(*([n for _, n in res[k]] for k in ("jax_fused", "port_fused")))
    assert res["accuracy_lean"] == (4, 0, 0.125)
    assert verdict(res) == dict(faults=[], count_flags=[])
    lean = dict(res, port_fused=[(0, 8)] * 5, jax_ip=[], count_lean=(5, 0, 0.0625),
                accuracy_lean=accuracy_lean(rows * 2), first_fault=(3, "conv: 1e-9 > 1e-10"))
    v = verdict(lean)
    assert [f.split()[0] for f in v["faults"]] == ["step", "float32"]
    assert [f.split()[0] for f in v["count_flags"]] == ["count"]
    v = verdict(dict(lean, count_lean=(9, 0, 2 / 2**9)))
    assert v["count_flags"][-1].startswith("counts lean")
    row10 = dict(res, jax_fused=None, jax_ip=[("optimal", 11, 0.0)] * 5)
    assert verdict(row10) == dict(faults=[], count_flags=["count 7 outside the JAX set [11]"])


@pytest.fixture(scope="module")
def entry():
    """The JAX package at the ``entry()`` shape, computed once for the
    module: ``entry["trace"](key)`` is ``jax_trace`` of a configuration
    (without the float64-factored directions: each JAX solver's float64
    compile costs 8-16 s on an 8-core CPU; the full-size comparisons have
    them), ``entry["iface"](kind)`` the
    interface of kind "uniform" or "two_kinds" that the traces of that kind
    share (and so their compiled functions)."""
    ifaces, traces = {}, {}

    def iface(kind):
        if kind not in ifaces:
            ifaces[kind] = jax_config("two_kinds" if kind == "two_kinds" else "dense_sc", ENTRY)[0]
        return ifaces[kind]

    def trace(key):
        if key not in traces:
            traces[key] = jax_trace(iface("two_kinds" if key == "two_kinds" else "uniform"),
                                    _options(pt, SOLVERS[key](pt, jnp.float32)))
        return traces[key]

    return dict(iface=iface, trace=trace)


@pytest.mark.parametrize("key", ["dense_sc", "cr", "pcg", "two_kinds"])
def test_teacher_forced_steps_match_jax(key, entry):
    """At the ``entry()`` shape, the port's step from every JAX iterate of
    the JAX package's ``ip_solve`` run takes the JAX decisions and its
    direction and step sizes within the fixed bars of ``BARS``, the two
    KKT systems bitwise equal at least at the first step, and its
    convergence check ends the solve at the JAX final iterate."""
    records, final, n, ok = entry["trace"](key)
    assert ok and n == 6
    rows, first_fail, first_fault = teacher_forced(records, final, *port_config(key, ENTRY))
    for row in rows:
        print(key, row)
    assert len(rows) == n - 1 and rows[0]["kkt_equal"]
    assert first_fail is None and first_fault is None


def test_jax_trace_is_ip_solve_and_port_counts_agree(entry):
    """``jax_trace`` is the JAX package's ``ip_solve``: its iterations and
    the numbers of every row of the JAX log table agree (the table's three
    digits).  The port's ``ip_solve`` table at the same shape has the same
    rows and inertia lines; its count is the port's fused count, and
    ``chip_smoke``'s phase 22 ensemble (``_ensemble``) gives this file's
    fused counts (``fused_counts`` on ``ulp_perturbations`` of the same
    initial point, whose digest both compute alike)."""
    records, final, n, ok = entry["trace"]("dense_sc")
    status, n_ip, obj, lines = ip_solve_run(pt, entry["iface"]("uniform"),
                                            _options(pt, SOLVERS["dense_sc"](pt, jnp.float32)))
    table = parse_log_table(lines)
    assert status == "optimal" and ok and n_ip == n
    rows = table["iterations"]
    for rec, row, nxt in zip(records, rows, rows[1:]):
        assert float(f"{rec['conv'][0]:.2e}") == row["primal_inf"]
        assert float(f"{rec['alpha_primal']:.2e}") == nxt["alpha_primal"]
        assert float(f"{rec['barrier']:.2e}") == nxt["barrier"]
        assert float(f"{rec['coef_used']:.2e}") == nxt["reg"]
    assert [r for b in table["inertia"] for r in b] == [r for rec in records for r in rec["retries"]]
    pi, ps = port_config("dense_sc", ENTRY)
    p_status, p_n, p_obj, p_lines = ip_solve_run(ptt, pi, _options(ptt, ps))
    p_table = parse_log_table(p_lines)
    assert p_status == "optimal" and p_n == n
    assert abs(p_obj - obj) <= 1e-6 * max(1.0, abs(obj))
    assert p_table["inertia"] == table["inertia"]
    for a, b in zip(p_table["iterations"], rows):
        assert a["barrier"] == b["barrier"] and a["reg"] == b["reg"]
    primals = initial_primals(pi)
    counts, digest = chip_smoke._ensemble(pi, ps, "entry", 2, obj)
    assert digest == chip_smoke.primal_digest(primals) == chip_smoke.primal_digest(
        initial_primals(entry["iface"]("uniform")))
    points = [None, *chip_smoke.ulp_perturbations(primals, 2)]
    assert [(0, c) for c in counts] == fused_counts(ptt, pi, _options(ptt, ps), points)
    assert counts[0] == p_n


# -- full size (slow) ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("name", list(FULL))
def test_full_size_comparison(name):
    """A configuration at its full size on the CPU (``compare_config`` with
    ``run_options``; minutes to hours each): the JAX reference optimal,
    every solve optimal, and no fault by ``verdict`` (its count flags are
    printed)."""
    r = compare_config(name, **run_options(name))
    print(json.dumps(r))
    assert r["jax_trace"][0]
    runs = [*r["jax_ip"], *r.get("jax_fused", []), *r["port_ip"], *r["port_fused"]]
    assert all(st in (0, "optimal") for st, *_ in runs)
    v = verdict(r)
    print(name, v)
    assert v["faults"] == []


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="the CPU comparison of one configuration at full size")
    ap.add_argument("name", choices=sorted(FULL))
    ap.add_argument("--out")
    a = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    r = compare_config(a.name, **run_options(a.name))
    r["verdict"] = verdict(r)
    line = json.dumps(r)
    print(line)
    if a.out:
        Path(a.out).write_text(line + "\n")
