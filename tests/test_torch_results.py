"""What a user reads from a solved problem, and the dual warm start, in the
port against the JAX package on the CPU.

- Every public name of the JAX package's dynamic, stochastic and
  heterogeneous interfaces exists on the port's.
- The accessors (``chip_smoke.results``: ``get_primals``, ``get_slacks``,
  ``get_duals_*``, ``get_block_primals`` of every block, the counts and
  each kind's own) return bitwise equal arrays from one seeded state put
  into both packages' interfaces: the dynamic interface in dense and
  banded block form at the ``entry()`` shape (Burgers nfe_x=8, nfe_t=8, 4
  blocks), the ragged three-kind heterogeneous problem of
  ``tests/test_torch_heterogeneous.py`` and the farmer without an
  ownership map (with one: ``tests/test_torch_sharded.py``).
- The warm start (``tests/test_warmstart_ownership.py``): the same warm
  spec gives both packages ``init_state``s equal within 1e-15 (the farmer
  with that test's values, and Burgers with seeded ones); the Burgers
  flagship's solver at the ``entry()`` shape solved cold, then warm from
  the accessors, in both packages: the warm count at or below the cold one
  and within 1 of the JAX package's warm count, the coupling within 1e-6
  of the cold solution.  The JAX package's warm solve runs the cold
  interface's compiled fused solve from the warm interface's
  ``init_state``: the two interfaces differ only in the spec's initial
  values, which only ``init_state`` reads.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parapint_tpu as pt
import parapint_tpu_torch as ptt
from parapint_tpu.examples import burgers as jburgers
from parapint_tpu.examples import stochastic as jfarmer
from parapint_tpu.interfaces.base import IPState as JState
from parapint_tpu.interfaces.heterogeneous import HeterogeneousDynamicInterface as JHet
from parapint_tpu_torch.convert import ipstate_from_numpy
from parapint_tpu_torch.examples import burgers, stochastic
from parapint_tpu_torch.interfaces.base import STATE_FIELDS

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from tests.test_torch_heterogeneous import _jax_iface, _port_iface  # noqa: E402
from tests.test_torch_sharded import seeded_state  # noqa: E402

torch.set_num_threads(1)

SHAPE = dict(nfe_x=8, nfe_t=8, num_time_blocks=4)
TOL = 1e-8
INIT_TOL = 1e-15
COUPLING_ATOL = 1e-6


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _jax_state(tree) -> JState:
    return JState(**{f: jax.tree_util.tree_map(jnp.asarray, tree[f]) for f in STATE_FIELDS})


def _pair(kind):
    """(JAX interface, port interface) of one kind at test size."""
    if kind in ("dense", "banded"):
        return (pt.DynamicSchurComplementInteriorPointInterface(jburgers.build_spec(**SHAPE),
                                                                block_form=kind),
                ptt.DynamicSchurComplementInteriorPointInterface(
                    burgers.build_spec(**SHAPE, device="cpu"), block_form=kind))
    if kind == "heterogeneous":
        return _jax_iface(True), _port_iface(True)
    return (pt.StochasticSchurComplementInteriorPointInterface(jfarmer.build_spec()),
            ptt.StochasticSchurComplementInteriorPointInterface(stochastic.build_spec(device="cpu")))


@pytest.mark.parametrize("jcls,tcls", [
    (pt.DynamicSchurComplementInteriorPointInterface, ptt.DynamicSchurComplementInteriorPointInterface),
    (pt.StochasticSchurComplementInteriorPointInterface,
     ptt.StochasticSchurComplementInteriorPointInterface),
    (JHet, ptt.HeterogeneousDynamicInterface),
], ids=["dynamic", "stochastic", "heterogeneous"])
def test_port_has_every_jax_name(jcls, tcls):
    """Every public method and property of the JAX class is on the port's
    class (``link_rows``, an attribute of the port's instances, aside)."""
    public = {n for n in dir(jcls) if not n.startswith("_")}
    missing = sorted(n for n in public - {"link_rows"} if not hasattr(tcls, n))
    assert not missing, missing


@pytest.mark.parametrize("kind", ["dense", "banded", "heterogeneous", "stochastic"])
def test_accessors_bitwise(kind):
    """One seeded state in both packages' interfaces: every accessor's
    array equal, the same accessors on both sides."""
    ji, ti = _pair(kind)
    tree = seeded_state(ji, seed=11)
    ji._current_state = _jax_state(tree)
    ti._current_state = ipstate_from_numpy(tree, "cpu")
    jr, tr = chip_smoke.results(ji), chip_smoke.results(ti)
    assert jr.keys() == tr.keys()
    if kind in ("dense", "banded"):
        assert {"get_duals_backward", "get_duals_forward"} <= jr.keys()
    if kind == "stochastic":
        assert {"get_first_stage_values", "get_duals_nonanticipativity"} <= jr.keys()
    for name in jr:
        np.testing.assert_array_equal(_np(tr[name]), np.asarray(jr[name]), err_msg=name)
    assert tr["n_primals"] == ti.N * ti.n + ti.ncv


def _warm_values(kind, N, n, me, L, ncv):
    """The warm spec fields: the JAX warm-start test's for the farmer
    (``tests/test_warmstart_ownership.py``), seeded draws for Burgers."""
    if kind == "farmer":
        mi = 10
        return dict(y_eq0=None, y_ineq0=np.linspace(-1.0, 1.0, N * mi).reshape(N, mi),
                    zl0=np.full((N, n), 0.25), lam0=np.arange(N * L, dtype=float).reshape(N, L),
                    c0=np.array([10.0, 20.0, 30.0]))
    rng = np.random.default_rng(4)
    return dict(x0=rng.standard_normal((N, n)), y_eq0=rng.standard_normal((N, me)),
                lam0=rng.standard_normal((N, L)), c0=rng.standard_normal(ncv),
                zl0=rng.uniform(0.1, 1.0, (N, n)), zu0=rng.uniform(0.1, 1.0, (N, n)))


@pytest.mark.parametrize("kind", ["farmer", "burgers"])
def test_warm_duals_enter_init_state(kind):
    """The same warm spec in both packages: ``init_state``s equal within
    1e-15 field by field; for the farmer also the JAX test's own checks on
    the port's state (the warm values threaded through, the slack duals
    split by sign and pushed positive where a bound is finite)."""
    if kind == "farmer":
        jspec, tspec = jfarmer.build_spec(), stochastic.build_spec(device="cpu")
        N, L, ncv = tspec.num_scenarios, tspec.n_first_stage, tspec.n_first_stage
    else:
        jspec, tspec = jburgers.build_spec(**SHAPE), burgers.build_spec(**SHAPE, device="cpu")
        N, L = tspec.num_blocks, 2 * tspec.num_states
        ncv = (N - 1) * tspec.num_states
    warm = _warm_values(kind, N, tspec.n_x, tspec.n_eq, L, ncv)
    for spec, as_x0 in ((jspec, jnp.asarray), (tspec, torch.as_tensor)):
        for k, v in warm.items():
            setattr(spec, k, as_x0(v) if k == "x0" else v)
        spec.__post_init__()
    make = ((pt.StochasticSchurComplementInteriorPointInterface,
             ptt.StochasticSchurComplementInteriorPointInterface) if kind == "farmer" else
            (pt.DynamicSchurComplementInteriorPointInterface,
             ptt.DynamicSchurComplementInteriorPointInterface))
    jst, tst = make[0](jspec).init_state(), make[1](tspec).init_state()
    for f in STATE_FIELDS:
        jv, tv = getattr(jst, f), getattr(tst, f)
        for k, a in (jv.items() if isinstance(jv, dict) else [("", jv)]):
            b = _np(tv[k] if k else tv)
            a = np.asarray(a)
            assert b.shape == a.shape, (f, k)
            if a.size:
                scale = max(1.0, float(np.abs(a).max()))
                assert np.abs(b - a).max() <= INIT_TOL * scale, (f, k, np.abs(b - a).max())
    np.testing.assert_array_equal(_np(tst.primals["coupling"]), warm["c0"])
    np.testing.assert_array_equal(_np(tst.duals_eq["link"]), warm["lam0"] * _np(
        make[1](tspec).link_mask))
    if kind == "farmer":
        vl, vu = _np(tst.duals_slacks_lb), _np(tst.duals_slacks_ub)
        gl_fin, gu_fin = np.isfinite(tspec.gl), np.isfinite(tspec.gu)
        assert np.all(vl[gl_fin] > 0) and np.all(vu[gu_fin] > 0)
        assert np.all(vl[~gl_fin] == 0) and np.all(vu[~gu_fin] == 0)
        strong = (warm["y_ineq0"] > 0.1) & gl_fin
        np.testing.assert_allclose(vl[strong], warm["y_ineq0"][strong], atol=1e-12)
        np.testing.assert_array_equal(_np(tst.duals_ineq), warm["y_ineq0"])
        assert np.allclose(_np(tst.duals_primals_lb["blocks"]), 0.25)


def _options(pkg, f32):
    opts = pkg.IPOptions()
    opts.tol = TOL
    # the dense flagship's solver (bench_all's burgers_64blocks_cr)
    opts.linalg.solver = pkg.SchurComplementSolver(
        block_size=128, explicit_inverse=True, factor_dtype=f32, refine_steps=0,
        schur_complement_solver=pkg.BlockTridiagSolver())
    return opts


def test_warm_start_cuts_iterations():
    """Cold, then warm from the accessors, in both packages (the dense
    flagship's solver at the entry() shape): optimal, the warm count at or
    below the cold one and within 1 of the JAX package's, the warm
    coupling within 1e-6 of the cold one; both packages' counts printed."""
    # the JAX package: one compiled fused solve, from the cold and the warm
    # interface's init_state
    jopts = _options(pt, jnp.float32)
    ji = pt.DynamicSchurComplementInteriorPointInterface(jburgers.build_spec(**SHAPE),
                                                        kkt_dtype=jnp.float32)
    ji.set_bounds_relaxation_factor(jopts.bounds_relaxation_factor)
    solve = pt.make_fused_ip_solve(ji, jopts)
    jcold = solve(ji.init_state())
    ji._current_state = jcold.state
    jspec = jburgers.build_spec(**SHAPE)
    for k, v in chip_smoke.warm_fields(ji).items():
        setattr(jspec, k, v)
    jw = pt.DynamicSchurComplementInteriorPointInterface(jspec, kkt_dtype=jnp.float32)
    jw.set_bounds_relaxation_factor(jopts.bounds_relaxation_factor)
    jwarm = solve(jw.init_state())

    ti = ptt.DynamicSchurComplementInteriorPointInterface(
        burgers.build_spec(**SHAPE, device="cpu"), kkt_dtype=torch.float32)
    status, tcold = ptt.ip_solve_fused(ti, _options(ptt, torch.float32))
    assert status == ptt.InteriorPointStatus.optimal
    cold_c = _np(ti.get_coupling_values())
    tw = ptt.DynamicSchurComplementInteriorPointInterface(
        dataclasses.replace(ti.spec, **chip_smoke.warm_fields(ti)), kkt_dtype=torch.float32)
    np.testing.assert_array_equal(_np(tw.init_state().primals["coupling"]), cold_c)
    status, twarm = ptt.ip_solve_fused(tw, _options(ptt, torch.float32))
    assert status == ptt.InteriorPointStatus.optimal

    counts = dict(jax=(int(jcold.iterations), int(jwarm.iterations)),
                  port=(tcold.iterations, twarm.iterations))
    print(f"cold, warm iterations: {counts}")
    assert int(jcold.status) == int(jwarm.status) == 0
    for cold, warm in counts.values():
        assert warm <= cold, counts
    assert abs(counts["port"][1] - counts["jax"][1]) <= 1, counts
    np.testing.assert_allclose(_np(tw.get_coupling_values()), cold_c, atol=COUPLING_ATOL)
    np.testing.assert_allclose(np.asarray(jwarm.state.primals["coupling"]),
                               np.asarray(jcold.state.primals["coupling"]), atol=COUPLING_ATOL)
