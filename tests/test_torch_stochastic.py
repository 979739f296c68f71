"""The port's two-stage stochastic path vs the JAX package on the CPU: the
"shared" link topology of the structured interface, the stochastic
interface and spec, the farmer example through ``ip_solve``, and the
synthetic stochastic QP (``examples/stochastic.qp_spec``, the generator of
the JAX package's ``bench_all.stochastic_qp``) at a small size through the
hybrid-precision Schur solver in both drivers.

Criteria and tolerances:
- first KKT from the same iterate: float64 blocks, border, q and rhs to
  1e-12 relative to the largest entry (the same model differentiated in the
  same precision by two AD engines); float32 blocks to 1e-6 relative (the
  structured tests' float32 bound); border, row indices and q exactly;
- solves: the same status, objective relative gap <= 1e-6, iteration counts
  within 1 of each other (both printed); the QP's one JAX fused solve is the
  reference of both port drivers; farmer golden acreage within 1e-4
  (tests/test_examples.py).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parapint_tpu as pt
import parapint_tpu_torch as ptt
from parapint_tpu.examples import stochastic as jfarmer
from parapint_tpu.interfaces.stochastic import StochasticModelSpec as JSpec
from parapint_tpu_torch.convert import ipstate_from_numpy, ipstate_to_numpy, spec_arrays_from_numpy
from parapint_tpu_torch.examples import stochastic
from parapint_tpu_torch.interfaces.base import STATE_FIELDS
from parapint_tpu_torch.utils.timer import HierarchicalTimer

torch.set_num_threads(1)

QP = dict(n_scenarios=4, n=48, me=12, n_first=8)
OBJ_REL_GAP = 1e-6


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _jax_qp(n_scenarios, n, me, n_first, seed=7, kkt_dtype=jnp.float32):
    """The JAX package's ``bench_all.stochastic_qp`` at a given size (the
    same draws from ``np.random.default_rng(seed)``)."""
    rng = np.random.default_rng(seed)
    N = n_scenarios
    A = rng.standard_normal((me, n)) / np.sqrt(n)
    Aj = jnp.asarray(A)
    q = rng.uniform(0.5, 2.0, size=(N, n))
    c = rng.standard_normal((N, n))
    x_tgt = np.abs(rng.standard_normal((N, n))) + 0.1
    b = x_tgt @ A.T

    def objective(x, p):
        return p["prob"] * (0.5 * jnp.sum(p["q"] * x * x) + jnp.dot(p["c"], x))

    def eq_constraints(x, p):
        return Aj @ x - p["b"]

    spec = JSpec(
        num_scenarios=N,
        objective=objective,
        eq_constraints=eq_constraints,
        params={"q": jnp.asarray(q), "c": jnp.asarray(c), "b": jnp.asarray(b),
                "prob": jnp.full(N, 1.0 / N)},
        x0=np.full((N, n), 1.0),
        first_stage_idx=np.arange(n_first),
        xl=np.zeros((N, n)),
    )
    return pt.StochasticSchurComplementInteriorPointInterface(spec, kkt_dtype=kkt_dtype)


def _hybrid(pkg, f64, f32):
    # bench_all's stochastic_qp_32scenarios_1k solver
    return pkg.SchurComplementSolver(
        block_size=128, explicit_inverse=True, factor_dtype=f64, apply_dtype=f32
    )


def _state(j_iface, seed=0):
    """A non-trivial iterate: the initial state with seeded duals, for both
    packages (through convert.ipstate_from_numpy)."""
    st = j_iface.init_state()
    rng = np.random.default_rng(seed)
    tree = {f: jax.tree_util.tree_map(np.asarray, getattr(st, f)) for f in STATE_FIELDS}
    for k in ("own", "link"):
        tree["duals_eq"][k] = rng.standard_normal(tree["duals_eq"][k].shape)
    tree["primals"]["coupling"] = rng.uniform(0.5, 2.0, tree["primals"]["coupling"].shape)
    jst = type(st)(**{f: jax.tree_util.tree_map(jnp.asarray, tree[f]) for f in STATE_FIELDS})
    return jst, ipstate_from_numpy(tree, "cpu")


def _close(t, j, rel, what):
    t, j = _np(t), np.asarray(j)
    assert t.shape == j.shape, what
    if j.size:
        err = np.abs(t - j).max()
        assert err <= rel * max(1.0, np.abs(j).max()), (what, err)


@pytest.fixture(scope="module", params=["farmer", "qp_f32"])
def pair(request):
    if request.param == "farmer":
        j = pt.StochasticSchurComplementInteriorPointInterface(jfarmer.build_spec())
        t = ptt.StochasticSchurComplementInteriorPointInterface(stochastic.build_spec(device="cpu"))
        return False, j, t
    j = _jax_qp(**QP)
    t = ptt.StochasticSchurComplementInteriorPointInterface(
        stochastic.qp_spec(**QP, device="cpu"), kkt_dtype=torch.float32
    )
    return True, j, t


def test_first_kkt_matches_reference(pair):
    """Blocks, border, row indices, q and rhs of the first KKT from the same
    iterate, with and without regularization; the shared topology."""
    f32, ji, ti = pair
    assert ti.sc_assembly == ji.sc_assembly == "shared"
    assert (ti.N, ti.nk, ti.ncv, ti.expected_neg_eig) == (ji.N, ji.nk, ji.ncv, ji.expected_neg_eig)
    jst, tst = _state(ji)
    mu = 0.1
    j_data = ji.eval_kkt_data(jst, mu)
    t_data = ti.eval_kkt_data(tst, torch.tensor(mu, dtype=torch.float64))
    for w, c in ((0.0, 0.0), (1e-4, 1e-6)):
        jk, tk = ji.assemble_kkt(j_data, w, c), ti.assemble_kkt(t_data, w, c)
        assert tk.assembly == jk.assembly == "shared"
        assert tk.diag.dtype == (torch.float32 if f32 else torch.float64)
        _close(tk.diag, jk.diag, 1e-6 if f32 else 1e-12, "diag")
        np.testing.assert_array_equal(_np(tk.border_loc), np.asarray(jk.border_loc))
        np.testing.assert_array_equal(_np(tk.row_idx), np.asarray(jk.row_idx))
        np.testing.assert_array_equal(_np(tk.q), np.asarray(jk.q))
    j_rhs, t_rhs = ji.kkt_rhs(j_data), ti.kkt_rhs(t_data)
    _close(t_rhs.blocks, j_rhs.blocks, 1e-12, "rhs blocks")
    _close(t_rhs.coupling, j_rhs.coupling, 1e-12, "rhs coupling")
    jc = ji.convergence_info(jst, mu, 100.0)
    tc = ti.convergence_info(tst, mu, 100.0)
    for k in ("objective", "primal_inf", "dual_inf", "compl_inf_0", "compl_inf_mu"):
        _close(getattr(tc, k), getattr(jc, k), 1e-12, k)


def test_state_round_trip(pair):
    """convert carries the stochastic IPState (blocks/coupling dicts) both
    ways unchanged."""
    _, ji, ti = pair
    jst, tst = _state(ji, seed=3)
    back = ipstate_to_numpy(tst)
    for f in STATE_FIELDS:
        jv, tv = getattr(jst, f), back[f]
        if isinstance(jv, dict):
            assert set(jv) == set(tv)
            for k in jv:
                np.testing.assert_array_equal(tv[k], np.asarray(jv[k]))
        else:
            np.testing.assert_array_equal(tv, np.asarray(jv))


def test_spec_arrays_carry_across():
    """The JAX spec's params, x0, bounds and masks, through convert, build
    the same port spec as the port's own generator."""
    j = _jax_qp(**QP).spec
    t = stochastic.qp_spec(**QP, device="cpu")
    got = spec_arrays_from_numpy(j, "cpu")
    for k, v in t.params.items():
        np.testing.assert_array_equal(got["params"][k].numpy(), v.numpy())
    for name in ("x0", "xl", "xu", "eq_mask", "x_mask"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(getattr(t, name)))


def test_shared_and_scatter_link_helpers():
    """The coupling gather and the scatter of the link duals: shared (every
    scenario links rows 0..L-1) against a numpy loop, and a scattered
    row_idx (with the dump index ncv) through the same helpers."""
    ti = ptt.StochasticSchurComplementInteriorPointInterface(stochastic.build_spec(device="cpu"))
    rng = np.random.default_rng(1)
    c = torch.as_tensor(rng.standard_normal(ti.ncv))
    lam = torch.as_tensor(rng.standard_normal((ti.N, ti.n_link)))
    duals = {"link": lam}
    np.testing.assert_array_equal(ti._gather_coupling(c).numpy(), np.tile(c.numpy(), (ti.N, 1)))
    np.testing.assert_allclose(ti._scatter_link_duals_to_coupling(duals).numpy(), lam.numpy().sum(0))
    row_idx = np.array([[2, 0, 3], [1, 1, 2], [0, 3, 3]])  # 3 = ncv: the dump row
    ti.row_idx = torch.as_tensor(row_idx)
    ti.sc_assembly = "scatter"
    ext = np.append(c.numpy(), 0.0)
    np.testing.assert_array_equal(ti._gather_coupling(c).numpy(), ext[row_idx])
    want = np.zeros(ti.ncv + 1)
    np.add.at(want, row_idx.ravel(), lam.numpy().ravel())
    np.testing.assert_allclose(ti._scatter_link_duals_to_coupling(duals).numpy(), want[: ti.ncv])


@pytest.mark.parametrize("nc", [5, 8])
def test_shared_border_apply_sums_over_blocks(nc):
    """The Schur solver's border product sum_i P_i A_i v_i: the shared
    topology's fixed-order sum over the blocks equals the row_idx scatter
    (rows past L stay zero)."""
    from parapint_tpu_torch.linalg.schur import _border_apply_local

    rng = np.random.default_rng(nc)
    N, L, nk = 4, 5, 7
    border = torch.as_tensor(rng.standard_normal((N, L, nk)))
    v = torch.as_tensor(rng.standard_normal((N, nk)))
    row_idx = torch.arange(L).expand(N, L)
    want = _border_apply_local(border, row_idx, v, nc, "scatter").numpy()
    got = _border_apply_local(border, row_idx, v, nc, "shared").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-14)
    assert got.shape == (nc,) and not got[L:].any()


def _checks(timer) -> int:
    return timer._root.children["IP solve"].children["convergence check"].count


def test_farmer_through_ip_solve():
    """examples/stochastic.main: golden acreage (170, 80, 250) within 1e-4
    and the JAX package's objective and acreage.  The JAX reference is the
    example's farmer and solver through the fused driver, which reaches the
    JAX ``main``'s (``ip_solve``) acreage and objective to the last digit
    (tests/test_fused.py holds the two JAX drivers together)."""
    j = pt.StochasticSchurComplementInteriorPointInterface(jfarmer.build_spec())
    jo = pt.IPOptions()
    jo.linalg.solver = pt.SchurComplementSolver(block_size=16)
    assert pt.ip_solve_fused(j, jo)[0] == pt.InteriorPointStatus.optimal
    t = stochastic.main(device="cpu")
    acre = t.get_first_stage_values().numpy()
    np.testing.assert_allclose(acre, [170.0, 80.0, 250.0], rtol=0, atol=1e-4)
    j_obj, t_obj = float(j.evaluate_objective()), float(t.evaluate_objective())
    print(f"farmer objective JAX {j_obj!r} port {t_obj!r}")
    assert abs(t_obj - j_obj) <= OBJ_REL_GAP * max(1.0, abs(j_obj))
    np.testing.assert_allclose(acre, np.asarray(j.get_first_stage_values()), rtol=0, atol=1e-6)


def test_farmer_family_through_the_fused_driver():
    """The 32-scenario farmer family (bench_all's stochastic_32, solver
    block_size=64 in W form) through both fused drivers."""
    import bench_all

    j_iface = bench_all.stochastic_32()
    jo = pt.IPOptions()
    jo.linalg.solver = pt.SchurComplementSolver(block_size=64, explicit_inverse=True)
    j_status, j_res = pt.ip_solve_fused(j_iface, jo)
    t_iface = ptt.StochasticSchurComplementInteriorPointInterface(
        stochastic.farmer_family(device="cpu")
    )
    to = ptt.IPOptions()
    to.linalg.solver = ptt.SchurComplementSolver(block_size=64, explicit_inverse=True)
    t_status, t_res = ptt.ip_solve_fused(t_iface, to)
    j_obj, t_obj = float(j_iface.evaluate_objective()), float(t_iface.evaluate_objective())
    print(f"farmer family: iterations JAX {int(j_res.iterations)} port {t_res.iterations}; "
          f"objective JAX {j_obj!r} port {t_obj!r}")
    assert j_status == pt.InteriorPointStatus.optimal
    assert t_status == ptt.InteriorPointStatus.optimal
    assert abs(t_obj - j_obj) <= OBJ_REL_GAP * max(1.0, abs(j_obj))
    assert abs(t_res.iterations - int(j_res.iterations)) <= 1


def _qp_solve(pkg, iface, f64, f32, driver, timer):
    """(status value, objective, iterations) of the small QP through the
    hybrid solver at tol 1e-8."""
    opts = pkg.IPOptions()
    opts.tol = 1e-8
    opts.linalg.solver = _hybrid(pkg, f64, f32)
    with warnings.catch_warnings():
        # kkt_dtype=f32 with a float64 factor warns in both packages
        warnings.simplefilter("ignore", UserWarning)
        if driver == "fused":
            status, res = pkg.ip_solve_fused(iface, opts)
            iters = int(res.iterations)
        else:
            status = pkg.ip_solve(iface, opts, timer=timer)
            iters = _checks(timer)
    return status.value, float(iface.evaluate_objective()), iters


@pytest.fixture(scope="module")
def jax_qp():
    """One JAX fused solve of the small QP, the reference of both port
    drivers (the JAX package holds its fused driver to its Python-loop
    driver in tests/test_fused.py)."""
    return _qp_solve(pt, _jax_qp(**QP), jnp.float64, jnp.float32, "fused", None)


@pytest.mark.parametrize("driver", ["fused", "ip_solve"])
def test_stochastic_qp_hybrid_matches_reference(jax_qp, driver):
    """The QP generator at N=4, n=48, me=12, n_first=8 with a float32 KKT
    through the hybrid solver (float64 pivot sweep, float32 W and applies,
    adaptive refinement), tol 1e-8."""
    iface = ptt.StochasticSchurComplementInteriorPointInterface(
        stochastic.qp_spec(**QP, device="cpu"), kkt_dtype=torch.float32
    )
    js, j_obj, jn = jax_qp
    ts, t_obj, tn = _qp_solve(ptt, iface, torch.float64, torch.float32, driver, HierarchicalTimer())
    print(f"stochastic QP {driver}: iterations JAX fused {jn} port {tn}; "
          f"objective JAX {j_obj!r} port {t_obj!r}")
    assert js == ts == pt.InteriorPointStatus.optimal.value
    assert abs(t_obj - j_obj) <= OBJ_REL_GAP * max(1.0, abs(j_obj))
    assert abs(tn - jn) <= 1


def test_spec_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        stochastic.build_spec()
    with pytest.raises(RuntimeError, match="CUDA"):
        stochastic.qp_spec(**QP)
    spec = stochastic.build_spec(device="cpu")
    with pytest.raises(ValueError, match="requires mesh"):
        ptt.StochasticSchurComplementInteriorPointInterface(spec, ownership_map=[0, 0, 0])
