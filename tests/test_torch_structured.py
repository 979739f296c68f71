"""Dense block form of the port's structured interface vs the JAX package's
at the ``entry()`` shape (Burgers nfe_x=8, nfe_t=8, 4 blocks): ``eval_ad``,
``kkt_from_ad`` (BlockKKTData and rhs), ``assemble_kkt`` (LocalBlockKKT)
and ``convergence_from_ad`` from the same iterate.

Tolerances: float64 derivatives, blocks and rhs to 1e-12 (the same model
differentiated in the same precision, different AD engines and summation
orders); float32 matrix data to 1e-6 relative to its largest entry (the
banded tests' float32 bound).  The port keeps the border strips in the KKT
data's dtype (the JAX package hands float64 strips beside float32 blocks);
their entries are 0 and -1, so they compare exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parapint_tpu as pt
import parapint_tpu_torch as ptt
from parapint_tpu.examples import burgers as jburgers
from parapint_tpu_torch.convert import ipstate_from_numpy
from parapint_tpu_torch.examples import burgers
from parapint_tpu_torch.interfaces.base import STATE_FIELDS
from parapint_tpu_torch.interfaces.blocked import BlockKKTData

torch.set_num_threads(1)

SHAPE = dict(nfe_x=8, nfe_t=8, num_time_blocks=4)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _state(j_iface, seed=0):
    """A non-trivial iterate: the initial state with seeded duals."""
    st = j_iface.init_state()
    rng = np.random.default_rng(seed)
    tree = {f: jax.tree_util.tree_map(np.asarray, getattr(st, f)) for f in STATE_FIELDS}
    tree["duals_eq"]["own"] = rng.standard_normal(tree["duals_eq"]["own"].shape)
    tree["duals_eq"]["link"] = rng.standard_normal(tree["duals_eq"]["link"].shape) * np.asarray(
        j_iface.link_mask
    )
    jst = type(st)(**{
        f: jax.tree_util.tree_map(jnp.asarray, tree[f]) for f in STATE_FIELDS
    })
    return jst, ipstate_from_numpy(tree, "cpu")


@pytest.fixture(scope="module", params=["f64", "f32"])
def pair(request):
    f32 = request.param == "f32"
    j_iface = pt.DynamicSchurComplementInteriorPointInterface(
        jburgers.build_spec(**SHAPE), kkt_dtype=jnp.float32 if f32 else None
    )
    t_iface = ptt.DynamicSchurComplementInteriorPointInterface(
        burgers.build_spec(**SHAPE, device="cpu"), kkt_dtype=torch.float32 if f32 else None
    )
    assert j_iface.block_form == t_iface.block_form == "dense"
    jst, tst = _state(j_iface)
    mu = 0.1
    j_ad, t_ad = j_iface.eval_ad(jst), t_iface.eval_ad(tst)
    j_data = j_iface.kkt_from_ad(jst, j_ad, mu)
    t_data = t_iface.kkt_from_ad(tst, t_ad, torch.tensor(mu, dtype=torch.float64))
    return f32, (j_iface, jst, j_ad, j_data), (t_iface, tst, t_ad, t_data)


def _close(t, j, f32, what):
    t, j = _np(t), np.asarray(j)
    assert t.shape == j.shape, what
    if j.size == 0:
        return
    tol = (1e-6 if f32 else 1e-12) * max(1.0, np.abs(j).max())
    assert np.abs(t - j).max() <= tol, (what, np.abs(t - j).max())


def test_eval_ad_matches_reference(pair):
    f32, (ji, _, j_ad, _), (ti, _, t_ad, _) = pair
    for k in ("obj", "grad_f", "c_eq", "c_ineq"):
        _close(t_ad[k], j_ad[k], False, k)  # working precision: float64
    for k in ("jac_eq", "jac_ineq", "hess"):
        assert _np(t_ad[k]).dtype == np.asarray(j_ad[k]).dtype == (np.float32 if f32 else np.float64)
        _close(t_ad[k], j_ad[k], f32, k)
    if f32:
        _close(t_ad["jtlam"], j_ad["jtlam"], False, "jtlam")
    else:
        assert t_ad["jtlam"] is None and j_ad["jtlam"] is None


def test_kkt_from_ad_matches_reference(pair):
    f32, (_, _, _, j_data), (_, _, _, t_data) = pair
    jd, td = j_data[0], t_data[0]
    assert isinstance(td, BlockKKTData)
    for k in ("hess", "jac_eq", "jac_ineq", "sigma_x", "sigma_s"):
        _close(getattr(td, k), getattr(jd, k), f32, k)
    _close(t_data[1].blocks, j_data[1].blocks, False, "rhs blocks")
    _close(t_data[1].coupling, j_data[1].coupling, False, "rhs coupling")


def test_assemble_kkt_matches_reference(pair):
    f32, (ji, _, _, j_data), (ti, _, _, t_data) = pair
    jk = ji.assemble_kkt(j_data, 0.017, 0.003)
    tk = ti.assemble_kkt(t_data, 0.017, 0.003)
    assert tk.diag.dtype == (torch.float32 if f32 else torch.float64)  # never promoted
    assert tk.diag.shape == (4, ti.nk, ti.nk) and tk.assembly == jk.assembly == "chain"
    _close(tk.diag, jk.diag, f32, "diag")
    np.testing.assert_array_equal(_np(tk.border_loc), np.asarray(jk.border_loc))
    np.testing.assert_array_equal(_np(tk.row_idx), np.asarray(jk.row_idx))
    np.testing.assert_array_equal(_np(tk.q), np.asarray(jk.q))
    np.testing.assert_array_equal(_np(tk.mask), np.asarray(jk.mask))
    np.testing.assert_array_equal(_np(ti.border_loc), np.asarray(ji.border_loc))


def test_convergence_from_ad_matches_reference(pair):
    f32, (ji, jst, j_ad, _), (ti, tst, t_ad, _) = pair
    ji.set_bounds_relaxation_factor(0.0)
    ti.set_bounds_relaxation_factor(0.0)
    jc = ji.convergence_from_ad(jst, j_ad, 0.1, 100.0)
    tc = ti.convergence_from_ad(tst, t_ad, torch.tensor(0.1, dtype=torch.float64), 100.0)
    for k in ("primal_inf", "dual_inf", "compl_inf_0"):
        _close(getattr(tc, k), getattr(jc, k), False, k)


def test_scatter_link_duals_match_reference(pair, monkeypatch):
    """The "scatter" topology's sum of the link duals onto the coupling rows
    (each group is hit by two blocks; the first block's backward and the
    last block's forward rows go to the dump index) against the JAX
    package's .at[].add, to 1e-12 relative; in block order, it gives the
    chain topology's two-term sums bit for bit."""
    _, (ji, jst, _, _), (ti, tst, _, _) = pair
    chain = ti._scatter_link_duals_to_coupling(tst.duals_eq)
    for iface in (ji, ti):
        monkeypatch.setattr(iface, "sc_assembly", "scatter")
    t = ti._scatter_link_duals_to_coupling(tst.duals_eq)
    j = np.asarray(ji._scatter_link_duals_to_coupling(jst.duals_eq))
    assert np.abs(_np(t) - j).max() <= 1e-12 * np.abs(j).max()
    assert torch.equal(t, chain)
