"""Banded path of the PyTorch port vs the JAX package: the interface's
symbolic plan and probed band store, the band -> tile conversion, the
block-Thomas factor/solve and the BandedSchurComplementSolver, on the same
inputs (the tests/test_banded.py fixture: Burgers nfe_x=8, nfe_t=12, 4
blocks).

Tolerances: perm, iperm and p exactly equal; float64 bands, rhs and
borders to 1e-12 (the reference's probe-vs-dense bound); float64 solves to
1e-9 (its dense-parity bound); float32 bands to 1e-6 relative (float32
probes of the same model); inertia exact.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parapint_tpu as pt
import parapint_tpu_torch as ptt
from parapint_tpu.examples import burgers as jburgers
from parapint_tpu.linalg.banded_schur import thomas_factor_batched as j_thomas_factor
from parapint_tpu.linalg.banded_schur import thomas_solve_batched as j_thomas_solve
from parapint_tpu.ops.banded import sym_band_to_tridiag_tiles as j_tiles
from parapint_tpu.ops.banded import sym_banded_matvec as j_matvec
from parapint_tpu_torch.examples import burgers
from parapint_tpu_torch.linalg.banded_schur import (
    BandedLocalBlockKKT,
    thomas_factor_batched,
    thomas_solve_batched,
)
from parapint_tpu_torch.linalg.schur import BlockRhs
from parapint_tpu_torch.ops.banded import sym_band_to_tridiag_tiles, sym_banded_matvec

torch.set_num_threads(1)

SHAPE = dict(nfe_x=8, nfe_t=12, num_time_blocks=4)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.fixture(scope="module")
def pair():
    """(JAX interface, port interface, JAX (data, kkt), port (data, kkt)) at
    barrier 0.1 with w_reg = 0.017, c_reg = 0.003."""
    j_iface = pt.DynamicSchurComplementInteriorPointInterface(
        jburgers.build_spec(**SHAPE), block_form="banded"
    )
    t_iface = ptt.DynamicSchurComplementInteriorPointInterface(
        burgers.build_spec(**SHAPE, device="cpu"), block_form="banded"
    )
    j_data = j_iface.eval_kkt_data(j_iface.init_state(), 0.1)
    t_data = t_iface.eval_kkt_data(t_iface.init_state(), 0.1)
    j_kkt = j_iface.assemble_kkt(j_data, 0.017, 0.003)
    t_kkt = t_iface.assemble_kkt(t_data, 0.017, 0.003)
    return j_iface, t_iface, (j_data, j_kkt), (t_data, t_kkt)


def test_plan_matches_reference(pair):
    j_iface, t_iface, _, _ = pair
    jp, tp = j_iface.banded_plan, t_iface.banded_plan
    assert tp.p == jp.p and tp.q == jp.q
    np.testing.assert_array_equal(tp.perm, jp.perm)
    np.testing.assert_array_equal(tp.iperm, jp.iperm)
    for name in ("Vx", "Vs", "Vyeq", "Vyineq", "Vlam", "col_idx", "row_idx", "valid"):
        np.testing.assert_array_equal(getattr(tp, name), getattr(jp, name))
    assert (t_iface.nk, t_iface.ncv, t_iface.expected_neg_eig) == (
        j_iface.nk, j_iface.ncv, j_iface.expected_neg_eig
    )


def test_bands_rhs_and_border_match_reference(pair):
    _, _, (j_data, j_kkt), (t_data, t_kkt) = pair
    np.testing.assert_allclose(_np(t_kkt.sym_bands), np.asarray(j_kkt.sym_bands), atol=1e-12, rtol=0)
    np.testing.assert_array_equal(_np(t_kkt.border_loc), np.asarray(j_kkt.border_loc))
    np.testing.assert_allclose(_np(t_kkt.q), np.asarray(j_kkt.q), atol=0, rtol=0)
    jr, tr = j_data[1], t_data[1]
    np.testing.assert_allclose(_np(tr.blocks), np.asarray(jr.blocks), atol=1e-12, rtol=0)
    np.testing.assert_allclose(_np(tr.coupling), np.asarray(jr.coupling), atol=1e-12, rtol=0)


def test_float32_bands_match_reference():
    j_iface = pt.DynamicSchurComplementInteriorPointInterface(
        jburgers.build_spec(**SHAPE), block_form="banded", kkt_dtype=jnp.float32
    )
    t_iface = ptt.DynamicSchurComplementInteriorPointInterface(
        burgers.build_spec(**SHAPE, device="cpu"), block_form="banded", kkt_dtype=torch.float32
    )
    jb = np.asarray(j_iface.eval_kkt_data(j_iface.init_state(), 0.1)[0])
    tb = _np(t_iface.eval_kkt_data(t_iface.init_state(), 0.1)[0])
    assert tb.dtype == np.float32 == jb.dtype
    assert np.abs(tb - jb).max() <= 1e-6 * np.abs(jb).max()


def _kkt_from_reference(j_kkt) -> BandedLocalBlockKKT:
    """The port's KKT holding exactly the JAX-assembled arrays."""
    t = lambda a: torch.as_tensor(np.array(a))
    return BandedLocalBlockKKT(
        sym_bands=t(j_kkt.sym_bands),
        border_loc=t(j_kkt.border_loc),
        row_idx=t(j_kkt.row_idx).long(),
        q=t(j_kkt.q),
        mask=t(j_kkt.mask),
        perm=t(j_kkt.perm).long(),
        iperm=t(j_kkt.iperm).long(),
        assembly=j_kkt.assembly,
    )


def test_solver_solve_and_inertia_match_reference(pair, jax_factors):
    j_iface, t_iface, (j_data, j_kkt), (t_data, _) = pair
    rhs = j_data[1]
    jsol = pt.BandedSchurComplementSolver(
        schur_complement_solver=pt.BlockTridiagSolver(ns=j_iface.ns)
    )
    jf = _jax_factor(jax_factors, jsol, j_kkt)
    jx, jst = jax.jit(jsol.solve_with_status)(jf, rhs)
    tsol = ptt.BandedSchurComplementSolver(
        schur_complement_solver=ptt.BlockTridiagSolver(ns=t_iface.ns)
    )
    tf = tsol.numeric(_kkt_from_reference(j_kkt))
    tx, tst = tsol.solve_with_status(
        tf, BlockRhs(torch.as_tensor(np.array(rhs.blocks)), torch.as_tensor(np.array(rhs.coupling)))
    )
    assert int(tst) == int(jst) == 0
    assert tuple(int(v) for v in tsol.inertia(tf)) == tuple(int(v) for v in jsol.inertia(jf))
    assert tsol.n_numeric == 1
    assert np.abs(_np(tx.blocks) - np.asarray(jx.blocks)).max() < 1e-9
    assert np.abs(_np(tx.coupling) - np.asarray(jx.coupling)).max() < 1e-9


def test_default_coupling_solver_matches_reference(pair):
    """Without a coupling solver both packages factor the chain SC densely
    (DenseLDLSolver(refine_steps=0)); same solve and inertia as the JAX
    package to the float64 dense-parity bound."""
    _, _, (j_data, j_kkt), _ = pair
    rhs = j_data[1]
    jsol = pt.BandedSchurComplementSolver()
    jf = jax.jit(jsol.numeric)(j_kkt)
    jx, jst = jax.jit(jsol.solve_with_status)(jf, rhs)
    tsol = ptt.BandedSchurComplementSolver()
    assert isinstance(tsol.sc_solver, ptt.DenseLDLSolver) and tsol.sc_solver.refine_steps == 0
    tf = tsol.numeric(_kkt_from_reference(j_kkt))
    tx, tst = tsol.solve_with_status(
        tf, BlockRhs(torch.as_tensor(np.array(rhs.blocks)), torch.as_tensor(np.array(rhs.coupling)))
    )
    assert int(tst) == int(jst) == 0
    assert tuple(int(v) for v in tsol.inertia(tf)) == tuple(int(v) for v in jsol.inertia(jf))
    assert np.abs(_np(tx.blocks) - np.asarray(jx.blocks)).max() < 1e-9
    assert np.abs(_np(tx.coupling) - np.asarray(jx.coupling)).max() < 1e-9


def test_build_spec_defaults_to_the_card():
    """Without device= the example targets CUDA; on a machine without CUDA
    it raises instead of quietly building on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device builds on the card")
    with pytest.raises(RuntimeError, match="CUDA"):
        burgers.build_spec(nfe_x=4, nfe_t=4, num_time_blocks=2)
    spec = burgers.build_spec(nfe_x=4, nfe_t=4, num_time_blocks=2, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ptt.DynamicModelSpec(
            num_blocks=2, objective=spec.objective, eq_constraints=spec.eq_constraints,
            params={"t0": np.zeros(2)}, x0=np.zeros((2, spec.n_x)),
            start_state_idx=spec.start_state_idx, end_state_idx=spec.end_state_idx,
        )


def _random_banded(N, nk, p, seed):
    rng = np.random.default_rng(seed)
    bands = np.zeros((N, p + 1, nk))
    Ks = []
    for b in range(N):
        A = rng.normal(size=(nk, nk))
        K = (A + A.T) / 2
        K[np.abs(np.subtract.outer(range(nk), range(nk))) > p] = 0.0
        K += np.diag(np.sign(rng.normal(size=nk)) * (5.0 + rng.random(nk)))
        Ks.append(K)
        for e in range(p + 1):
            bands[b, e, : nk - e] = np.diag(K, -e)
    return bands, Ks


@pytest.mark.parametrize("p,ts", [(5, 8), (7, 8), (3, 10)])
def test_tiles_and_matvec_match_reference(p, ts):
    bands, Ks = _random_banded(2, 40, p, seed=p)
    d, u = sym_band_to_tridiag_tiles(torch.as_tensor(bands), ts)
    jd, ju = jax.vmap(lambda sb: j_tiles(sb, ts))(jnp.asarray(bands))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    x = np.random.default_rng(0).normal(size=(40, 2))
    mv = sym_banded_matvec(torch.as_tensor(bands[0]), torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(mv, Ks[0] @ x, atol=1e-12)
    np.testing.assert_allclose(mv, np.asarray(j_matvec(jnp.asarray(bands[0]), jnp.asarray(x))), atol=1e-12)


def test_thomas_factor_solve_inertia_vs_dense_and_reference():
    N, nk, p, ts = 3, 40, 5, 8
    bands, Ks = _random_banded(N, nk, p, seed=0)
    diag_t, upper_t = sym_band_to_tridiag_tiles(torch.as_tensor(bands), ts)
    fact = thomas_factor_batched(diag_t, upper_t, torch.ones(N, dtype=torch.float64))
    rng = np.random.default_rng(1)
    R = rng.normal(size=(N, nk, 4))
    S = thomas_solve_batched(fact, torch.as_tensor(R).reshape(N, nk // ts, ts, 4)).reshape(N, nk, 4)
    pos = neg = 0
    for b in range(N):
        assert np.abs(S[b].numpy() - np.linalg.solve(Ks[b], R[b])).max() < 1e-10
        w = np.linalg.eigvalsh(Ks[b])
        pos += (w > 0).sum()
        neg += (w < 0).sum()
    assert tuple(fact.inertia.tolist()[:2]) == (pos, neg)
    jd, ju = jax.vmap(lambda sb: j_tiles(sb, ts))(jnp.asarray(bands))
    jf = j_thomas_factor(jd, ju, jnp.ones(N))
    jS = j_thomas_solve(jf, jnp.asarray(R).reshape(N, nk // ts, ts, 4)).reshape(N, nk, 4)
    np.testing.assert_allclose(S.numpy(), np.asarray(jS), atol=1e-10)
    np.testing.assert_allclose(fact.tinv.numpy(), np.asarray(jf.tinv), rtol=1e-9, atol=1e-12)
    assert fact.inertia.tolist() == np.asarray(jf.inertia).tolist()


def _solve_counted(solver, fact, rhs):
    """(x, status, refinement passes) of ``solve_with_status``, the passes
    counted from the solver's ``_solve_once`` calls; the JAX solver's runs
    eagerly (``jax.disable_jit``: its ``lax.while_loop`` is a host loop)."""
    calls = [0]
    once = solver._solve_once

    def counted(*a, **k):
        calls[0] += 1
        return once(*a, **k)

    eager = jax.disable_jit() if isinstance(solver, pt.BandedSchurComplementSolver) else (
        contextlib.nullcontext())
    solver._solve_once = counted
    try:
        with eager:
            x, status = solver.solve_with_status(fact, rhs)
    finally:
        del solver._solve_once
    return x, int(status), calls[0] - 1


# (arguments of both solvers, float32 KKT): every solve is held to
# tests/test_banded.py's dense-parity 1e-9
BANDED_ARGS = {
    # the fixture's default factor (shared with the test above), no pass
    "refine_steps0": (dict(refine_steps=0), False),
    # the KKT rounded to float32, its tiles factored in float64 (the column
    # sweep) as one panel each, two fixed float64 passes
    "refine_steps2_f32_kkt_factor_f64_tile_block_size128_zero_tol": (
        dict(refine_steps=2, factor_dtype="float64", tile_block_size=128, zero_tol=1e-10), True),
}
# what the numeric reads: the refine cases share the default factor
NUMERIC_ARGS = ("zero_tol", "factor_dtype", "tile_block_size")


@pytest.fixture(scope="module")
def jax_factors():
    """JAX factors by (float32 KKT, numeric arguments), shared by the tests."""
    return {}


def _jax_factor(jax_factors, solver, kkt, f32=False):
    key = (f32, *(str(getattr(solver, name)) for name in NUMERIC_ARGS))
    if key not in jax_factors:
        jax_factors[key] = jax.jit(solver.numeric)(kkt)
    return jax_factors[key]


@pytest.mark.parametrize("case", list(BANDED_ARGS))
def test_solver_arguments_match_reference(pair, jax_factors, case):
    """The banded solver's restored arguments at user values, both packages
    built with the same ones on the same KKT: fixed refinement passes,
    status and inertia exactly equal, the Thomas tile inverses of the same
    shape and dtype, the solutions within 1e-9 of each other.
    ``tile_block_size=128`` exceeds the fixture's tile (each tile is one
    panel, as in the JAX package); the float64 factor of the fixture's KKT
    rounded to float32 takes the column sweep."""
    kw, f32 = BANDED_ARGS[case]
    kw = dict(kw)
    fd = kw.pop("factor_dtype", None)
    j_iface, _, (j_data, j_kkt), _ = pair
    if f32:
        j_kkt = dataclasses.replace(j_kkt, **{
            name: getattr(j_kkt, name).astype(jnp.float32) for name in ("sym_bands", "border_loc", "q")})
    rhs = j_data[1]
    jsol = pt.BandedSchurComplementSolver(
        schur_complement_solver=pt.BlockTridiagSolver(ns=j_iface.ns),
        factor_dtype=None if fd is None else getattr(jnp, fd), **kw,
    )
    tsol = ptt.BandedSchurComplementSolver(
        schur_complement_solver=ptt.BlockTridiagSolver(ns=j_iface.ns),
        factor_dtype=None if fd is None else getattr(torch, fd), **kw,
    )
    for name in ("zero_tol", "refine_steps", "refine_trigger", "refine_max_passes",
                 "tile_block_size", "adaptive_refine"):
        assert getattr(tsol, name) == getattr(jsol, name), name
    jf = _jax_factor(jax_factors, jsol, j_kkt, f32)
    jx, j_status, j_passes = _solve_counted(jsol, jf, rhs)
    tf = tsol.numeric(_kkt_from_reference(j_kkt))
    tx, t_status, t_passes = _solve_counted(
        tsol, tf, BlockRhs(torch.as_tensor(np.array(rhs.blocks)), torch.as_tensor(np.array(rhs.coupling)))
    )
    flat = lambda b: np.concatenate([_np(b.blocks).reshape(-1), _np(b.coupling)])
    scale = np.abs(flat(jx)).max()
    d = np.abs(flat(tx) - flat(jx)).max()
    print(f"{case}: passes JAX {j_passes} port {t_passes}, status JAX {j_status} port "
          f"{t_status}, max|dx| {d:.3e} (max|x| {scale:.3e})")
    assert t_status == j_status == 0
    assert t_passes == j_passes
    if not tsol.adaptive_refine:
        assert t_passes == tsol.refine_steps
    assert tuple(int(v) for v in tsol.inertia(tf)) == tuple(int(v) for v in jsol.inertia(jf))
    assert tuple(tf.thomas.tinv.shape) == tuple(jf.thomas.tinv.shape)
    assert tf.thomas.tinv.dtype == getattr(torch, str(jf.thomas.tinv.dtype))
    assert d <= 1e-9 * scale
