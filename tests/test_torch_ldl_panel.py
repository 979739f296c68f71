"""PyTorch panel factorizations (parapint_tpu_torch/ops/ldl_panel.py: the
entries ldl_panels_slab_winv, ldl_panels_slab, ldl_panels,
ldl_panels_batched_winv and ldl_panels_batched) vs the JAX package's Pallas
kernels in interpret mode and its XLA column loop.

On the CPU each wrapper takes its plain version, so these tests hold the
plain versions — the kernel's oracles on the card — against the reference.
Inputs are float32 from a numpy seed.  Tolerance: 3e-5 x max|reference|
for the packed factor (the reference's own slab-vs-unblocked bound in
tests/test_pallas_ldl.py), 2e-3 for W L - I (same source); inertia exact.
The column-by-column batched entries are held to the JAX package's own
bounds for its batched kernels (tests/test_pallas_ldl.py:52-73): 2e-5
relative and absolute on the packed factor, 2e-4 on W.
The Pallas kernels leave garbage in the strict upper triangle; the port
writes 0 there, so factors are compared on the lower triangle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parapint_tpu.ops.ldl import _ldl_unblocked
from parapint_tpu.ops.pallas_ldl import ldl_panels as jax_panels
from parapint_tpu.ops.pallas_ldl import ldl_panels_batched as jax_batched
from parapint_tpu.ops.pallas_ldl import ldl_panels_batched_winv as jax_batched_winv
from parapint_tpu.ops.pallas_ldl import ldl_panels_slab as jax_slab
from parapint_tpu.ops.pallas_ldl import ldl_panels_slab_winv as jax_slab_winv
from parapint_tpu_torch.ops import cuda_build, ldl_panel
from parapint_tpu_torch.ops import ldl as tldl
from parapint_tpu_torch.ops.ldl_panel import (
    ldl_panels,
    ldl_panels_batched,
    ldl_panels_batched_plain,
    ldl_panels_batched_winv,
    ldl_panels_batched_winv_plain,
    ldl_panels_plain,
    ldl_panels_slab,
    ldl_panels_slab_plain,
    ldl_panels_slab_winv,
    ldl_panels_slab_winv_plain,
    random_panels as _panels,
)

torch.set_num_threads(1)

RTOL = 3e-5


def _signs(d):
    d = np.asarray(d)
    return ((d > 0).sum(), (d < 0).sum(), (d == 0).sum())


@pytest.mark.parametrize("b", [8, 56, 64])
@pytest.mark.parametrize(
    "case", ["plain", "garbage_upper", "zero_pivot"]
)
def test_plain_matches_pallas_interpret_and_xla_loop(b, case):
    A = _panels(3, b, seed=b, **({case: True} if case != "plain" else {}))
    LD, W = ldl_panels_slab_winv_plain(torch.as_tensor(A))
    LD, W = LD.numpy(), W.numpy()
    # the reference reads only the lower triangle too: symmetrize from it
    A_sym = np.tril(A) + np.swapaxes(np.tril(A, -1), 1, 2)
    ref_loop = np.tril(np.asarray(jax.vmap(_ldl_unblocked)(jnp.asarray(A_sym))))
    ref_k, W_k = jax_slab_winv(jnp.asarray(A), interpret=True)
    ref_k, W_k = np.tril(np.asarray(ref_k)), np.asarray(W_k)
    scale = np.abs(ref_loop).max()
    assert np.abs(np.tril(LD) - ref_loop).max() < RTOL * scale
    assert np.abs(np.tril(LD) - ref_k).max() < RTOL * scale
    assert np.abs(W - W_k).max() < RTOL * max(1.0, np.abs(W_k).max())
    assert np.all(np.triu(LD, 1) == 0.0)
    for i in range(3):
        assert _signs(np.diag(LD[i])) == _signs(np.diag(ref_k[i]))
        assert _signs(np.diag(LD[i])) == _signs(np.diag(ref_loop[i]))
    if case == "zero_pivot":
        assert _signs(np.diagonal(LD, axis1=1, axis2=2))[2] == 3
    L = np.tril(LD, -1) + np.eye(b)
    assert np.abs(np.einsum("bij,bjk->bik", W, L) - np.eye(b)).max() < 2e-3
    d = np.diagonal(LD, axis1=1, axis2=2)
    rec = np.einsum("bij,bj,bkj->bik", L, d, L)
    assert np.abs(rec - A_sym).max() < RTOL * np.abs(A_sym).max()


@pytest.mark.parametrize(
    "entry, b",
    [("slab", 8), ("slab", 56), ("panels", 13), ("panels", 15), ("panels", 32)],
)
@pytest.mark.parametrize("case", ["plain", "garbage_upper", "zero_pivot"])
def test_no_w_plain_matches_pallas_interpret(entry, b, case):
    """K2 (ldl_panels_slab, b % 8 == 0) and K5 (ldl_panels, any width)."""
    A = _panels(3, b, seed=b + 1, **({case: True} if case != "plain" else {}))
    plain, ref_fn = {
        "slab": (ldl_panels_slab_plain, jax_slab),
        "panels": (ldl_panels_plain, jax_panels),
    }[entry]
    LD = plain(torch.as_tensor(A)).numpy()
    ref = np.tril(np.asarray(ref_fn(jnp.asarray(A), interpret=True)))
    A_sym = np.tril(A) + np.swapaxes(np.tril(A, -1), 1, 2)
    ref_loop = np.tril(np.asarray(jax.vmap(_ldl_unblocked)(jnp.asarray(A_sym))))
    scale = np.abs(ref).max()
    assert np.abs(np.tril(LD) - ref).max() < RTOL * scale
    assert np.abs(np.tril(LD) - ref_loop).max() < RTOL * scale
    assert np.all(np.triu(LD, 1) == 0.0)
    for i in range(3):
        assert _signs(np.diag(LD[i])) == _signs(np.diag(ref[i]))
    if case == "zero_pivot":
        assert _signs(np.diagonal(LD, axis1=1, axis2=2))[2] == 3


def test_no_w_wrappers_take_plain_versions_on_cpu():
    A = torch.as_tensor(_panels(2, 16, seed=4))
    counts = (ldl_panels_slab.launches, ldl_panels.launches)
    assert torch.equal(ldl_panels_slab(A), ldl_panels_slab_plain(A))
    assert torch.equal(ldl_panels(A), ldl_panels_plain(A))
    A13 = torch.as_tensor(_panels(1, 13, seed=5))
    assert torch.equal(ldl_panels(A13), ldl_panels_plain(A13))
    assert (ldl_panels_slab.launches, ldl_panels.launches) == counts
    with pytest.raises(ValueError):
        ldl_panels_slab(A13)  # K2 needs b % 8 == 0
    with pytest.raises(ValueError):
        ldl_panels(torch.zeros(1, 129, 129))
    with pytest.raises(TypeError):
        ldl_panels(A.double())


def test_inertia_matches_eigenvalues():
    A = _panels(4, 64, seed=7)
    LD, _ = ldl_panels_slab_winv_plain(torch.as_tensor(A))
    for i in range(4):
        w = np.linalg.eigvalsh(A[i].astype(np.float64))
        assert _signs(np.diag(LD[i].numpy())) == ((w > 0).sum(), (w < 0).sum(), 0)


def test_wrapper_takes_plain_version_on_cpu():
    A = torch.as_tensor(_panels(2, 16, seed=3))
    before = ldl_panels_slab_winv.launches
    LD, W = ldl_panels_slab_winv(A)
    LDp, Wp = ldl_panels_slab_winv_plain(A)
    assert torch.equal(LD, LDp) and torch.equal(W, Wp)
    assert ldl_panels_slab_winv.launches == before  # no kernel launch


@pytest.mark.parametrize(
    "A, err",
    [
        (torch.zeros(2, 12, 12), ValueError),  # b % 8 != 0
        (torch.zeros(2, 136, 136), ValueError),  # b > 128
        (torch.zeros(2, 16, 16, dtype=torch.float64), TypeError),
        (torch.zeros(2, 16, 8), ValueError),
        (torch.zeros(2, 16, 16).transpose(1, 2), ValueError),  # non-contiguous
    ],
)
def test_wrapper_rejects_unsupported_input(A, err):
    with pytest.raises(err):
        ldl_panels_slab_winv(A)


def test_kernel_source_and_build_flags():
    """The CUDA source exists in the package and the build targets sm_90a
    as a plain C-ABI library (nothing here compiles it: no nvcc)."""
    src = ldl_panel.SOURCE.read_text()
    assert 'extern "C"' in src and "ldl_panel_winv_f32" in src and "ldl_panel_f32" in src
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS
    assert cuda_build.BUILD_DIR.name == "_build"


# -- K3 / K4: the column-by-column batched entries (any width) ----------------


@pytest.mark.parametrize("b", [13, 16])
@pytest.mark.parametrize("case", ["plain", "garbage_upper", "zero_pivot"])
def test_batched_plain_matches_pallas_interpret(b, case):
    """K3 (ldl_panels_batched_winv) and K4 (ldl_panels_batched) plain
    versions vs the JAX batched kernels in interpret mode, chunk 2."""
    A = _panels(5, b, seed=b + 2, **({case: True} if case != "plain" else {}))
    LD, W = ldl_panels_batched_winv_plain(torch.as_tensor(A))
    LD4 = ldl_panels_batched_plain(torch.as_tensor(A))
    ref, W_ref = jax_batched_winv(jnp.asarray(A), chunk=2, interpret=True)
    ref4 = jax_batched(jnp.asarray(A), chunk=2, interpret=True)
    ref, W_ref, ref4 = np.tril(np.asarray(ref)), np.asarray(W_ref), np.tril(np.asarray(ref4))
    np.testing.assert_allclose(np.tril(LD.numpy()), ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.tril(LD4.numpy()), ref4, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(W.numpy(), W_ref, rtol=2e-4, atol=2e-4)
    assert torch.equal(LD, LD4)  # one sweep serves both entries
    assert np.all(np.triu(LD.numpy(), 1) == 0.0)
    for i in range(5):
        assert _signs(np.diag(LD[i].numpy())) == _signs(np.diag(ref[i]))
    if case == "zero_pivot":
        assert _signs(np.diagonal(LD.numpy(), axis1=1, axis2=2))[2] == 5


def test_batched_plain_follows_the_pivot_column_on_asymmetric_input():
    """A perturbed (not exactly symmetric) panel: the port and the JAX
    batched kernel both follow the lower triangle (the case of
    tests/test_pallas_ldl.py:37-56)."""
    rng = np.random.default_rng(7)
    B, b = 4, 32
    A = rng.standard_normal((B, b, b))
    A = A + np.swapaxes(A, 1, 2) + 4 * b * np.eye(b)
    A = (A + 1e-7 * rng.standard_normal((B, b, b))).astype(np.float32)
    LD = ldl_panels_batched_plain(torch.as_tensor(A)).numpy()
    ref = np.asarray(jax_batched(jnp.asarray(A), chunk=2, interpret=True))
    np.testing.assert_allclose(np.tril(LD), np.tril(ref), rtol=2e-5, atol=2e-5)
    LDw, _ = ldl_panels_batched_winv_plain(torch.as_tensor(A))
    assert np.array_equal(LDw.numpy(), LD)


def test_batched_wrappers_take_plain_versions_on_cpu():
    counts = (ldl_panels_batched.launches, ldl_panels_batched_winv.launches)
    for b in (1, 13, 16, 127):
        A = torch.as_tensor(_panels(2, b, seed=b))
        assert torch.equal(ldl_panels_batched(A), ldl_panels_batched_plain(A))
        LD, W = ldl_panels_batched_winv(A)
        LDp, Wp = ldl_panels_batched_winv_plain(A)
        assert torch.equal(LD, LDp) and torch.equal(W, Wp)
    assert (ldl_panels_batched.launches, ldl_panels_batched_winv.launches) == counts
    for entry in (ldl_panels_batched, ldl_panels_batched_winv):
        with pytest.raises(ValueError):
            entry(torch.zeros(2, 129, 129))
        with pytest.raises(TypeError):
            entry(torch.zeros(2, 13, 13, dtype=torch.float64))


def _spy(monkeypatch, names):
    """Replace the named panel entries in ops/ldl with recorders that call
    through: on the CPU the counters do not move, so the routing is read
    from the calls."""
    calls = []
    for name in names:
        fn = getattr(tldl, name)

        def spy(A, _fn=fn, _name=name):
            calls.append((_name, A.shape[-1]))
            return _fn(A)

        monkeypatch.setattr(tldl, name, spy)
    return calls


ENTRY_NAMES = ("ldl_panels_slab", "ldl_panels_batched", "ldl_panels_slab_winv", "ldl_panels_batched_winv")


@pytest.mark.parametrize(
    "algo, b, expect",
    [
        (None, 16, ("ldl_panels_slab", "ldl_panels_slab_winv")),
        ("slab", 16, ("ldl_panels_slab", "ldl_panels_slab_winv")),
        ("slab2", 16, ("ldl_panels_slab", "ldl_panels_slab_winv")),
        ("column", 16, ("ldl_panels_batched", "ldl_panels_batched_winv")),
        (None, 13, ("ldl_panels_batched", "ldl_panels_batched_winv")),
        ("column", 13, ("ldl_panels_batched", "ldl_panels_batched_winv")),
    ],
)
def test_panel_algo_routes_batched_panels(monkeypatch, algo, b, expect):
    """PT_PANEL_ALGO, read once per factorization, picks the slab entries (K1/K2)
    for widths that are a multiple of 8 and the batched ones (K3/K4) for
    "column" and every other width, as the JAX package's _use_slab_kernel."""
    if algo is None:
        monkeypatch.delenv("PT_PANEL_ALGO", raising=False)
    else:
        monkeypatch.setenv("PT_PANEL_ALGO", algo)
    calls = _spy(monkeypatch, ENTRY_NAMES)
    A = torch.as_tensor(_panels(3, b, seed=b))
    tldl.ldl_factor_batched(A, block_size=b)
    tldl.ldl_factor_winv_batched(A, block_size=b)
    assert calls == [(expect[0], b), (expect[1], b)]
    calls.clear()
    slab_algo = tldl._slab_algo()
    tldl._panel_factor_batch(A.double(), slab_algo)  # f64 keeps the column sweep
    tldl._panel_factor_batch_winv(A.double(), slab_algo)
    assert calls == []


# -- the kernel's order of operations, mirrored on the CPU --------------------


def _slab_order_mirror(A: torch.Tensor, with_w: bool, r: int = 8):
    """The CUDA kernel's schedule (csrc/ldl_panel_winv.cu) in torch: 8-column
    slabs [j0, e); per column j of the slab, the multipliers and the raw
    column go to ``lmul``/``craw`` and only the slab's own columns are
    updated; packing waits for the end of the slab; the trailing block then
    takes the slab's r updates in ascending jj, and W takes them first in
    the slab's rows (ascending row, ascending jj), then in the rows below.
    Every update is a separate product and subtraction, as ``msub``."""
    B, b, _ = A.shape
    a = torch.tril(A).clone()
    W = torch.eye(b, dtype=A.dtype).expand(B, b, b).clone() if with_w else None
    for j0 in range(0, b, r):
        e = min(j0 + r, b)
        craw = torch.zeros(B, b, e - j0, dtype=A.dtype)
        lmul = torch.zeros_like(craw)
        for j in range(j0, e):
            jj = j - j0
            piv = a[:, j, j]
            piv_safe = torch.where(piv.abs() > 0, piv, torch.ones_like(piv))
            col = a[:, j + 1 :, j].clone()
            craw[:, j + 1 :, jj] = col
            lmul[:, j + 1 :, jj] = col / piv_safe[:, None]
            if j + 1 < e:  # the slab's own columns (j, e), c <= i
                blk = a[:, j + 1 :, j + 1 : e]
                prod = lmul[:, j + 1 :, jj, None] * col[:, None, : e - j - 1]
                keep = torch.ones(blk.shape[1:], dtype=torch.bool).tril()
                a[:, j + 1 :, j + 1 : e] = torch.where(keep, blk - prod, blk)
        if e < b:  # trailing block, c <= i, one element at a time in jj order
            X = a[:, e:, e:]
            keep = torch.ones(X.shape[1:], dtype=torch.bool).tril()
            for jj in range(e - j0):
                X = torch.where(keep, X - lmul[:, e:, jj, None] * craw[:, None, e:, jj], X)
            a[:, e:, e:] = X
        for j in range(j0, e):  # deferred packing
            a[:, j + 1 :, j] = lmul[:, j + 1 :, j - j0]
        if with_w:
            for i in range(j0 + 1, e):  # the slab's own rows, in order
                for j in range(j0, i):
                    W[:, i, : j + 1] = W[:, i, : j + 1] - lmul[:, i, j - j0, None] * W[:, j, : j + 1]
            for j in range(j0, e):  # then the rows below, from the final slab rows
                W[:, e:, : j + 1] = W[:, e:, : j + 1] - lmul[:, e:, j - j0, None] * W[:, None, j, : j + 1]
    return a, W


@pytest.mark.parametrize("b", [1, 7, 8, 13, 56, 64, 100, 128])
@pytest.mark.parametrize("case", ["plain", "garbage_upper", "zero_pivot"])
def test_slab_schedule_is_bitwise_the_plain_sweep(b, case):
    """The kernel's slab schedule rounds every entry as the plain sweep does
    (same updates, same operands, same order per entry), so it is
    torch.equal to both plain versions: the CUDA kernel's bit-for-bit
    contract, shown without the card."""
    A = torch.as_tensor(_panels(2, b, seed=b + 11, **({case: True} if case != "plain" else {})))
    LD, W = _slab_order_mirror(A, with_w=True)
    LDp, Wp = ldl_panels_slab_winv_plain(A)
    assert torch.equal(LD, LDp) and torch.equal(W, Wp)
    LD0, _ = _slab_order_mirror(A, with_w=False)
    assert torch.equal(LD0, ldl_panels_plain(A))
