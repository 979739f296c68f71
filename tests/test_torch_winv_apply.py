"""W-form block back solve (parapint_tpu_torch/ops/winv_apply.py) vs the JAX
package's Pallas kernel ``winv_apply_fused`` in interpret mode.

On the CPU the wrapper takes the plain version (the two-GEMV form), so these
tests hold the kernel's oracle against the reference.  Inputs are float32
(W also bf16) from a numpy seed.  Tolerance: both sum n products twice in
float32 in different orders, so they agree to 2 n eps_f32 times the same
computation on absolute values (a first-order rounding bound); a bf16 W is
converted to float32 exactly by both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parapint_tpu.ops.winv_apply import winv_apply_fused as jax_winv_apply
from parapint_tpu_torch.ops import winv_apply as twa
from parapint_tpu_torch.ops.winv_apply import winv_apply_fused, winv_apply_plain

torch.set_num_threads(1)

EPS = float(np.finfo(np.float32).eps)


def _inputs(B, n, nk, seed, zero_pivot=False):
    rng = np.random.default_rng(seed)
    W = np.tril(rng.standard_normal((B, n, n)) / np.sqrt(n), -1) + np.eye(n)
    d = rng.choice([-1.0, 1.0], (B, n)) * rng.uniform(0.1, 10.0, (B, n))
    if zero_pivot:
        d[:, n // 3] = 0.0
    s = rng.uniform(0.5, 2.0, (B, nk))
    b = rng.standard_normal((B, nk))
    return [a.astype(np.float32) for a in (W, d, s, b)]


@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,n,nk,zero_pivot", [(3, 16, 16, False), (5, 24, 20, True), (2, 64, 49, False)]
)
def test_plain_matches_pallas_interpret(B, n, nk, zero_pivot, wdtype):
    W, d, s, b = _inputs(B, n, nk, seed=n, zero_pivot=zero_pivot)
    Wt = torch.as_tensor(W).to(getattr(torch, wdtype))
    Wj = jnp.asarray(W).astype(getattr(jnp, wdtype))
    ref = np.asarray(jax_winv_apply(Wj, jnp.asarray(d), jnp.asarray(s), jnp.asarray(b), interpret=True))
    t = [torch.as_tensor(a) for a in (d, s, b)]
    got = winv_apply_fused(Wt, *t)
    assert got.dtype == torch.float32 and got.shape == (B, nk)
    absref = winv_apply_plain(Wt.abs(), *(a.abs() for a in t)).numpy()
    err = np.abs(got.numpy() - ref).max()
    assert err <= 2 * n * EPS * np.abs(absref).max(), err
    assert np.all(np.isfinite(got.numpy()))


def test_wrapper_takes_plain_version_on_cpu():
    W, d, s, b = (torch.as_tensor(a) for a in _inputs(2, 16, 12, seed=1))
    before = winv_apply_fused.launches
    assert torch.equal(winv_apply_fused(W, d, s, b), winv_apply_plain(W, d, s, b))
    assert winv_apply_fused.launches == before


@pytest.mark.parametrize(
    "change, err",
    [
        (lambda W, d, s, b: (W.double(), d, s, b), TypeError),
        (lambda W, d, s, b: (W[:, :12, :12], d[:, :12], s[:, :12], b[:, :12]), ValueError),  # n % 8
        (lambda W, d, s, b: (W, d[:, :8], s, b), ValueError),
        (lambda W, d, s, b: (W, d, s.double(), b), TypeError),
        (lambda W, d, s, b: (W.transpose(1, 2), d, s, b), ValueError),  # non-contiguous
    ],
)
def test_wrapper_rejects_unsupported_input(change, err):
    W, d, s, b = (torch.as_tensor(a) for a in _inputs(2, 16, 16, seed=2))
    with pytest.raises(err):
        winv_apply_fused(*change(W, d, s, b))


def test_kernel_source_has_both_entries():
    src = twa.SOURCE.read_text()
    assert 'extern "C"' in src
    for name in twa.SIGNATURES:
        assert name in src
