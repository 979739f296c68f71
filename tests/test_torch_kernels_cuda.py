"""The no-W panel entries (K2 ``ldl_panels_slab``, K5 ``ldl_panels``) and the
W-form block apply (K6 ``winv_apply_fused``) vs their plain PyTorch versions
on the card.

Needs an NVIDIA GPU with nvcc (the kernels are built from
``parapint_tpu_torch/csrc`` at first use); skips elsewhere.  On the card:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q

Tolerances: the panel kernel rounds every update exactly as its plain
version does, so K2 and K5 agree bit for bit.  K6 sums in another order:
each entry within 2 sqrt(n) eps_f32 times the same computation on absolute
values (rounding errors of the sums grow as a random walk; an f32 W read as
bf16 misses this by more than 20x).
"""

import numpy as np
import pytest
import torch

from parapint_tpu_torch.ops import ldl
from parapint_tpu_torch.ops.ldl_panel import (
    ldl_panels,
    ldl_panels_plain,
    ldl_panels_slab,
    ldl_panels_slab_plain,
    random_panels,
)
from parapint_tpu_torch.ops.winv_apply import winv_apply_fused, winv_apply_plain

pytestmark = pytest.mark.cuda

EPS = float(np.finfo(np.float32).eps)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "entry, shape",
    [("slab", (64, 128, 128)), ("slab", (32, 56, 56)), ("slab", (3, 8, 8)),
     ("panels", (1, 128, 128)), ("panels", (1, 13, 13)), ("panels", (4, 15, 15))],
)
@pytest.mark.parametrize("case", ["plain", "garbage_upper", "zero_pivot"])
def test_no_w_entries_match_plain_version(cuda, entry, shape, case):
    kern, plain = {"slab": (ldl_panels_slab, ldl_panels_slab_plain),
                   "panels": (ldl_panels, ldl_panels_plain)}[entry]
    kw = {case: True} if case != "plain" else {}
    A = torch.as_tensor(random_panels(*shape[:2], seed=shape[0], **kw), device=cuda)
    before = kern.launches
    LD = kern(A)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    assert torch.equal(LD, plain(A))


@pytest.mark.parametrize("B,n,nk", [(64, 1024, 922), (13, 256, 200), (7, 64, 64), (3, 24, 20)])
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
def test_winv_apply_matches_plain_version(cuda, B, n, nk, wdtype):
    rng = np.random.default_rng(n)
    W = np.tril(rng.standard_normal((B, n, n)) / np.sqrt(n), -1) + np.eye(n)
    d = rng.choice([-1.0, 1.0], (B, n)) * rng.uniform(0.1, 10.0, (B, n))
    d[:, n // 3] = 0.0  # a zero pivot divides by 1
    s = rng.uniform(0.5, 2.0, (B, nk))
    b = rng.standard_normal((B, nk))
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda)
    W, d, s, b = t(W).to(wdtype), t(d), t(s), t(b)
    before = winv_apply_fused.launches
    x = winv_apply_fused(W, d, s, b)
    torch.cuda.synchronize()
    assert winv_apply_fused.launches == before + 1
    ref = winv_apply_plain(W, d, s, b)
    absref = winv_apply_plain(W.abs(), d.abs(), s.abs(), b.abs())
    assert bool(((x - ref).abs() <= 2 * np.sqrt(n) * EPS * absref).all())


def test_odd_float32_batched_panels_raise_on_the_card(cuda):
    """Widths the JAX package sends to its column-by-column kernels (K3/K4)
    are not ported: a CUDA float32 panel of such a width raises."""
    A = torch.eye(12, device=cuda).expand(2, 12, 12).contiguous()
    with pytest.raises(NotImplementedError, match="B5"):
        ldl._panel_factor_batch(A)
    with pytest.raises(NotImplementedError, match="B6"):
        ldl._panel_factor_batch_winv(A)
