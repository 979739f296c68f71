"""The no-W panel entries (K2 ``ldl_panels_slab``, K5 ``ldl_panels``), the
column-by-column batched entries (K3 ``ldl_panels_batched_winv``, K4
``ldl_panels_batched``), the W-form block apply (K6 ``winv_apply_fused``)
and the read-only streaming probe (K7 ``read_reduce``) vs their plain
PyTorch versions on the card.

Needs an NVIDIA GPU with nvcc (the kernels are built from
``parapint_tpu_torch/csrc`` at first use); skips elsewhere.  On the card:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q

Tolerances: the panel kernel rounds every update exactly as its plain
version does, so K2, K3, K4 and K5 agree bit for bit; K7 adds in its plain version's
order, so it does too.  K6 sums in another order:
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
    ldl_panels_batched,
    ldl_panels_batched_plain,
    ldl_panels_batched_winv,
    ldl_panels_batched_winv_plain,
    ldl_panels_plain,
    ldl_panels_slab,
    ldl_panels_slab_plain,
    random_panels,
)
from parapint_tpu_torch.ops.read_reduce import read_reduce, read_reduce_plain
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


@pytest.mark.parametrize("shape", [(32, 50, 50), (64, 100, 100), (16, 127, 127), (3, 1, 1),
                                   (5, 13, 13), (64, 128, 128)])
@pytest.mark.parametrize("case", ["plain", "garbage_upper", "zero_pivot"])
def test_batched_entries_match_plain_version(cuda, shape, case):
    """K3 (ldl_panels_batched_winv) and K4 (ldl_panels_batched) at widths
    that are not a multiple of 8 (and one that is): bitwise equal to their
    plain versions on the lower triangle of LD and on W."""
    kw = {case: True} if case != "plain" else {}
    A = torch.as_tensor(random_panels(*shape[:2], seed=shape[1], **kw), device=cuda)
    before = (ldl_panels_batched.launches, ldl_panels_batched_winv.launches)
    LD4 = ldl_panels_batched(A)
    LD3, W3 = ldl_panels_batched_winv(A)
    torch.cuda.synchronize()
    assert (ldl_panels_batched.launches, ldl_panels_batched_winv.launches) == (
        before[0] + 1, before[1] + 1)
    LDp, Wp = ldl_panels_batched_winv_plain(A)
    assert torch.equal(torch.tril(LD4), torch.tril(LDp))
    assert torch.equal(torch.tril(LD3), torch.tril(LDp)) and torch.equal(W3, Wp)
    assert torch.equal(ldl_panels_batched_plain(A), LDp)


@pytest.mark.parametrize("b", [1, 7, 9, 63, 65, 120, 127])
def test_ragged_slabs_match_plain_version(cuda, b):
    """Widths whose first or last 8-column slab is ragged (b < 8, b % 8 != 0),
    through both instantiations (K3 with W, K4 and K5 without): bitwise
    equal to the plain sweep."""
    A = torch.as_tensor(random_panels(3, b, seed=b, zero_pivot=b > 1), device=cuda)
    LD3, W3 = ldl_panels_batched_winv(A)
    LD4 = ldl_panels_batched(A)
    LD5 = ldl_panels(A[:1].contiguous())
    torch.cuda.synchronize()
    LDp, Wp = ldl_panels_batched_winv_plain(A)
    assert torch.equal(LD3, LDp) and torch.equal(W3, Wp)
    assert torch.equal(LD4, LDp) and torch.equal(LD5, LDp[:1])


def test_odd_float32_batched_panels_launch_the_column_kernels(cuda, monkeypatch):
    """The dispatch of ops/ldl: an f32 CUDA panel of a width that is not a
    multiple of 8, or any width under PT_PANEL_ALGO=column, launches K3/K4."""
    for algo, b in (("slab", 12), ("column", 16)):
        monkeypatch.setenv("PT_PANEL_ALGO", algo)
        A = torch.as_tensor(random_panels(2, b, seed=b), device=cuda)
        before = (ldl_panels_batched.launches, ldl_panels_batched_winv.launches)
        ldl.ldl_factor_batched(A, block_size=b)
        ldl.ldl_factor_winv_batched(A, block_size=b)
        assert (ldl_panels_batched.launches, ldl_panels_batched_winv.launches) == (
            before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("B,n", [(64, 1024), (3, 8), (5, 56)])
@pytest.mark.parametrize("rows", [16, 64, 256])
def test_read_reduce_matches_plain_version(cuda, B, n, rows):
    """K7 at the kernel lab's shape and two edge shapes, for each rows per
    CTA the lab sweeps: bitwise equal to its plain version."""
    rng = np.random.default_rng(n)
    W = torch.as_tensor(rng.standard_normal((B, n, n), dtype=np.float32), device=cuda)
    before = read_reduce.launches
    out = read_reduce(W, rows)
    torch.cuda.synchronize()
    assert read_reduce.launches == before + 1
    assert out.shape == (B, 1, n)
    assert torch.equal(out, read_reduce_plain(W, rows))
