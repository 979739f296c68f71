"""Read-only streaming probe K7 (parapint_tpu_torch/ops/read_reduce.py) vs
the JAX package's kernel-lab probe ``tools/kernel_lab.py::cmd_bw`` (inner
``kern``), run here as a ``pl.pallas_call`` in interpret mode with the same
BlockSpecs, without the TPU memory space.

On the CPU the wrapper takes the plain version, so these tests hold the
kernel's oracle against the reference.  Inputs are float32 from a numpy seed.
Tolerance per entry: both sum n float32 values in different orders; the
rounding errors of such sums grow as a random walk, so each entry lies
within about sqrt(n) eps_f32 times the column sum of |W| of the exact value,
and the two are held to 2 such units (K6's convention).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from parapint_tpu_torch.ops import read_reduce as rr
from parapint_tpu_torch.ops.read_reduce import ROWS_PER_CTA, read_reduce, read_reduce_plain

torch.set_num_threads(1)

EPS = float(np.finfo(np.float32).eps)
CASES = [(4, 16, 2), (2, 64, 1), (8, 24, 4)]  # (B, n, C): C matrices per Pallas grid step
ROWS = [1, 5, 16, ROWS_PER_CTA]


def _pallas_probe(W: np.ndarray, C: int) -> np.ndarray:
    """The kernel-lab probe's Pallas kernel (kernel_lab.py:272-292)."""
    N, n, _ = W.shape

    def kern(w_ref, o_ref):
        o_ref[...] = jnp.sum(w_ref[...], axis=1, keepdims=True)

    out = pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct((N, 1, n), jnp.float32),
        grid=(N // C,),
        in_specs=[pl.BlockSpec((C, n, n), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((C, 1, n), lambda i: (i, 0, 0)),
        interpret=True,
    )(jnp.asarray(W))
    return np.asarray(out)


def _inputs(B, n, seed):
    return np.random.default_rng(seed).standard_normal((B, n, n)).astype(np.float32)


def _units(got, ref, W):
    """|got - ref| per entry in units of sqrt(n) eps_f32 x column sum of |W|."""
    n = W.shape[-1]
    unit = np.sqrt(n) * EPS * np.abs(W.astype(np.float64)).sum(axis=1, keepdims=True)
    return np.abs(got.astype(np.float64) - ref.astype(np.float64)) / unit


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("B,n,C", CASES)
def test_plain_matches_pallas_interpret(B, n, C, rows):
    W = _inputs(B, n, seed=n)
    ref = _pallas_probe(W, C)
    got = read_reduce_plain(torch.as_tensor(W), rows)
    assert got.dtype == torch.float32 and got.shape == (B, 1, n)
    assert _units(got.numpy(), ref, W).max() <= 2.0


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("B,n,C", CASES)
def test_plain_matches_torch_sum(B, n, C, rows):
    W = _inputs(B, n, seed=B)
    Wt = torch.as_tensor(W)
    got = read_reduce_plain(Wt, rows)
    ref = Wt.sum(1, keepdim=True)
    assert _units(got.numpy(), ref.numpy(), W).max() <= 2.0


def test_plain_adds_each_tile_in_row_order_then_the_tiles():
    """The plain version's order, which the kernel repeats: rows of each tile
    from 0 in order, then the tile sums from 0 in order (bitwise)."""
    W = torch.as_tensor(_inputs(3, 24, seed=5))
    rows = 5
    tiles = []
    for t0 in range(0, 24, rows):
        acc = torch.zeros(3, 24)
        for r in range(t0, min(24, t0 + rows)):
            acc = acc + W[:, r, :]
        tiles.append(acc)
    out = torch.zeros(3, 24)
    for t in tiles:
        out = out + t
    assert torch.equal(read_reduce_plain(W, rows), out[:, None, :])


def test_wrapper_takes_plain_version_on_cpu():
    W = torch.as_tensor(_inputs(2, 16, seed=1))
    before = read_reduce.launches
    assert torch.equal(read_reduce(W), read_reduce_plain(W, ROWS_PER_CTA))
    assert torch.equal(read_reduce(W, 5), read_reduce_plain(W, 5))
    assert read_reduce.launches == before


@pytest.mark.parametrize(
    "change, rows, err",
    [
        (lambda W: W.double(), ROWS_PER_CTA, TypeError),
        (lambda W: W.to(torch.bfloat16), ROWS_PER_CTA, TypeError),
        (lambda W: W[:, :6, :6].contiguous(), ROWS_PER_CTA, ValueError),  # n % 4
        (lambda W: W.transpose(1, 2), ROWS_PER_CTA, ValueError),  # non-contiguous
        (lambda W: W[0], ROWS_PER_CTA, ValueError),  # not (B, n, n)
        (lambda W: W, 0, ValueError),
    ],
)
def test_wrapper_rejects_unsupported_input(change, rows, err):
    W = torch.as_tensor(_inputs(2, 16, seed=2))
    with pytest.raises(err):
        read_reduce(change(W), rows)


def test_kernel_source_has_its_entry_and_default_rows():
    src = rr.SOURCE.read_text()
    assert 'extern "C"' in src
    for name in rr.SIGNATURES:
        assert name in src
    # the wrapper's default is K6's rows per CTA
    assert f"kRows = {ROWS_PER_CTA};" in (rr.SOURCE.parent / "winv_apply.cu").read_text()
