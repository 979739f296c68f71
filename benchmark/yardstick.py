"""The benchmark's yardstick: the card's peaks, the operations and bytes a
kernel call needs (computed from its shapes), and the statistics the metrics
use.  Later changes to the program leave this file as it is.
"""

import statistics

# One NVIDIA H100 SXM (data sheet, dense rates): HBM bandwidth and the
# float32 rate outside the tensor cores.  Both assume the full 700 W limit;
# a run prints the card's own limit beside every number.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def bound_seconds(nbytes: float, flops: float) -> float:
    """The least time the card could take: bytes or flops at peak, the larger."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS)


def panel_factor_work(shape, with_w: bool, itemsize: int = 4):
    """(bytes, flops) of one batched LDL^T panel factorization of (B, b, b)
    panels: the panels read once, the packed LD (and W = L^-1) written once;
    b^3/3 flops for the factor's trailing updates and b^3/3 for W's."""
    B, b, _ = shape
    panels = B * b * b * itemsize
    nbytes = panels * (3 if with_w else 2)
    flops = B * b**3 / 3.0 * (2 if with_w else 1)
    return nbytes, flops


def winv_apply_work(w_shape, nk: int, w_itemsize: int = 4):
    """(bytes, flops) of one batched K^-1 b through W: W (B, n, n) read once,
    d (B, n), s and b (B, nk) read and x (B, nk) written in float32; two
    matrix-vector products per block."""
    B, n, _ = w_shape
    nbytes = B * n * n * w_itemsize + 4 * B * (n + 3 * nk)
    return nbytes, 4.0 * B * n * n


def percentile(values, pct: int) -> float:
    """The ``pct``-th percentile by ``statistics.quantiles(n=100)`` (exclusive
    method); the value itself for fewer than two samples."""
    values = list(values)
    if len(values) < 2:
        return float(values[0])
    return float(statistics.quantiles(values, n=100)[pct - 1])
