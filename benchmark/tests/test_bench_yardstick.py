"""The byte formulas of the roofline metrics against the port's kernel
table (bound ms at its shapes: bytes over 3.35 TB/s, all seven bound by
bytes)."""

import pytest

from benchmark import yardstick


@pytest.mark.parametrize("shape, with_w, bound_ms", [
    ((64, 128, 128), True, 0.00376),   # K1 dense
    ((64, 64, 64), True, 0.00094),     # K1 banded
    ((32, 56, 56), True, 0.00036),     # K1 cyclic reduction, E = 32
    ((64, 128, 128), False, 0.00250),  # K2 / K4
    ((64, 100, 100), True, 0.00229),   # K3 at block_size=100
    ((1, 128, 128), False, 0.00004),   # K5
])
def test_panel_factor_bound(shape, with_w, bound_ms):
    nbytes, flops = yardstick.panel_factor_work(shape, with_w)
    assert flops / yardstick.PEAK_F32_FLOPS < nbytes / yardstick.PEAK_BYTES_PER_S
    assert yardstick.bound_seconds(nbytes, flops) * 1e3 == pytest.approx(bound_ms, abs=5e-6)


@pytest.mark.parametrize("w_shape, nk, itemsize, bound_ms", [
    ((64, 1024, 1024), 922, 4, 0.0804),   # K6, f32 W
    ((64, 1024, 1024), 922, 2, 0.0404),   # K6, bf16 W
    ((32, 1024, 1024), 1024, 4, 0.0402),  # K6 at the QP's shape
])
def test_winv_apply_bound(w_shape, nk, itemsize, bound_ms):
    nbytes, flops = yardstick.winv_apply_work(w_shape, nk, itemsize)
    assert yardstick.bound_seconds(nbytes, flops) * 1e3 == pytest.approx(bound_ms, abs=5e-5)


def test_percentile_is_statistics_quantiles():
    import statistics

    v = [float(i) ** 1.5 for i in range(30)]
    assert yardstick.percentile(v, 90) == pytest.approx(statistics.quantiles(v, n=10)[8], rel=1e-15)
    assert yardstick.percentile([2.5], 90) == 2.5
