"""Roofline model (utils/profiling.py): no device is assumed."""

import pytest

from graphembedding.utils.profiling import Roofline, sgns_roofline

PEAKS = dict(peak_flops=1e12, peak_bw=1e11, gather_ns_per_row=10.0,
             scatter_ns_per_row=20.0)


def test_roofline_without_peaks_raises():
    with pytest.raises(TypeError):
        Roofline(flops=1.0, pairs=1.0)
    with pytest.raises(TypeError):
        sgns_roofline()
    with pytest.raises(ValueError, match="peak_flops"):
        Roofline(flops=1.0, pairs=1.0, **{**PEAKS, "peak_flops": None})
    with pytest.raises(ValueError, match="scatter_ns_per_row"):
        sgns_roofline(**{**PEAKS, "scatter_ns_per_row": 0.0})


def test_sgns_roofline_bounds_order():
    r = sgns_roofline(**PEAKS)
    assert r.t_scatter == pytest.approx(2 * r.t_gather)
    assert r.bound in ("gather", "compute", "vpu", "scatter")
    assert (r.pairs_per_s_serial_floor
            <= r.pairs_per_s_rowtraffic_ceiling
            <= r.pairs_per_s_pipelined_ceiling)
