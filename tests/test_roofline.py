"""Roofline accounting sanity: the model must track config knobs in the
right direction and produce finite bounds."""

import pytest

from vargeno_tpu.config import GenoConfig
from vargeno_tpu.utils import roofline

H100 = "NVIDIA H100 80GB HBM3"
# a bench_gather.measure() result (values only shape the test)
RATES = {"word_gather_1048576": 2e9, "row_gather_1048576": 1e9,
         "row_gather_512B": 5e8, "scatter_rows": 5e8,
         "scatter_scalar": 4e9, "device_sort_u32": 8e9}


def test_roofline_report_shape(mini_index):
    from vargeno_tpu.engine.device_index import build_device_index

    dix = build_device_index(mini_index)
    cfg = GenoConfig(batch_reads=4096, max_read_len=128,
                     max_kmers_per_read=4)
    rep = roofline.roofline(cfg, dix, H100, 4096, 100_000.0,
                            gather_rates=RATES)
    assert rep["lane_bound_reads_per_sec"] > 0
    assert rep["bw_bound_reads_per_sec"] > 0
    assert 0 < rep["lane_roofline_frac"] < 10
    # halving the probe grid's active fraction lowers lane counts
    cfg2 = GenoConfig(batch_reads=4096, max_read_len=128,
                      max_kmers_per_read=4, probe_active_frac=0.125)
    rep2 = roofline.roofline(cfg2, dix, H100, 4096, 100_000.0,
                             gather_rates=RATES)
    assert rep2["lane_bound_reads_per_sec"] > rep["lane_bound_reads_per_sec"]


def test_lane_rates_only_from_measurement():
    r = roofline.device_lane_rates(
        {"word_gather_1048576": 50e6, "row_gather_1048576": None,
         "scatter_rows": 10e6})
    assert r["word"] == 50e6
    assert r["row"] is None     # null measurement stays not measured
    assert r["sort"] is None    # no built-in default rate
    assert r["scatter"] == 10e6
    assert all(v is None for v in roofline.device_lane_rates(None).values())


def test_unmeasured_lanes_report_none(mini_index):
    from vargeno_tpu.engine.device_index import build_device_index

    dix = build_device_index(mini_index)
    cfg = GenoConfig(batch_reads=4096, max_read_len=128,
                     max_kmers_per_read=4)
    rep = roofline.roofline(cfg, dix, H100, 4096, 100_000.0)
    assert rep["lane_bound_reads_per_sec"] is None
    assert rep["lane_roofline_frac"] is None
    assert rep["bw_bound_reads_per_sec"] > 0


def test_h100_peak_and_unknown_device_raises():
    assert roofline.device_hbm_gbps(H100) == 3350.0
    with pytest.raises(KeyError, match="no published memory bandwidth"):
        roofline.device_hbm_gbps("cpu")
