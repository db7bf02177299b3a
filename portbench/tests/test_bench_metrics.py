"""The metric arithmetic against numbers worked by hand."""

import json
import os
import types

import pytest

from portbench import core, devtrace, peaks
from portbench.tests.tiny import BENCH_DIR

VITL = core.read_json(os.path.join(
    BENCH_DIR, "configs", "zs_ncaltech_vitl14.json"))["vision"]


def metric(name):
    return core.load_file(os.path.join(BENCH_DIR, "metrics", name + ".py"),
                          "metric_" + name)


def test_k2_bound_at_the_serving_shape():
    # [320, 257, 3072] bf16 in, [320, 257, 1024] out: 673.7 MB at 3.35 TB/s
    k2 = metric("k2_roofline.batch")
    assert k2.k2_bound_s(320, VITL) * 1e3 == pytest.approx(0.2011, abs=5e-5)
    assert 320 * 257 * 4096 * 2 == 673710080


def test_k1_bound_at_the_serving_shape():
    k1 = metric("k1_roofline.batch")
    assert k1.k1_bound_s(320, 20000, 180, 240) * 1e3 == pytest.approx(
        0.0445, abs=5e-5)


def test_vit_l14_forward_is_162_gflop():
    assert metric("mfu.batch").vit_forward_flops(VITL) / 1e9 == \
        pytest.approx(162.0, abs=0.05)


def test_mfu_counts_valid_views_over_the_window():
    ctx = types.SimpleNamespace(
        config={"vision": VITL}, window_s=2.0,
        requests=[{"valid_views": 250, "bucket": 320}] * 4)
    want = 100 * 1000 * 161.98e9 / (2.0 * 989e12)
    assert metric("mfu.batch").read(ctx) == pytest.approx(want, rel=1e-3)


def test_roofline_share_is_bound_over_device_time():
    k2 = metric("k2_roofline.batch")
    t = k2.k2_bound_s(320, VITL) * 2  # each launch twice its bound
    trace = devtrace.Trace([("attention_wgmma_kernel", i, t)
                            for i in range(48)] + [("other", 50, 1.0)],
                           [], (0.0, 60.0))
    ctx = types.SimpleNamespace(config={"vision": VITL}, trace=trace,
                                requests=[{"bucket": 320}] * 2)
    assert k2.read(ctx) == pytest.approx(50.0)
    ctx.trace = devtrace.Trace([], [], (0.0, 1.0))
    assert k2.read(ctx) is None  # no kernel read: no number, never 0


def test_serving_rate_is_all_streams_over_all_the_window():
    drv = core.load_file(os.path.join(BENCH_DIR, "drivers",
                                      "serve_batch.py"), "driver_serve")
    win = drv.Window(records=[{"req": [(0, 0)] * 32}] * 3, window_s=1.5,
                     attempted=4, failed=1)
    assert drv.end_to_end(None, win) == {"serve_streams_per_s": 64.0}


def test_idle_share_is_one_minus_the_union():
    idle = metric("idle_share.batch")
    # overlapping kernels on [0, 1] and [0.5, 2], one on [3, 4]: busy 3 of 5
    trace = devtrace.Trace([("a", 0.0, 1.0), ("b", 0.5, 1.5),
                            ("c", 3.0, 1.0)], [], (0.0, 5.0))
    assert trace.busy_s == pytest.approx(3.0)
    assert idle.read(types.SimpleNamespace(trace=trace)) == \
        pytest.approx(40.0)
    assert devtrace.gaps([(0, 2), (1, 3), (5, 6)], 0, 7) == [(3, 5), (6, 7)]


def test_idle_gaps_take_the_innermost_range_open_halfway():
    trace = devtrace.Trace(
        [("k", 1.0, 1.0), ("k", 4.0, 1.0)],
        [("portbench.window", 0.0, 6.0), ("portbench.host_window", 2.5,
                                          3.9)], (0.0, 6.0))
    out = trace.breakdown()
    assert out["idle_gaps"][0] == ["host_window", pytest.approx(2.0)]
    assert out["device_ops"] == [["k", 2.0]]
    json.dumps(out)


def test_host_spans_are_means_a_request():
    ctx = types.SimpleNamespace(spans={"host_window": [0.1, 0.3]})
    assert metric("host_window_ms.batch").read(ctx) == pytest.approx(200.0)
    assert metric("device_phase_ms.batch").read(ctx) is None


def test_peaks_are_the_data_sheets():
    assert peaks.HBM_BYTES_PER_S == 3.35e12
    assert peaks.FLOPS_PER_S["bfloat16"] == 989e12
