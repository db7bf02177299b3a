"""dense_roofline.batch against numbers worked by hand."""

import os
import types

import pytest

from portbench import core, devtrace
from portbench.tests.tiny import BENCH_DIR

VITL = core.read_json(os.path.join(
    BENCH_DIR, "configs", "zs_ncaltech_vitl14.json"))["vision"]


def metric():
    return core.load_file(os.path.join(BENCH_DIR, "metrics",
                                       "dense_roofline.batch.py"),
                          "metric_dense_roofline.batch")


def test_d1_bound_of_a_serving_request():
    # 2 (320 x 257) 24 (3d^2 + d^2 + 2 d m) = 4.97e13 operations at 989
    # TFLOP/s: 50.2 ms; every product's bytes are far below its operations
    ops = 2 * 320 * 257 * 24 * (4 * 1024 ** 2 + 2 * 1024 * 4096)
    assert ops == pytest.approx(4.97e13, rel=1e-3)
    assert metric().request_bound_s(320, VITL) == pytest.approx(
        ops / 989e12, rel=1e-9)
    assert metric().request_bound_s(320, VITL) * 1e3 == pytest.approx(
        50.2, abs=0.05)


def test_share_counts_the_launches_the_trace_holds():
    m = metric()
    t = m.request_bound_s(320, VITL) / 96 * 2  # each launch twice its bound
    trace = devtrace.Trace([("void dense_wgmma_kernel<256, true>", i, t)
                            for i in range(96 * 2 - 1)]
                           + [("nvjet_tss_other", 500, 1.0)], [],
                           (0.0, 600.0))
    ctx = types.SimpleNamespace(config={"vision": VITL}, trace=trace,
                                requests=[{"bucket": 320}] * 2)
    assert m.read(ctx) == pytest.approx(50.0)


def test_no_d1_in_the_trace_reads_nothing():
    # the parent commit, which has no D1: no number, never 0
    ctx = types.SimpleNamespace(
        config={"vision": VITL}, requests=[{"bucket": 320}],
        trace=devtrace.Trace([("nvjet_tss_192x192", 0, 1e-3)], [],
                             (0.0, 1.0)))
    assert metric().read(ctx) is None
    ctx.trace = None
    assert metric().read(ctx) is None
