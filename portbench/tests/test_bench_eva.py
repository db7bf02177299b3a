"""The EVA02 cell (`zs_ncaltech_eva02.batch32`, driver `serve_eva`) and the
short-burst cell (`zs_ncaltech.short32`): found by name, run on the CPU at
a tiny size through `run.run`, failed by every planted fault of
`faults_eva.py`; the EVA metric readers on synthetic traces."""

import copy
import os
import time
import types

import pytest
import torch

from portbench import core, devtrace, faults, faults_eva, run
from portbench.tests.tiny import BENCH_DIR, tiny_cell

ROOT = os.path.dirname(BENCH_DIR)
EVA = "zs_ncaltech_eva02.batch32"
SHORT = "zs_ncaltech.short32"
METRICS = ("rope_roofline.eva", "dense_roofline.eva", "swiglu_ms.eva",
           "mfu.eva", "idle_share.eva")
# the serving cell's readers whose layers the new cells run too
EVA_BATCH = ("host_window_ms.batch", "device_phase_ms.batch",
             "k1_roofline.batch", "k2_roofline.batch")
SHORT_BATCH = ("host_window_ms.batch", "device_phase_ms.batch",
               "idle_share.batch", "k1_roofline.batch", "seed_ms.batch",
               "stream_prep_ms.batch", "enqueue_ms.batch",
               "fetch_wait_ms.batch")


def bench():
    return core.load_bench(ROOT)


def tiny_eva_cell() -> core.Cell:
    """The EVA cell at the EVA02-T/8@48 debug tower (a hidden of 170
    stored as 176, a grid of 6 rotated at 4 positions) in float32,
    requests of 4 short recordings."""
    cell = core.find_cell(bench(), EVA, BENCH_DIR)
    cfg = copy.deepcopy(cell.config)
    cfg["arch"] = "EVA02-T/8@48"
    cfg["params"]["clip_dict"]["arch"] = "EVA02-T/8@48"
    cfg["params"]["bf16"] = False
    cfg["vision"] = dict(cfg["vision"], image_size=48, patch_size=8,
                         width=64, layers=2, heads=2, mlp_hidden=170,
                         output_dim=32, pt_hw_seq_len=4)
    # sharp attention and small embeddings keep the frames' answers apart
    cfg["init"] = dict(cfg["init"], **{
        "head.weight": [0.0, 0.0025], "head.bias": [0.0, 0.0025],
        "cls_token": [0.0, 0.01], "pos_embed": [0.0, 0.01],
        "attn.q_proj.weight": [0.0, 0.4], "attn.k_proj.weight": [0.0, 0.4],
        "mlp.w3.weight": [0.0, 0.1]})
    cfg["limits"] = {k: 0.01 for k in cfg["limits"]}
    tr = copy.deepcopy(cell.traffic)
    tr.update(batch=4, copies=2, events={"min": 20000, "max": 60000,
                                         "levels": 4},
              check={"streams": 6})
    cell.config, cell.traffic = cfg, tr
    return cell


def test_the_new_cells_are_found_by_name():
    b = bench()
    eva = core.find_cell(b, EVA, BENCH_DIR)
    assert eva.config["arch"] == "EVA02-CLIP-L-14-336"
    assert eva.traffic["driver"] == "serve_eva"
    assert eva.config["reduced"] == [] and eva.chips == 1
    assert [m["name"] for m in eva.end_to_end] == ["serve_streams_per_s",
                                                   "setup_s"]
    assert {m["name"] for m in eva.per_layer} == set(METRICS + EVA_BATCH)
    assert set(core.metric_readers(eva)) == set(METRICS + EVA_BATCH)
    assert core.load_driver(eva).check
    short = core.find_cell(b, SHORT, BENCH_DIR)
    assert short.config_name == "zs_ncaltech_vitl14"
    assert short.traffic["driver"] == "serve_batch"
    assert short.traffic["events"] == {"min": 5000, "max": 40000,
                                       "levels": 32}
    assert [m["name"] for m in short.end_to_end] == ["serve_streams_per_s",
                                                     "setup_s"]
    assert {m["name"] for m in short.per_layer} == set(SHORT_BATCH)


def test_the_eva_cell_runs_correct_on_the_cpu():
    res = run.run(tiny_eva_cell(), 5, 0.3, False, torch.device("cpu"),
                  time.time(), log=lambda m: None)
    assert res["correct"], [c.line() for c in res["checks"]]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"serve_streams_per_s", "setup_s"}


def test_the_short_cell_runs_correct_on_the_cpu():
    cell = core.find_cell(bench(), SHORT, BENCH_DIR)
    tiny = tiny_cell()
    cell.config = tiny.config
    cell.traffic = dict(tiny.traffic, events={"min": 5000, "max": 15000,
                                              "levels": 4})
    res = run.run(cell, 6, 0.3, True, torch.device("cpu"), time.time(),
                  log=lambda m: None)
    assert res["correct"], [c.line() for c in res["checks"]]
    assert "host_window_ms.batch" in res["metrics"]


@pytest.mark.parametrize("fault", sorted(faults_eva.FAULTS))
def test_every_fault_fails_the_eva_cell(fault):
    cell = tiny_eva_cell()
    driver = core.load_driver(cell)
    patches = faults.Patches()
    faults_eva.FAULTS[fault](patches)
    try:
        state = driver.setup(cell, 5, torch.device("cpu"), lambda m: None)
        win = driver.run_window(state, 0.2, devtrace.Spans())
        checks = driver.check(state, win, lambda m: None)
    finally:
        patches.undo()
    assert not all(c.ok for c in checks), [c.line() for c in checks]


def test_the_control_fails_the_eva_cell():
    cell = tiny_eva_cell()
    driver = core.load_driver(cell)
    state = driver.setup(cell, 5, torch.device("cpu"), lambda m: None,
                         options=cell.config["control"])
    win = driver.run_window(state, 0.2, devtrace.Spans())
    checks = driver.check(state, win, lambda m: None)
    assert not all(c.ok for c in checks), [c.line() for c in checks]


GEOMETRY = {"window": 20000, "height": 180, "width": 240}


def _ctx(kernels, requests, window=(0.0, 1.0)):
    cfg = core.read_json(os.path.join(BENCH_DIR, "configs",
                                      "zs_ncaltech_eva02l14_336.json"))
    return types.SimpleNamespace(
        trace=devtrace.Trace(kernels, [], window), requests=requests,
        config=cfg, window_s=window[1] - window[0], spans={},
        counters={}, geometry=GEOMETRY)


def test_the_eva_readers_read_a_synthetic_trace():
    readers = core.metric_readers(core.find_cell(bench(), EVA, BENCH_DIR))
    mods = {m: core.load_file(os.path.join(BENCH_DIR, "metrics", m + ".py"),
                              "metric_" + m) for m in METRICS}
    reqs = [{"valid_views": 255, "bucket": 320, "req": []}] * 2
    # per request: one K1 launch and 24 launches of each other kernel at
    # twice its bound, 24 swiglu ranges of 3 ms
    rope = mods["rope_roofline.eva"].rope_bound_s
    batch = {m: core.load_file(os.path.join(BENCH_DIR, "metrics",
                                            m + ".py"), "metric_" + m)
             for m in ("k1_roofline.batch", "k2_roofline.batch")}
    k2 = batch["k2_roofline.batch"].k2_bound_s
    k1 = 2 * batch["k1_roofline.batch"].k1_bound_s(
        320, GEOMETRY["window"], GEOMETRY["height"], GEOMETRY["width"])
    dense = mods["dense_roofline.eva"].request_bound_s
    v = _ctx([], reqs).config["vision"]
    kernels, t = [], 0.0
    for _ in range(2):
        kernels.append(("hist_kernel", t, k1))
        t += k1
        for _ in range(24):
            for name, d in (("rope_qkv_kernel", 2 * rope(320, v)),
                            ("attention_wgmma_kernel", 2 * k2(320, v)),
                            ("swiglu", 0.003)):
                kernels.append((name, t, d))
                t += d
            for _ in range(4):
                d = 2 * dense(320, v) / 96
                kernels.append(("dense_wgmma_kernel", t, d))
                t += d
    ctx = _ctx(kernels, reqs, (0.0, 2 * t))
    got = {m: readers[m](ctx) for m in METRICS + tuple(batch)}
    for m in ("rope_roofline.eva", "dense_roofline.eva", *batch):
        assert got[m] == pytest.approx(50.0), m
    assert got["swiglu_ms.eva"] == pytest.approx(72.0)
    busy = t - 48 * 0.003
    assert got["idle_share.eva"] == pytest.approx(
        100 * (1 - busy / (2 * t)))
    assert got["mfu.eva"] == pytest.approx(
        100 * 510 * 381.863067648e9 / (2 * t * 989e12))
    assert all(0 <= x <= 100 for k, x in got.items() if "ms" not in k)
    # nothing to read: no trace, or a trace without the kernels
    empty = _ctx([("other", 0.0, 0.1)], reqs)
    for m in ("rope_roofline.eva", "dense_roofline.eva", "swiglu_ms.eva",
              *batch):
        assert readers[m](empty) is None
        assert readers[m](types.SimpleNamespace(
            trace=None, requests=reqs, config=empty.config)) is None
