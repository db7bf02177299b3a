"""A cell, a traffic mix and a metric added as files and entries alone:
the harness finds them by name, and no file that was there is edited."""

import hashlib
import json
import os
import shutil
import time

import torch

from portbench import core, run
from portbench.tests.tiny import BENCH_DIR, tiny_cell

ROOT = os.path.dirname(BENCH_DIR)

METRIC = '''"""requests_seen.batch: requests answered in the window (a count)."""


def read(ctx):
    return float(len(ctx.requests)) if ctx.requests else None
'''


def digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = hashlib.sha256(
                open(p, "rb").read()).hexdigest()
    return out


def test_a_new_cell_is_found_by_name(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = digests(tmp_path / "portbench")
    bench_dir = str(tmp_path / "portbench")

    # the new files: a traffic mix of shorter recordings, a metric
    traffic = core.read_json(os.path.join(bench_dir, "traffic",
                                          "batch32.json"))
    traffic["events"] = {"min": 5000, "max": 40000, "levels": 32}
    with open(os.path.join(bench_dir, "traffic", "short32.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(bench_dir, "metrics", "requests_seen.batch.py"),
              "w") as f:
        f.write(METRIC)
    # the new entries (BENCHMARK.json is the one file that gains lines)
    bench = core.read_json(str(tmp_path / "BENCHMARK.json"))
    bench["workloads"].append({"name": "zs_ncaltech.short32",
                               "config": "zs_ncaltech_vitl14",
                               "traffic": "short32", "chips": 1,
                               "why": "short recordings"})
    bench["per_layer"].append({
        "name": "requests_seen.batch", "unit": "requests",
        "better": "higher", "source": "program_counter", "layer": "device",
        "moves": "serve_streams_per_s",
        "workloads": ["zs_ncaltech.short32"]})

    cell = core.find_cell(bench, "zs_ncaltech.short32", bench_dir)
    assert cell.traffic["events"]["max"] == 40000
    assert cell.config_name == "zs_ncaltech_vitl14"
    assert [m["name"] for m in cell.per_layer] == ["requests_seen.batch"]
    assert set(core.metric_readers(cell)) == {"requests_seen.batch"}

    # run it at the tiny tower on the CPU, its new metric read
    tiny = tiny_cell()
    cell.config = tiny.config
    cell.traffic = dict(tiny.traffic, events={"min": 5000, "max": 15000,
                                              "levels": 4})
    res = run.run(cell, 5, 0.3, True, torch.device("cpu"), time.time(),
                  log=lambda m: None)
    assert res["correct"]
    assert res["metrics"]["requests_seen.batch"]["value"] >= 1

    after = digests(tmp_path / "portbench")
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {"traffic/short32.json",
                                        "metrics/requests_seen.batch.py"}
