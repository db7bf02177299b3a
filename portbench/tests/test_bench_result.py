"""The last line, and the refusals without a card."""

import json
import os
import shutil
import subprocess
import sys

from portbench import core
from portbench.tests.tiny import BENCH_DIR

ROOT = os.path.dirname(BENCH_DIR)


def test_last_line_holds_the_contracts_keys_then_the_checks():
    checks = [core.Check("probs_gap_ratio", 0.01, 0.05),
              core.Check("other", float("inf"), 0.1)]
    line = core.result_line(True, 10, 0, {"x": {"value": 1.0, "unit": "s"}},
                            {"platform": "gpu", "kind": "k", "count": 1,
                             "memory_peak_bytes": 5}, checks)
    out = json.loads(line)
    assert list(out) == list(core.RESULT_KEYS) + ["checks"]
    assert out["checks"] == {"probs_gap_ratio": {"value": 0.01,
                                                 "limit": 0.05},
                             "other": {"value": "inf", "limit": 0.1}}
    line = core.result_line(False, 1, 1, {}, {}, checks,
                            breakdown={"device_ops": [], "idle_gaps": []})
    assert list(json.loads(line)) == list(core.RESULT_KEYS) + [
        "breakdown", "checks"]


def test_a_check_fails_on_nan_and_on_the_wrong_side():
    assert not core.Check("a", float("nan"), 1.0).ok
    assert not core.Check("a", 2.0, 1.0).ok
    assert not core.Check("a", float("inf"), 1.0).ok
    assert core.Check("a", 1.0, 1.0).ok
    assert "FAILED" in core.Check("a", 2.0, 1.0).line()


def run_cli(cwd, *extra):
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "zs_ncaltech.batch32", "--seed", str(2 ** 32 + 3), "--seconds",
         "1", "--trace", "0", *extra], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    out = run_cli(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA card" in out.stderr


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = run_cli(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_an_unknown_workload_is_refused():
    bench = core.load_bench(ROOT)
    try:
        core.find_cell(bench, "no.such_cell")
    except SystemExit as err:
        assert "no workload" in str(err)
    else:
        raise AssertionError("found a cell that is not there")
