"""The harness's core: find a cell's files by name, run it, print the line.

A cell of `BENCHMARK.json` names a configuration and a traffic mix. Each
is a data file found by its name (`configs/<config name>.json`,
`traffic/<traffic>.json`); the traffic file names its driver
(`drivers/<driver>.py`), the entry point of the program that the measured
window drives; each per-layer metric is a reader of its own
(`metrics/<metric name>.py`, a `read(ctx)` returning a number or None).
Adding a cell, a mix or a metric adds files and entries and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
from typing import Any, Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# top-level module names a run may never hold (the JAX package and JAX)
FORBIDDEN = ("jax", "jaxlib", "flax", "eventclip_tpu")

RESULT_KEYS = ("correct", "attempted", "failed", "metrics", "device")


@dataclasses.dataclass
class Cell:
    """One workload of BENCHMARK.json with its files read."""

    name: str
    chips: int
    config_name: str
    config: Dict[str, Any]
    traffic_name: str
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    root: str = HERE


def read_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_bench(root: str = ROOT) -> Dict[str, Any]:
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise SystemExit(f"portbench: no BENCHMARK.json at {root}")
    return read_json(path)


def _reports(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(bench: Dict[str, Any], name: str,
              bench_dir: str = HERE) -> Cell:
    """The workload `name` with its configuration and traffic files, and
    the metrics it reports, found by the names BENCHMARK.json gives."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json"
                         f" (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_file = os.path.join(os.path.dirname(bench_dir),
                            configs[w["config"]]["file"])
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    layer = [m for m in bench["per_layer"] if _reports(m, name)]
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                config=read_json(cfg_file), traffic_name=w["traffic"],
                traffic=read_json(os.path.join(
                    bench_dir, "traffic", w["traffic"] + ".json")),
                end_to_end=e2e, per_layer=layer, root=bench_dir)


def load_file(path: str, label: str):
    """Import a harness file by its path (metric files carry dots), once
    a process."""
    if not os.path.exists(path):
        raise SystemExit(f"portbench: {label} {path} not found")
    name = "portbench_" + label.replace(".", "_").replace("-", "_")
    mod = sys.modules.get(name)
    if mod is not None and getattr(mod, "__file__", None) == path:
        return mod
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_driver(cell: Cell):
    name = cell.traffic["driver"]
    return load_file(os.path.join(cell.root, "drivers", name + ".py"),
                     "driver_" + name)


def metric_readers(cell: Cell) -> Dict[str, Callable]:
    return {m["name"]: load_file(
        os.path.join(cell.root, "metrics", m["name"] + ".py"),
        "metric_" + m["name"]).read for m in cell.per_layer}


# -- the card ----------------------------------------------------------------


def require_card(chips: int) -> None:
    """Refuse to run without `chips` CUDA cards: never fall back."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("portbench: no CUDA card; a run measures the card "
                         "only")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"portbench: the cell asks for {chips} cards, "
                         f"{torch.cuda.device_count()} visible")


def card_state() -> str:
    """nvidia-smi's name, SM clock, power draw and limit, temperature."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,power.draw,"
             "power.limit,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi not read: {err}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"nvidia-smi gave nothing (rc {out.returncode})"


def steal_s() -> float:
    """CPU seconds the machine's hypervisor gave to others, over all cores
    (the `steal` column of /proc/stat; 0 where there is none)."""
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        return int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return 0.0


def device_info(device, count: int) -> Dict[str, Any]:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count,
            "memory_peak_bytes": int(max(
                torch.cuda.max_memory_allocated(i) for i in range(count)))}


def forbidden_modules() -> List[str]:
    """Top-level names in sys.modules that a run may not hold, compared
    whole: `eventclip_tpu_torch` is the port, `eventclip_tpu` is not."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


# -- checks ------------------------------------------------------------------


@dataclasses.dataclass
class Check:
    """One compared number and its limit: `value` must stay at or below
    `limit` (NaN never passes)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit

    def line(self) -> str:
        return (f"check {self.name}: {self.value!r} <= {self.limit!r} "
                f"{'ok' if self.ok else 'FAILED'}")


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, Dict[str, Any]], device: Dict[str, Any],
                checks: List[Check],
                breakdown: Optional[Dict[str, Any]] = None) -> str:
    """The last line of a run: the contract's keys, then `checks`, each
    compared number beside its limit, under its own key, last."""
    out: Dict[str, Any] = {"correct": bool(correct),
                           "attempted": int(attempted),
                           "failed": int(failed), "metrics": metrics,
                           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    # a number that is not finite is written as its name: plain JSON has
    # no NaN or Infinity
    out["checks"] = {c.name: {"value": c.value if math.isfinite(c.value)
                              else repr(c.value), "limit": c.limit}
                     for c in checks}
    return json.dumps(out)
