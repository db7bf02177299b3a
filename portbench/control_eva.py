"""Readings that set an EVA02 serving cell's limits: the program's, its
control's and its planted faults'.

    python3 portbench/control_eva.py --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...] [--control-seeds <n> ...] \\
        [--faults <name> [<name> ...] --fault-seeds <n> ...]

For each `--seeds` seed the cell runs as a benchmark run does (its own
set-up, requests and sizes; a short window) and prints each compared
number; for each `--control-seeds` seed the same, with the reference in
the configuration's `control` storage (float8 e4m3, a scale a tensor,
one precision below its bfloat16) in the program's place; for each fault
of `--faults` and each `--fault-seeds` seed the same, with the program
run and that fault of `faults_eva.py` planted before set-up. One process,
on the card; the benchmark's own runs never run this. The program and
control readings are `control.py`'s (loaded by its path).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from portbench import core, devtrace, faults, faults_eva  # noqa: E402

CONTROL = core.load_file(os.path.join(HERE, "control.py"), "control")


def fault_readings(cell, fault, seeds, seconds, device, log):
    import torch

    driver = core.load_driver(cell)
    out = []
    for seed in seeds:
        t0 = time.time()
        patches = faults.Patches()
        faults_eva.FAULTS[fault](patches)
        try:
            state = driver.setup(cell, seed, device, log)
            win = driver.run_window(state, seconds, devtrace.Spans())
            checks = driver.check(state, win, log)
        finally:
            patches.undo()
        row = {"fault": fault, "seed": seed, "requests": win.attempted,
               "failed": win.failed,
               **{c.name: c.value for c in checks}, **state.gaps,
               "fails": [c.name for c in checks if not c.ok]}
        log(json.dumps(row) + f"  ({time.time() - t0:.1f} s)")
        out.append(row)
        del state, win
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[],
                    choices=sorted(faults_eva.FAULTS))
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    cell = core.find_cell(core.load_bench(), args.workload)
    core.require_card(cell.chips)
    import torch

    def log(msg):
        print(f"[control_eva] {msg}", file=sys.stderr, flush=True)

    dev = torch.device("cuda")
    log(f"{torch.cuda.get_device_name(dev)}; {core.card_state()}")
    prog = CONTROL.readings(cell, args.seeds, args.seconds, dev, None, log)
    ctrl = CONTROL.readings(cell, args.control_seeds, args.seconds, dev,
                            cell.config["control"], log)
    bad = [r for f in args.faults for r in fault_readings(
        cell, f, args.fault_seeds, args.seconds, dev, log)]
    names = sorted(cell.config["limits"])
    summary = {n: {"program_max": max((r[n] for r in prog), default=None),
                   "control_min": min((r[n] for r in ctrl), default=None),
                   **{f"{f}_min": min((r[n] for r in bad if r["fault"] == f),
                                      default=None) for f in args.faults}}
               for n in names}
    print(json.dumps({"program": prog, "control": ctrl, "fault": bad,
                      "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
