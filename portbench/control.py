"""Readings that set a cell's limits: the program's, and its control's.

    python3 portbench/control.py --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...] [--control-seeds <n> ...] \\
        [--fault <name> --fault-seeds <n> ...]

For each `--seeds` seed, the cell runs as a benchmark run does (its own
set-up, requests and sizes; a short window) and prints each compared
number; for each `--control-seeds` seed the same, with the control in
the program's place: the program's own path one precision below the
configuration's (`control` of the configuration file, e.g. the served
model's W8A8 int8 tower, `{"int8": true}`); for each `--fault-seeds`
seed the same, with the program run and one of `faults.py`'s faults
planted underneath it. One process, on the card;
the benchmark's own runs never run this. The lower reading is the
largest the program gives, the upper the smallest the control gives;
PERF.md keeps both and the limit set between them.
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

from portbench import core, devtrace, faults  # noqa: E402


def readings(cell, seeds, seconds, device, options, log, fault=None):
    import torch

    driver = core.load_driver(cell)
    out = []
    for seed in seeds:
        t0 = time.time()
        state = driver.setup(cell, seed, device, log, options=options)
        patches = faults.Patches()
        if fault is not None:
            from eventclip_tpu_torch.serve import Predictor

            faults.FAULTS[fault](patches, Predictor)
        try:
            win = driver.run_window(state, seconds, devtrace.Spans())
        finally:
            patches.undo()
        checks = driver.check(state, win, log)
        row = {"seed": seed, "requests": win.attempted,
               "failed": win.failed,
               **{c.name: c.value for c in checks}, **state.gaps}
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
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    cell = core.find_cell(core.load_bench(), args.workload)
    core.require_card(cell.chips)
    import torch

    def log(msg):
        print(f"[control] {msg}", file=sys.stderr, flush=True)

    dev = torch.device("cuda")
    log(f"{torch.cuda.get_device_name(dev)}; {core.card_state()}")
    prog = readings(cell, args.seeds, args.seconds, dev, None, log)
    ctrl = readings(cell, args.control_seeds, args.seconds, dev,
                    cell.config["control"], log)
    bad = readings(cell, args.fault_seeds, args.seconds, dev, None, log,
                   fault=args.fault)
    summary = {}
    for name in sorted({k for r in prog + ctrl + bad for k in r} - {
            "seed", "requests", "failed"}):
        summary[name] = {
            "program_max": max((r[name] for r in prog), default=None),
            "program_min": min((r[name] for r in prog), default=None),
            "control_min": min((r[name] for r in ctrl), default=None),
            "control_max": max((r[name] for r in ctrl), default=None),
            "fault_min": min((r[name] for r in bad), default=None)}
    print(json.dumps({"program": prog, "control": ctrl, "fault": bad,
                      "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
