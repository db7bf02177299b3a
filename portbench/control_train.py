"""Readings that set a training cell's limits: the program's, its
control's and its planted faults'.

    python3 portbench/control_train.py --workload <cell> \\
        --seeds <n> [<n> ...] [--control-seeds <n> ...] \\
        [--storage e4m3|bf16] [--fault <name> --fault-seeds <n> ...]

For each `--seeds` seed the cell's set-up runs as a benchmark run's does
(its recordings, trainer and checked steps), then its check, without the
window (the checked steps are set-up's); for each `--control-seeds` seed
the reference in `--storage` (the configuration's `control` by default:
float8 e4m3 storage, one precision below its bfloat16) takes the
program's place in the checked steps; for each `--fault-seeds` seed the
program runs with one of `faults_train.py`'s faults planted underneath.
One process, on the card; the benchmark's own runs never run this. The
lower reading is the largest the program gives, the upper the smallest
the control or a fault gives; PERF.md keeps them and the limits set
between them.
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

from portbench import core, faults, faults_train  # noqa: E402

INFO = ("losses", "ref_losses", "left_out", "grad_worst", "change_worst")


def readings(cell, seeds, device, log, options=None, fault=None):
    import torch

    driver = core.load_driver(cell)
    out = []
    for seed in seeds:
        t0 = time.time()
        patches = faults.Patches()
        if fault is not None:
            faults_train.FAULTS[fault](patches)
        try:
            state = driver.setup(cell, seed, device, log, options=options)
        finally:
            patches.undo()
        checks = driver.check(state, None, log)
        row = {"seed": seed, **{c.name: c.value for c in checks},
               **state.gaps}
        log(json.dumps(row) + f"  ({time.time() - t0:.1f} s)")
        out.append(row)
        del state
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def summary(prog, ctrl, bad):
    out = {}
    for name in sorted({k for r in prog + ctrl + bad for k in r}
                       - {"seed", *INFO}):
        def vals(rows):
            return [r[name] for r in rows if name in r]
        out[name] = {"program_max": max(vals(prog), default=None),
                     "program_min": min(vals(prog), default=None),
                     "control_min": min(vals(ctrl), default=None),
                     "control_max": max(vals(ctrl), default=None),
                     "fault_min": min(vals(bad), default=None)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--storage", choices=("e4m3", "bf16"))
    ap.add_argument("--fault", choices=sorted(faults_train.FAULTS))
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    # the caches of run.py, at the same fixed paths inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(HERE, ".cache",
                                                      "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, ".cache", "triton")
    cell = core.find_cell(core.load_bench(), args.workload)
    core.require_card(cell.chips)
    import torch

    def log(msg):
        print(f"[control] {msg}", file=sys.stderr, flush=True)

    dev = torch.device("cuda")
    log(f"{torch.cuda.get_device_name(dev)}; {core.card_state()}")
    prog = readings(cell, args.seeds, dev, log)
    ctrl = readings(cell, args.control_seeds, dev, log, options={
        "storage": args.storage or cell.config["control"]["storage"]})
    bad = readings(cell, args.fault_seeds, dev, log, fault=args.fault)
    print(json.dumps({"program": prog, "control": ctrl, "fault": bad,
                      "summary": summary(prog, ctrl, bad)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
