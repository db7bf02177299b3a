"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds BENCHMARK.json. The run loads,
warms up, measures for `--seconds`, checks the window's answers against
the reference, and prints one JSON line last on standard output (with
`--trace 0` the cell's end-to-end metrics, with `--trace 1` its
per-layer metrics read from the device trace, spans and counters). It
needs the CUDA cards the cell asks for and never falls back to the CPU.
See portbench/README.md.
"""

from __future__ import annotations

import time

T_START = time.time()  # set-up is timed from here, before any import

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every build and kernel cache of the program stays at fixed paths inside
# the checkout, so that only a checkout's first run builds
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(HERE, ".cache", "torch_ext")
os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, ".cache", "triton")
sys.path.insert(0, ROOT)

from portbench import core, devtrace  # noqa: E402


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def run(cell: core.Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, log=log) -> dict:
    """One run of `cell` on `device` -> the result dict (the last line's
    fields) and the checks; raises nothing for a wrong answer."""
    import torch

    driver = core.load_driver(cell)
    readers = core.metric_readers(cell) if trace else {}
    from eventclip_tpu_torch import kernels, native

    cuda = device.type == "cuda"
    state = driver.setup(cell, seed, device, log)
    if cuda:
        torch.cuda.synchronize(device)
        # the peak counts from here: what the program holds while it
        # serves, not the set-up's transient copies of the weights
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    launches0, calls0 = dict(kernels.LAUNCHES), dict(native.CALLS)
    card0 = core.card_state() if cuda else "cpu"
    setup_s = time.time() - t_start
    spans = devtrace.Spans(traced=trace)
    use0, steal0 = resource.getrusage(resource.RUSAGE_SELF), core.steal_s()
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        with profile(activities=acts) as prof:
            win = driver.run_window(state, seconds, spans)
            if cuda:
                torch.cuda.synchronize(device)
    else:
        win = driver.run_window(state, seconds, spans)
    use1, steal1 = resource.getrusage(resource.RUSAGE_SELF), core.steal_s()
    card1 = core.card_state() if cuda else "cpu"
    dev = core.device_info(device, cell.chips)
    launches = {k: v - launches0.get(k, 0) for k, v in kernels.LAUNCHES.items()
                if v - launches0.get(k, 0)}
    calls = {k: v - calls0.get(k, 0) for k, v in native.CALLS.items()
             if v - calls0.get(k, 0)}
    log(f"card {dev['kind']}: before the window [{card0}], after [{card1}]")
    log(f"window {win.window_s:.3f} s, {win.attempted} requests "
        f"({win.failed} failed); launches {launches}; native calls {calls}")
    log("spans, mean ms: " + ", ".join(
        f"{k} {1e3 * sum(v) / len(v):.2f} (x{len(v)})"
        for k, v in spans.times.items()))
    log("spans, first / min / median / max ms: " + ", ".join(
        f"{k} {1e3 * v[0]:.1f} / {1e3 * min(v):.1f} / "
        f"{1e3 * statistics.median(v):.1f} / {1e3 * max(v):.1f}"
        for k, v in spans.times.items() if k != "window"))
    log(f"host in the window: user {use1.ru_utime - use0.ru_utime:.2f} s, "
        f"system {use1.ru_stime - use0.ru_stime:.2f} s, minor faults "
        f"{use1.ru_minflt - use0.ru_minflt}, involuntary switches "
        f"{use1.ru_nivcsw - use0.ru_nivcsw}; the machine's stolen CPU "
        f"{steal1 - steal0:.2f} s; cores "
        f"{len(os.sched_getaffinity(0))}, threads {torch.get_num_threads()}")
    metrics, breakdown = {}, None
    if not trace:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        values = dict(driver.end_to_end(state, win), setup_s=setup_s)
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in values.items() if k in units}
    else:
        tr = devtrace.reduce_trace(prof) if cuda else None
        ctx = types.SimpleNamespace(
            **driver.layer_context(state, win), spans=dict(spans.times),
            window_s=win.window_s, trace=tr, seed=seed,
            counters={"launches": launches, "native": calls})
        for m in cell.per_layer:
            value = readers[m["name"]](ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if tr is not None:
            dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
            breakdown = tr.breakdown()
        del prof
    checks = driver.check(state, win, log)
    correct = win.failed == 0 and all(c.ok for c in checks)
    return {"correct": correct, "attempted": win.attempted,
            "failed": win.failed, "metrics": metrics, "device": dev,
            "breakdown": breakdown, "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = core.load_bench(ROOT)
    cell = core.find_cell(bench, args.workload)
    core.require_card(cell.chips)
    import torch

    log(f"cell {cell.name}, seed {args.seed}, {args.seconds} s, trace "
        f"{args.trace}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    res = run(cell, args.seed, args.seconds, bool(args.trace),
              torch.device("cuda"), T_START)
    bad = core.forbidden_modules()
    if bad:
        log(f"the run imported {bad}: no result")
        return 3
    for c in res["checks"]:
        print(c.line(), file=sys.stderr, flush=True)
    print(core.result_line(res["correct"], res["attempted"], res["failed"],
                           res["metrics"], res["device"], res["checks"],
                           res["breakdown"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
