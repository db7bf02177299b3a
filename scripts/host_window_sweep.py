#!/usr/bin/env python
"""Time `serve.Predictor.gather_windows` (the serving host half) at each
count of worker threads, on the serving cells' own traffic.

Usage: python scripts/host_window_sweep.py [--traffic batch32 short32]
           [--workers 1,2,4,8] [--requests 12] [--seed 1] [--out x.json]

Streams and requests come from `portbench/streams.py` with a traffic file
of `portbench/traffic/` and `--seed`; the Predictor has the geometry of
`portbench/configs/zs_ncaltech_vitl14.json` (N-Caltech101, N = 20000, 10
views) over a ViT-T/8@32 tower on the CPU, which the host half never
touches. Each request is windowed once at every worker count in turn
(the counts interleaved, so that a drift of the host reaches them alike),
after one untimed request at each; the windows and masks must be
bit-identical at every count. Prints one JSON line: the cores this
process may run on, `serve.WORKER_EVENTS` and the count it picks for each
traffic, and per traffic and count the median and quartiles of the ms a
request. `WORKER_EVENTS` is read from such a sweep on the serving host.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from eventclip_tpu_torch import serve  # noqa: E402
from portbench import streams  # noqa: E402


def predictor() -> serve.Predictor:
    from eventclip_tpu_torch.utils.config import Params

    with open(os.path.join(ROOT, "portbench", "configs",
                           "zs_ncaltech_vitl14.json")) as f:
        params = json.load(f)["params"]
    params = dict(params, bf16=False,
                  clip_dict=dict(params["clip_dict"], arch="ViT-T/8@32"))
    text = np.eye(2, 512, dtype=np.float32)
    return serve.Predictor(Params(**params), ["a", "b"], text_feats=text,
                           device="cpu")


def sweep(pred: serve.Predictor, traffic: dict, workers, n_requests: int,
          seed: int) -> dict:
    """ms a request at each worker count over `n_requests` requests of
    `traffic` (a traffic file's parameters)."""
    pool = streams.stream_pool(traffic, tuple(pred.resolution), seed)
    schedule = streams.request_schedule(traffic, seed)
    requests = [[pool[lvl][c] for lvl, c in next(schedule)]
                for _ in range(n_requests + 1)]
    ms = {k: [] for k in workers}
    for r, req in enumerate(requests):
        want = None
        for k in workers:
            pred._workers = lambda _streams, k=k: k
            t0 = time.perf_counter()
            got = pred.gather_windows(req)
            dt = time.perf_counter() - t0
            if r:  # the first request is a warm-up
                ms[k].append(1e3 * dt)
            if want is None:
                want = got
            for a, b in zip(got, want):
                if a.dtype != b.dtype or not np.array_equal(a, b):
                    raise SystemExit(f"{k} workers changed the windows")
    del pred._workers
    total = sum(len(s) for s in requests[0])
    out = {"events_a_request": total, "picked": pred._workers(requests[0])}
    for k, v in ms.items():
        q = statistics.quantiles(v, n=4) if len(v) > 1 else v * 3
        out[str(k)] = {"median_ms": statistics.median(v),
                       "q1_ms": q[0], "q3_ms": q[2]}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--traffic", nargs="+", default=["batch32", "short32"])
    ap.add_argument("--workers", default="",
                    help="comma-separated counts (default 1 to the cores)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default="", help="also write the line here")
    args = ap.parse_args(argv)
    cores = len(os.sched_getaffinity(0))
    workers = ([int(k) for k in args.workers.split(",")] if args.workers
               else list(range(1, cores + 1)))
    pred = predictor()
    res = {"cores": cores, "cpu_count": os.cpu_count(),
           "worker_events": serve.WORKER_EVENTS}
    for name in args.traffic:
        with open(os.path.join(ROOT, "portbench", "traffic",
                               f"{name}.json")) as f:
            traffic = json.load(f)
        res[name] = sweep(pred, traffic, workers, args.requests, args.seed)
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return res


if __name__ == "__main__":
    main()
