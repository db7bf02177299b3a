"""Driver `serve_batch`: zero-shot classification of batches of recordings
through `eventclip_tpu_torch.serve.Predictor`, one client in a closed loop.

Set-up makes the towers' weights and the class features on the card from
the seed (`weights.py`), builds the Predictor on a copy of them and frees
the benchmark's own, makes the stream pool (`streams.py`) and sends one
whole request: every request carries the same number of valid views
(`streams.py`), so that request runs the one packing bucket the traffic
reaches. The window then sends request after request of `batch` streams,
each through `gather_windows` (the host half) and `predict_windows` (the
device phase), as `Predictor.predict` does, each call in a span of its
own. Afterwards the program is freed, the weights are made again from the
seed, and the reference classifies a sample of the answered streams,
drawn from the seed, the longest recording among them.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Any, Dict, List

import numpy as np
import torch

from portbench import core, streams, weights
from portbench.reference import vit, zero_shot


@dataclasses.dataclass
class State:
    cell: core.Cell
    seed: int
    device: torch.device
    pred: Any
    pool: List[List[np.ndarray]]
    schedule: Any
    geometry: Dict[str, Any]
    buckets: List[int]


def geometry(cfg: Dict[str, Any]) -> Dict[str, Any]:
    ds, q = cfg["dataset"], cfg["params"]["quantize_args"]
    window = int(q["N"])
    views = max(min(round(ds["max_n"] / window), cfg["serve"]["views"]), 1)
    return {"height": ds["resolution"][0], "width": ds["resolution"][1],
            "window": window, "views": views}


def setup(cell: core.Cell, seed: int, device, log,
          options: Dict[str, Any] = None) -> State:
    """`options`: further Predictor arguments (the control's `int8`)."""
    from eventclip_tpu_torch.data.loader import eval_pack_buckets
    from eventclip_tpu_torch.models.clip.config import clip_arch_config
    from eventclip_tpu_torch.serve import Predictor
    from eventclip_tpu_torch.utils.config import Params

    cfg, tr = cell.config, cell.traffic
    if tr["batch"] != tr["events"]["levels"]:
        raise SystemExit("serve_batch: a request takes one stream of each "
                         "length level, so batch must equal levels")
    clip_cfg = clip_arch_config(cfg["arch"])
    v = clip_cfg.vision
    for key, got in (("image_size", v.image_size), ("patch_size",
                     v.patch_size), ("width", v.width), ("layers", v.layers),
                     ("heads", v.heads), ("output_dim", v.output_dim),
                     ("mlp_width", 4 * v.width)):
        if cfg["vision"][key] != got:
            raise SystemExit(f"serve_batch: the port's {cfg['arch']} has "
                             f"{key} {got}, the configuration "
                             f"{cfg['vision'][key]}")
    geo = geometry(cfg)
    t0 = time.perf_counter()
    pool = streams.stream_pool(tr, (geo["height"], geo["width"]), seed)
    log(f"stream pool: {sum(map(len, pool))} streams in "
        f"{time.perf_counter() - t0:.2f} s")
    w, text = weights.make_weights(cfg, seed, device)
    clip = weights.port_clip(w, clip_cfg, device)
    params = Params(**cfg["params"])
    names = [f"class_{i}" for i in range(cfg["n_classes"])]
    pred = Predictor(params, names, clip_params=clip, text_feats=text,
                     batch_size=tr["batch"], device=device, **(options or {}))
    del clip, w, text
    if (pred.window, pred.views, tuple(pred.resolution)) != (
            geo["window"], geo["views"], (geo["height"], geo["width"])):
        raise SystemExit("serve_batch: the Predictor's windows differ from "
                         "the configuration's")
    # one whole request: the packing bucket every request lands in, the
    # host half's first call (it loads the native library) and the first
    # fetch
    pred.predict([copies[0] for copies in pool])
    return State(cell=cell, seed=seed, device=device, pred=pred, pool=pool,
                 schedule=streams.request_schedule(tr, seed), geometry=geo,
                 buckets=eval_pack_buckets(tr["batch"], geo["views"], 1))


@dataclasses.dataclass
class Window:
    records: List[Dict[str, Any]]
    window_s: float
    attempted: int
    failed: int


def run_window(state: State, seconds: float, spans) -> Window:
    """Requests back to back until `seconds` have passed; the window ends
    when the request that crosses the deadline is answered."""
    records, failed = [], 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    with spans("window"):
        while True:
            req = next(state.schedule)
            batch = [state.pool[lvl][c] for lvl, c in req]
            try:
                with spans("host_window"):
                    wins, valids = state.pred.gather_windows(batch)
                with spans("device_phase"):
                    out = state.pred.predict_windows(wins, valids)
            except Exception as err:  # a failed request counts, and on
                failed += 1
                print(f"request failed: {err!r}", file=sys.stderr,
                      flush=True)
                out, valids = None, None
            if out is not None:
                n = int(valids.sum())
                records.append({
                    "req": req, "probs": np.asarray(out["probs"]),
                    "valid_views": n,
                    "bucket": min([k for k in state.buckets if k >= n]
                                  or [len(batch) * state.geometry["views"]])})
            if time.perf_counter() >= deadline:
                break
    return Window(records, time.perf_counter() - t0,
                  len(records) + failed, failed)


def end_to_end(state: State, win: Window) -> Dict[str, float]:
    n = sum(len(r["req"]) for r in win.records)
    return {"serve_streams_per_s": n / win.window_s}


def layer_context(state: State, win: Window) -> Dict[str, Any]:
    return {"requests": win.records, "geometry": state.geometry,
            "config": state.cell.config}


def reference_geometry(state: State) -> Dict[str, Any]:
    cfg = state.cell.config
    v = cfg["vision"]
    q = cfg["params"]["quantize_args"]
    if not (q.get("grayscale", True) and q.get("background_mask", True)
            and not q.get("count_non_zero", False)):
        raise SystemExit("serve_batch: the reference draws grey frames over "
                         "white with counts over all pixels only")
    return dict(state.geometry, layers=v["layers"], heads=v["heads"],
                image_size=v["image_size"],
                logit_scale=float(cfg["params"]["clip_dict"].get(
                    "logit_scale", 100.0)), thresh=10.0, grey=127.0)


def sample(state: State, win: Window) -> List[tuple]:
    """(record, position) pairs drawn from the seed, one of them the
    longest stream answered."""
    every = [(i, j) for i, r in enumerate(win.records)
             for j in range(len(r["req"]))]
    if not every:
        return []
    k = min(int(state.cell.traffic["check"]["streams"]), len(every))
    rng = np.random.default_rng((state.seed, 0xC4EC))
    picked = [every[i] for i in rng.choice(len(every), k, replace=False)]
    top = len(state.pool) - 1
    if all(win.records[i]["req"][j][0] != top for i, j in picked):
        i = int(rng.integers(len(win.records)))
        picked[0] = (i, [lvl for lvl, _ in win.records[i]["req"]].index(top))
    return picked


def free_program(state: State) -> None:
    state.pred = None
    gc.collect()
    if state.device.type == "cuda":
        torch.cuda.empty_cache()


def gap_stats(per: np.ndarray, per_bf16: np.ndarray) -> Dict[str, float]:
    """The per-stream gaps of the program (`per`) over those of the
    bfloat16-storage reference (`per_bf16`): the widest over the widest,
    and the mean over the mean. The ratios set aside how sensitive each
    seed's tower is; both reach every stream of the sample, so a fault in a
    few answers shows in the widest once one of them is drawn, and one in
    many answers in the mean."""
    return {"probs_gap_max_ratio": float(per.max() / per_bf16.max()),
            "probs_gap_mean_ratio": float(per.mean() / per_bf16.mean())}


def check(state: State, win: Window, log) -> List[core.Check]:
    """The answers of a sample of the window's streams against the
    reference's. A stream's gap is the root mean square over the classes of
    its probability differences from the float32 reference; the compared
    numbers (`limits` of the configuration, from `gap_stats`) put the
    sample's gaps over those of the same reference computed in the
    configuration's bfloat16 storage (`vit.to_bf16`): what the program
    loses to the float32 reference, in units of what bfloat16 itself costs
    on these weights and recordings. Logged beside them: the gaps, and the
    spread of the reference's answers between neighbouring recordings of
    the sample, which stands far above the gaps (random towers that sent
    every recording to one answer could fail no comparison)."""
    limits = state.cell.config["limits"]
    picked = sample(state, win)
    if not picked:
        return [core.Check(k, float("nan"), v) for k, v in limits.items()]
    free_program(state)
    t0 = time.perf_counter()
    w, text = weights.make_weights(state.cell.config, state.seed,
                                   state.device)
    chosen = [state.pool[lvl][c] for lvl, c in
              (win.records[i]["req"][j] for i, j in picked)]
    geo = reference_geometry(state)
    ref = zero_shot.stream_probs(chosen, w, text, geo)
    emu = zero_shot.stream_probs(chosen, w, text, geo, rnd=vit.to_bf16)
    got = np.stack([win.records[i]["probs"][j] for i, j in picked])

    def gaps(x):
        if not np.isfinite(x).all():
            return np.full(len(x), np.inf)
        return np.sqrt(np.mean((x - ref) ** 2, axis=-1))

    per, per_emu = gaps(got), gaps(emu)
    state.gaps = dict(
        gap_stats(per, per_emu), median=float(np.median(per)),
        max=float(per.max()), bf16_median=float(np.median(per_emu)),
        bf16_max=float(per_emu.max()),
        spread_median=float(np.median(gaps(np.roll(ref, 1, axis=0)))))
    log(f"reference: {len(picked)} streams in "
        f"{time.perf_counter() - t0:.2f} s; gaps {state.gaps}")
    return [core.Check(k, state.gaps[k], v) for k, v in limits.items()]
