"""Driver `serve_eva`: zero-shot classification of batches of recordings
through `eventclip_tpu_torch.serve.Predictor` on an EVA02-CLIP image tower
(models/clip/eva.py), one client in a closed loop.

The window, its end-to-end metric, its per-layer context and the sample
the check draws are `serve_batch`'s (loaded by its path). Set-up differs
in the tower: the port's arch (`arch` of the configuration) is checked
against the configuration's published widths, and the weights are made
from the seed in EVA-CLIP's names (`weights_eva.py`) and copied into the
port's layout. The check runs `reference/eva02.py` on the sample: the
program's per-stream gap from the float32 reference over the gap of the
reference in the configuration's bfloat16 storage (`serve_batch.gap_stats`).
With the option `storage` (the configuration's `control`: float8 e4m3, a
scale a tensor) the reference in that storage takes the program's answers'
place in the comparison (`control_eva.py`).
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List

import numpy as np

from portbench import core, streams, weights_eva
from portbench.reference import eva02

SB = core.load_file(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "serve_batch.py"), "driver_serve_batch")
run_window = SB.run_window
end_to_end = SB.end_to_end
layer_context = SB.layer_context

# the configuration's `vision` keys the port's arch must hold
WIDTHS = ("image_size", "patch_size", "width", "layers", "heads",
          "output_dim", "mlp_hidden", "rope_theta", "pt_hw_seq_len", "eps")


def storage_rounding(name: str):
    if name == "e4m3":
        from portbench.reference.train import to_e4m3

        return to_e4m3
    raise SystemExit(f"serve_eva: no storage {name!r}")


def setup(cell: core.Cell, seed: int, device, log,
          options: Dict[str, Any] = None):
    """`options`: `storage` (the control), the rest Predictor arguments."""
    from eventclip_tpu_torch.data.loader import eval_pack_buckets
    from eventclip_tpu_torch.models.clip.config import clip_arch_config
    from eventclip_tpu_torch.serve import Predictor
    from eventclip_tpu_torch.utils.config import Params

    cfg, tr = cell.config, cell.traffic
    options = dict(options or {})
    storage = options.pop("storage", None)
    if tr["batch"] != tr["events"]["levels"]:
        raise SystemExit("serve_eva: a request takes one stream of each "
                         "length level, so batch must equal levels")
    try:
        clip_cfg = clip_arch_config(cfg["arch"])
    except KeyError:
        raise SystemExit(f"serve_eva: the port has no arch {cfg['arch']!r}")
    for key in WIDTHS:
        got = getattr(clip_cfg.vision, key, None)
        if cfg["vision"][key] != got:
            raise SystemExit(f"serve_eva: the port's {cfg['arch']} has "
                             f"{key} {got}, the configuration "
                             f"{cfg['vision'][key]}")
    geo = SB.geometry(cfg)
    t0 = time.perf_counter()
    pool = streams.stream_pool(tr, (geo["height"], geo["width"]), seed)
    log(f"stream pool: {sum(map(len, pool))} streams in "
        f"{time.perf_counter() - t0:.2f} s")
    w, text = weights_eva.make_weights(cfg, seed, device)
    clip = weights_eva.port_clip(w, clip_cfg, device)
    params = Params(**cfg["params"])
    names = [f"class_{i}" for i in range(cfg["n_classes"])]
    pred = Predictor(params, names, clip_params=clip, text_feats=text,
                     batch_size=tr["batch"], device=device, **options)
    del clip, w, text
    if (pred.window, pred.views, tuple(pred.resolution)) != (
            geo["window"], geo["views"], (geo["height"], geo["width"])):
        raise SystemExit("serve_eva: the Predictor's windows differ from "
                         "the configuration's")
    # one whole request: the packing bucket every request lands in
    pred.predict([copies[0] for copies in pool])
    state = SB.State(cell=cell, seed=seed, device=device, pred=pred,
                     pool=pool, schedule=streams.request_schedule(tr, seed),
                     geometry=geo,
                     buckets=eval_pack_buckets(tr["batch"], geo["views"], 1))
    state.storage = storage
    return state


def reference_geometry(state) -> Dict[str, Any]:
    cfg = state.cell.config
    q = cfg["params"]["quantize_args"]
    if not (q.get("grayscale", True) and q.get("background_mask", True)
            and not q.get("count_non_zero", False)):
        raise SystemExit("serve_eva: the reference draws grey frames over "
                         "white with counts over all pixels only")
    return dict(state.geometry, tower=cfg["vision"],
                image_size=cfg["vision"]["image_size"],
                logit_scale=float(cfg["params"]["clip_dict"].get(
                    "logit_scale", 100.0)), thresh=10.0, grey=127.0)


def check(state, win, log) -> List[core.Check]:
    """`serve_batch.check`'s comparison, through `reference/eva02.py`."""
    limits = state.cell.config["limits"]
    picked = SB.sample(state, win)
    if not picked:
        return [core.Check(k, float("nan"), v) for k, v in limits.items()]
    SB.free_program(state)
    t0 = time.perf_counter()
    w, text = weights_eva.make_weights(state.cell.config, state.seed,
                                       state.device)
    chosen = [state.pool[lvl][c] for lvl, c in
              (win.records[i]["req"][j] for i, j in picked)]
    geo = reference_geometry(state)
    ref = eva02.stream_probs(chosen, w, text, geo)
    emu = eva02.stream_probs(chosen, w, text, geo, rnd=eva02.to_bf16)
    if getattr(state, "storage", None):
        got = eva02.stream_probs(chosen, w, text, geo,
                                 rnd=storage_rounding(state.storage))
    else:
        got = np.stack([win.records[i]["probs"][j] for i, j in picked])

    def gaps(x):
        if not np.isfinite(x).all():
            return np.full(len(x), np.inf)
        return np.sqrt(np.mean((x - ref) ** 2, axis=-1))

    per, per_emu = gaps(got), gaps(emu)
    state.gaps = dict(
        SB.gap_stats(per, per_emu), median=float(np.median(per)),
        max=float(per.max()), bf16_median=float(np.median(per_emu)),
        bf16_max=float(per_emu.max()),
        spread_median=float(np.median(gaps(np.roll(ref, 1, axis=0)))))
    log(f"reference: {len(picked)} streams in "
        f"{time.perf_counter() - t0:.2f} s; gaps {state.gaps}")
    return [core.Check(k, state.gaps[k], v) for k, v in limits.items()]
