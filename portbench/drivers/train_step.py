"""Driver `train_step`: full fine-tuning through
`eventclip_tpu_torch.engine.trainer.EventCLIPTrainer`, epochs as its
`fit()` runs them.

Set-up makes the tower's weights and the class features on the card from
the seed (`weights.py`), the recordings (`streams.py`, `levels` x `copies`
of them, made in threads) and a label an item, wraps them as an
N-ImageNet reader whose items are those recordings (item i is recording
i mod their number; the reader's own `__getitem__`: `prepare_stream` with
its time flip, shift and flip, drawn from (seed, epoch, i)) inside
`EventWindowDataset`, builds the trainer on a copy of the weights and
frees the benchmark's own. It ends with the trainer's first steps (the
traffic's `check.steps`), each through `trainer.train_step` on a batch of
the trainer's own loader placed as `train_epoch` places it, which also
warm every kernel the window runs; each step's loss, the gradient Adam
holds after the first (its first moment over 1 - beta1) and every trained
leaf's change over the steps go to the host. The window runs
`train_epoch` epoch after epoch until `--seconds` have passed, and ends
before the first step due after that. Afterwards the program is freed,
the weights are made again from the seed, and the reference
(`reference/train.py`) redoes the checked steps in float32.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import shutil
import statistics
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from portbench import core, streams, weights
from portbench.reference import train as ref_train
from portbench.reference import vit

BETA1 = 0.9  # Adam's first moment after one step is (1 - beta1) g
STORAGE = {"bf16": vit.to_bf16, "e4m3": ref_train.to_e4m3}
# a port block leaf -> its OpenAI name
BLOCK = {"ln_1.weight": "ln_1.weight", "ln_1.bias": "ln_1.bias",
         "attn.wqkv": "attn.in_proj_weight", "attn.bqkv": "attn.in_proj_bias",
         "attn.wo": "attn.out_proj.weight", "attn.bo": "attn.out_proj.bias",
         "ln_2.weight": "ln_2.weight", "ln_2.bias": "ln_2.bias",
         "mlp.w1": "mlp.c_fc.weight", "mlp.b1": "mlp.c_fc.bias",
         "mlp.w2": "mlp.c_proj.weight", "mlp.b2": "mlp.c_proj.bias"}


@dataclasses.dataclass
class State:
    cell: core.Cell
    seed: int
    device: torch.device
    recordings: List[np.ndarray]
    labels: np.ndarray
    geometry: Dict[str, Any]
    trainer: Any = None
    ckpt_dir: Optional[str] = None
    checked: Optional[Dict[str, Any]] = None
    epoch: int = 0  # the window's first epoch
    gaps: Optional[Dict[str, Any]] = None


def geometry(cfg: Dict[str, Any]) -> Dict[str, Any]:
    ds, q = cfg["dataset"], cfg["params"]["quantize_args"]
    window = int(q["N"])
    views = max(min(round(ds["max_n"] / window), int(q["max_imgs"])), 1)
    return {"height": ds["resolution"][0], "width": ds["resolution"][1],
            "window": window, "views": views,
            "batch": int(cfg["params"]["train_batch_size"])}


def make_recordings(traffic: Dict[str, Any], geo: Dict[str, Any],
                    seed: int) -> List[np.ndarray]:
    """`streams.stream_pool`'s recordings (the same (seed, level, copy)
    generators), level after level, made in threads."""
    jobs = [(lvl, c, n) for lvl, n in enumerate(streams.lengths(
        traffic["events"])) for c in range(int(traffic["copies"]))]

    def one(job):
        lvl, c, n = job
        return streams.blob_stream(np.random.default_rng((seed, lvl, c)), n,
                                   geo["height"], geo["width"],
                                   traffic["stream"])

    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
        return list(ex.map(one, jobs))


def event_dataset(recordings: List[np.ndarray], labels: np.ndarray,
                  cfg: Dict[str, Any], seed: int):
    """The port's N-ImageNet reader over in-memory recordings, built by its
    own constructor: item i is recording i mod their number, under label
    i, with the first `n_classes` classes of the reader's own table."""
    from eventclip_tpu_torch.data.datasets import (NImageNet,
                                                   imagenet_folder2name)

    ds = cfg["dataset"]
    wnids = list(imagenet_folder2name())[:int(cfg["n_classes"])]

    class Recordings(NImageNet):
        resolution = tuple(ds["resolution"])
        max_t, max_n = ds["max_t"], ds["max_n"]
        max_shift, flip_time = ds["max_shift"], ds["flip_time"]

        def _list_classes(self):
            return list(wnids)

        def _get_sample_idx(self):
            return (np.array([str(i) for i in range(len(labels))]),
                    np.asarray(labels))

        @staticmethod
        def _load_events(path):
            return recordings[int(path) % len(recordings)]

    reader = Recordings("extracted_train", augmentation=True, seed=seed)
    if reader.is_pseudo:
        raise SystemExit("train_step: the reader took its root for a "
                         "pseudo-label tree")
    return reader


def openai_name(port: str) -> str:
    """A trained leaf's port name -> the name the reference gives it."""
    if port == "text_feats":
        return "text"
    name = port[len("clip.visual."):]
    if name == "patch_embed":
        return "conv1.weight"
    if name.startswith("blocks.layers."):
        i, rest = name[len("blocks.layers."):].split(".", 1)
        return f"transformer.resblocks.{i}.{BLOCK[rest]}"
    return name


def units(named: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """{OpenAI name: tensor} -> the compared leaves, flat: q, k and v of
    the fused in-projection apart (a key's bias has no gradient under
    softmax, and the rule on moved leaves has to see it alone)."""
    out = {}
    for k, v in named.items():
        if k.endswith(("attn.in_proj_weight", "attn.in_proj_bias")):
            for part, t in zip("qkv", v.chunk(3, dim=0)):
                out[f"{k}.{part}"] = t.reshape(-1)
        else:
            out[k] = v.reshape(-1)
    return out


def check_widths(cfg: Dict[str, Any]):
    from eventclip_tpu_torch.models.clip.config import clip_arch_config

    clip_cfg = clip_arch_config(cfg["arch"])
    v = clip_cfg.vision
    for key, got in (("image_size", v.image_size), ("patch_size",
                     v.patch_size), ("width", v.width), ("layers", v.layers),
                     ("heads", v.heads), ("output_dim", v.output_dim),
                     ("mlp_width", 4 * v.width)):
        if cfg["vision"][key] != got:
            raise SystemExit(f"train_step: the port's {cfg['arch']} has "
                             f"{key} {got}, the configuration "
                             f"{cfg['vision'][key]}")
    return clip_cfg


def setup(cell: core.Cell, seed: int, device, log,
          options: Dict[str, Any] = None) -> State:
    """`options` {'storage': 'bf16' | 'e4m3'}: no program; the reference
    in that storage takes its place in the checked steps (the control)."""
    cfg, tr = cell.config, cell.traffic
    clip_cfg = check_widths(cfg)
    geo = geometry(cfg)
    t0 = time.perf_counter()
    recs = make_recordings(tr, geo, seed)
    labels = np.random.default_rng((seed, 0x1AB)).integers(
        0, cfg["n_classes"], int(tr["items"]))
    log(f"recordings: {len(recs)} ({sum(map(len, recs))} events) for "
        f"{len(labels)} items in {time.perf_counter() - t0:.2f} s")
    state = State(cell=cell, seed=seed, device=device, recordings=recs,
                  labels=labels, geometry=geo)
    if options and options.get("storage"):
        state.checked = reference_run(state, options["storage"])
        return state

    from eventclip_tpu_torch.data.event_windows import EventWindowDataset
    from eventclip_tpu_torch.engine.trainer import EventCLIPTrainer
    from eventclip_tpu_torch.utils.config import Params

    params = Params(**cfg["params"])
    train_set = EventWindowDataset(
        event_dataset(recs, labels, cfg, seed), cfg["params"]["quantize_args"],
        augment=bool(params.img_aug), seed=seed)
    if (train_set.window, train_set.max_imgs, tuple(train_set.resolution)) \
            != (geo["window"], geo["views"], (geo["height"], geo["width"])):
        raise SystemExit("train_step: the dataset's windows differ from the "
                         "configuration's")
    w, text = weights.make_weights(cfg, seed, device)
    clip = weights.port_clip(w, clip_cfg, device)
    del w
    state.ckpt_dir = tempfile.mkdtemp(prefix="portbench-train-")
    state.trainer = EventCLIPTrainer(params, train_set, train_set,
                                     state.ckpt_dir, clip_params=clip,
                                     text_feats=text, seed=seed,
                                     device=device)
    del clip, text
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    state.checked, state.epoch = checked_steps(state, log)
    return state


def checked_steps(state: State, log):
    """The trainer's first steps, through its own step on its own
    loader's batches, placed as `train_epoch` places them
    (`adaptive_prefetch` over `device_batch`, with the trainer's own depth
    choice) -> ({'losses', 'grad1', 'delta'} on the host, as units), the
    epoch after the last one they took batches from. Waits for the
    loader's workers to end, so that none runs on into the window."""
    from eventclip_tpu_torch.data.loader import adaptive_prefetch

    tr, steps = state.trainer, int(state.cell.traffic["check"]["steps"])
    opt = tr.optimizer
    named = dict(zip(opt.names, opt.trained))
    start = {k: p.detach().clone() for k, p in named.items()}
    losses, grad1, epoch = [], None, 0
    threads = threading.active_count()
    t0 = time.perf_counter()
    while len(losses) < steps:
        host = iter(tr.train_loader.epoch(epoch))
        placed = adaptive_prefetch(host, tr.device_batch,
                                   choice=tr._prefetch_choice)
        try:
            for batch in placed:
                out = tr.train_step(batch)
                losses.append(float(out["total_loss"]))
                if grad1 is None:
                    grad1 = {openai_name(k): first_moment(opt, p) / (1 - BETA1)
                             for k, p in named.items()}
                if len(losses) == steps:
                    break
        finally:
            placed.close()
            host.close()
        epoch += 1
    delta = {openai_name(k): (p.detach() - start[k]).cpu()
             for k, p in named.items()}
    del start
    wait_for_threads(threads)
    log(f"checked steps: losses {losses} in {time.perf_counter() - t0:.2f} "
        f"s")
    return {"losses": losses, "grad1": units(grad1),
            "delta": units(delta)}, epoch


def first_moment(opt, p: torch.Tensor) -> torch.Tensor:
    """Adam's first moment of leaf p on the host (zeros where the
    optimizer holds none)."""
    st = opt.torch_opt.state.get(p, {})
    m = st.get("exp_avg")
    return (m.detach().float().cpu() if m is not None
            else torch.zeros(p.shape, dtype=torch.float32))


@dataclasses.dataclass
class Window:
    steps: List[tuple]
    window_s: float
    attempted: int
    failed: int


class Deadline(Exception):
    """Raised by the window's step once `--seconds` have passed."""


def wait_for_threads(count: int, timeout: float = 60.0) -> None:
    """Wait until no more than `count` threads run: the loader's workers
    end after the batch each is building once an epoch is left."""
    deadline = time.perf_counter() + timeout
    while threading.active_count() > count and \
            time.perf_counter() < deadline:
        time.sleep(0.01)


def run_window(state: State, seconds: float, spans) -> Window:
    """`train_epoch`, epoch after epoch as `fit()` runs them, until
    `seconds` have passed: the first step due after that ends the window
    before it runs, inside its epoch (an epoch holds more steps than a
    window, so the window sees one epoch start, as an N-ImageNet epoch of
    13.9k steps all but never does). The window's time runs to that
    moment, the wait for that step's batch included. Each step's loss is
    kept (on the device) to count the steps whose loss is not finite."""
    tr = state.trainer
    orig_step, losses, end = tr.train_step, [], []
    threads = threading.active_count()

    def step(batch):
        now = time.perf_counter()
        if now >= deadline:
            end.append(now)
            raise Deadline
        with spans("train_step"):
            out = orig_step(batch)
        losses.append(out["total_loss"].detach())
        return out

    tr.train_step = step
    times, epoch = [], state.epoch
    t0 = time.perf_counter()
    deadline = t0 + seconds
    try:
        with spans("window"):
            while not end:
                try:
                    with spans("epoch"):
                        tr.train_epoch(epoch)
                except Deadline:
                    pass
                times += tr.step_times
                epoch += 1
    finally:
        tr.train_step = orig_step
    window_s = end[0] - t0
    wait_for_threads(threads)
    finite = torch.isfinite(torch.stack(losses).float()).cpu()
    bad = int((~finite).sum())
    if bad:
        print(f"{bad} of {len(losses)} steps gave a loss that is not "
              "finite", file=sys.stderr, flush=True)
    return Window(times, window_s, len(losses), bad)


def end_to_end(state: State, win: Window) -> Dict[str, float]:
    return {"train_samples_per_s":
            state.geometry["batch"] * win.attempted / win.window_s}


def layer_context(state: State, win: Window) -> Dict[str, Any]:
    return {"requests": [], "steps": win.steps, "geometry": state.geometry,
            "config": state.cell.config}


def free_program(state: State) -> None:
    state.trainer = None
    gc.collect()
    if state.device.type == "cuda":
        torch.cuda.empty_cache()
    if state.ckpt_dir:
        shutil.rmtree(state.ckpt_dir, ignore_errors=True)
        state.ckpt_dir = None


def reference_batches(state: State) -> List[Dict[str, Any]]:
    """The checked steps' batches as the loader's seeding gives them."""
    B = state.geometry["batch"]
    n = len(state.labels)
    per_epoch = n // B
    out = []
    for step in range(int(state.cell.traffic["check"]["steps"])):
        epoch, b = divmod(step, per_epoch)
        idx = ref_train.loader_order(state.seed, epoch, n)[b * B:(b + 1) * B]
        out.append({"items": [(state.recordings[i % len(state.recordings)],
                               int(i)) for i in idx],
                    "labels": state.labels[idx], "epoch": epoch,
                    "step": step})
    return out


def reference_run(state: State, storage: Optional[str] = None
                  ) -> Dict[str, Any]:
    """The checked steps by the reference from the seed's weights:
    exact, or with the tower's tensors in `storage`."""
    cfg, geo = state.cell.config, state.geometry
    p = cfg["params"]
    w, text = weights.make_weights(cfg, state.seed, state.device)
    rgeo = dict(geo, layers=cfg["vision"]["layers"],
                heads=cfg["vision"]["heads"],
                image_size=cfg["vision"]["image_size"], thresh=10.0,
                grey=127.0, max_shift=cfg["dataset"]["max_shift"],
                flip_time=cfg["dataset"]["flip_time"],
                num_ops=cfg["randaugment"]["num_ops"],
                logit_scale=float(p["clip_dict"].get("logit_scale", 100.0)),
                seed=state.seed)
    opt = {"lr": p["lr"], "clip_lr": p["clip_lr"],
           "total_steps": p["max_epochs"] * (len(state.labels)
                                             // geo["batch"]),
           "warmup_pct": p["warmup_steps_pct"]}
    rnd = vit.exact if storage is None else ref_train.rounder(STORAGE[storage])
    out = ref_train.train_steps(reference_batches(state), w, text, rgeo, opt,
                                int(state.cell.traffic["check"]["block"]),
                                rnd, augment=bool(p["img_aug"]))
    return {"losses": out["losses"], "grad1": units(out["grad1"]),
            "delta": units(out["delta"])}


def worst(gaps: Dict[str, float]):
    name = max(gaps, key=lambda k: (not np.isfinite(gaps[k]), gaps[k]))
    return float(gaps[name]), name


def gap_stats(prog: Dict[str, Any], ref: Dict[str, Any],
              device) -> Dict[str, Any]:
    """The numbers a check reads, and beside them what they are made of.

    grad_norm_gap / change_norm_gap: the worst leaf's gap between the
    program's norm and the reference's (of the first gradient; of the
    change over the checked steps), over the larger of the reference's
    norm of that leaf and of the median leaf. Leaves whose reference
    gradient is under a thousandth of the median leaf's (the keys' biases,
    whose gradient under softmax is nought) hold round-off alone, in the
    gradient and, under Adam, in the change: they are left out of all.
    change_dist_median / grad_dist_median: the median leaf's relative L2
    distance from the reference, of the change and of the first gradient.
    Rounding that is not biased moves a norm only to second order, so the
    gaps of norms read a storage one precision lower barely above the
    program; the distance reads it at first order. loss_gap: the widest of
    the steps' |loss - reference loss| over the reference loss. Logged
    beside them: the median leaf's gaps."""
    def norms(d):
        return {u: float(torch.linalg.vector_norm(t.to(device).float()))
                for u, t in d.items()}

    def dist(a, r):
        return statistics.median(float(
            torch.linalg.vector_norm(a[u].to(device).float()
                                     - r[u].to(device).float())
            / max(float(torch.linalg.vector_norm(r[u].to(device).float())),
                  1e-30)) for u in moved)

    def gaps(p, r):
        med = statistics.median(r[u] for u in moved)
        return {u: abs(p[u] - r[u]) / max(r[u], med) for u in moved}

    loss = [abs(a - b) / abs(b) if np.isfinite(a) else float("inf")
            for a, b in zip(prog["losses"], ref["losses"])]
    gr = norms(ref["grad1"])
    med = statistics.median(gr.values())
    moved = [u for u in gr if gr[u] >= 1e-3 * med]
    grad = gaps(norms(prog["grad1"]), gr)
    change = gaps(norms(prog["delta"]), norms(ref["delta"]))
    out = {"loss_gap": float(max(loss))}
    out["grad_norm_gap"], out["grad_worst"] = worst(grad)
    out["change_norm_gap"], out["change_worst"] = worst(change)
    out.update(grad_norm_gap_median=statistics.median(grad.values()),
               change_norm_gap_median=statistics.median(change.values()),
               grad_dist_median=dist(prog["grad1"], ref["grad1"]),
               change_dist_median=dist(prog["delta"], ref["delta"]),
               losses=list(prog["losses"]), ref_losses=list(ref["losses"]),
               left_out=len(gr) - len(moved))
    return out


def check(state: State, win: Optional[Window], log) -> List[core.Check]:
    """The checked steps against the reference's (see `gap_stats`): the
    numbers the configuration's `limits` name, each beside its limit."""
    limits = state.cell.config["limits"]
    free_program(state)
    t0 = time.perf_counter()
    ref = reference_run(state)
    state.gaps = gap_stats(state.checked, ref, state.device)
    log(f"reference: {len(ref['losses'])} steps in "
        f"{time.perf_counter() - t0:.2f} s; gaps {state.gaps}")
    return [core.Check(k, state.gaps[k], v) for k, v in limits.items()]
