"""Pseudo-label generation for self-training, on the card.

Port of the root gen_data.py (reference gen_data.py:69-280,
docs/benchmark.md:90-130): a zero- or few-shot teacher labels the
*training* split, optionally with 4-way TTA (identity / h-flip / t-flip /
h+t-flip); predictions are filtered by confidence, TTA consistency, the
TTA minimum probability and a per-class top-k; the teacher's ground-truth
few-shot files are merged back; and a symlinked dataset tree is written
that the few-shot trainer (`cli.train --data_root <save_path>`) consumes:

    python -m eventclip_tpu_torch.cli.gen_data \\
        --params configs/zsclip/zsclip_ncaltech_params.py \\
        --clip_ckpt ViT-L-14.pt --data_root data/N-Caltech101 \\
        --save_path data/pseudo-N-Caltech101/zs --conf_thresh 0.999 \\
        --tta --tta_consistent --tta_min_prob [--topk 30] \\
        [--weight best.npz --gt_shots 10] [--int8 [--int8_calib NB]] \\
        [--prune_tokens K] [--fp32] [--cpu] [--smoke]

The teacher's feed overlaps its compute (`data.loader.device_prefetch`),
and the host filters each batch's probabilities one batch behind the
forward it just queued, as the JAX package does. The per-batch filter
(`filter_batch`), the top-k re-filter (`topk_refilter`) and the tree
writer (`write_tree`) are plain functions over numpy arrays and paths.

One process only: the root CLI's multi-host runs (JAX_COORDINATOR_ADDRESS,
each host labelling its shard) are ROADMAP item 7 and refused by name.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import os.path as osp
import time
from pathlib import PurePath
from typing import Any, Callable, Dict, List, Optional, Sequence, Set

import numpy as np
import torch

from ..data import PrefetchLoader, build_dataset, device_prefetch
from ..data.datasets import load_split_asset
from ..engine.checkpoint import load_checkpoint
from ..engine.trainer import (build_text_features, resolve_clip_params,
                              snapshot_logit_scale, sync_device)
from ..models.classifier import (DEFAULT_PROMPT, build_classifier_config,
                                 classifier_forward, init_classifier_params)
from ..models.clip.config import clip_arch_config
from ..ops.preprocess import ClipPreprocess
from ..ops.quant import calibrate_visual_amax, quantize_classifier_params
from ..ops.rasterize import rasterize_for_clip
from ..utils.config import load_params


def parse_args(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(description="EventCLIP port gen_data")
    parser.add_argument("--params", type=str, required=True)
    parser.add_argument("--save_path", type=str, default="")
    parser.add_argument("--weight", type=str, default="", help="load weight")
    parser.add_argument("--conf_thresh", type=float, default=-1.0)
    parser.add_argument("--tta", action="store_true")
    parser.add_argument("--tta_consistent", action="store_true")
    parser.add_argument("--tta_min_prob", action="store_true")
    parser.add_argument("--topk", type=int, default=-1)
    parser.add_argument("--gt_shots", type=int, default=-1)
    parser.add_argument("--data_root", type=str, default="")
    parser.add_argument("--clip_ckpt", type=str,
                        default=os.environ.get("CLIP_CKPT", ""))
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (debug/smoke runs)")
    parser.add_argument("--smoke", action="store_true",
                        help="allow RANDOM CLIP weights (pipeline testing "
                        "only; pseudo labels will be garbage)")
    parser.add_argument("--int8", action="store_true",
                        help="W8A8 int8 ViT tower for the teacher")
    parser.add_argument("--int8_calib", type=int, default=0,
                        help="with --int8: static activation scales from "
                        "the first N teacher batches (0: dynamic)")
    parser.add_argument("--prune_tokens", type=int, default=0,
                        help="keep the K highest-variance ViT patches "
                        "(0: all)")
    parser.add_argument("--fp32", action="store_true",
                        help="run activations in f32 instead of bf16")
    return parser.parse_args(argv)


def refuse_multi_host() -> None:
    world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if os.environ.get("JAX_COORDINATOR_ADDRESS") or world > 1:
        raise SystemExit("multi-host pseudo-labelling (each process "
                         "labelling its shard of the split) is not ported "
                         "yet (ROADMAP item 7, multi-GPU)")


def resolve_link(path: str) -> str:
    """Fully resolve a (possibly chained) symlink to its real target."""
    return osp.realpath(path)


def class_relpath(path: str) -> str:
    """Trailing '<class folder>/<file name>' of an event path: the key the
    reference matches GT split entries against dataset files by."""
    return osp.join(*PurePath(path).parts[-2:])


def report_selection(args, class_names, gt_cnt, sel_cnt, correct_cnt):
    """Per-class and aggregate pseudo-label selection report."""
    rows = [(name, gt_cnt[name], sel_cnt[name], correct_cnt[name])
            for name in class_names]
    print("\nClass stats:")
    for name, gt, sel, cor in rows:
        print(f"\t{name}: GT {gt}, select {sel}, {cor} correct")
    # zero-selection classes count as inaccurate (precision treated as 0)
    inaccurate = sum(1 for _, _, sel, cor in rows
                     if (cor / sel if sel else 0.0) < 0.5)
    print(f"Low-precision classes (<50%): {inaccurate}/{len(rows)}")
    total_gt = sum(r[1] for r in rows)
    total_sel = sum(r[2] for r in rows)
    total_cor = sum(r[3] for r in rows)
    print(f"\nUsing conf_thresh={args.conf_thresh}")
    if args.topk > 0:
        print(f"Using topk={args.topk}")
    pct = 100.0 * total_cor / total_sel if total_sel else 0.0
    print(f"\tSelect {total_sel} from {total_gt}, Acc={pct:.2f}%")
    if args.tta:
        print(f"Using TTA with consistent={args.tta_consistent} + "
              f"min_prob={args.tta_min_prob}")


@dataclasses.dataclass
class Selection:
    """What the filter has kept so far: accuracy counts over every valid
    sample, per-class selected / correct counts, and the selected files
    (path -> class name, or with top-k -> {'cls', 'prob'})."""
    class_names: Sequence[str]
    n_correct: int = 0
    n_total: int = 0
    sel: Dict[str, int] = dataclasses.field(init=False)
    correct: Dict[str, int] = dataclasses.field(init=False)
    path2cls: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.sel = {k: 0 for k in self.class_names}
        self.correct = {k: 0 for k in self.class_names}


def filter_batch(s: Selection, probs: np.ndarray, labels: np.ndarray,
                 mask: np.ndarray, paths: Sequence[str],
                 gt_paths: Set[str], *, tta: bool, tta_consistent: bool,
                 tta_min_prob: bool, conf_thresh: float,
                 topk: int) -> None:
    """One batch's f32 probabilities [B, n_cls] (with TTA [B, 4, n_cls],
    the variants in the dataset's order) into `s`: the JAX package's
    `consume`. TTA keeps a sample whose 4 argmaxes agree
    (`tta_consistent`) and whose 4 max-probabilities all pass
    `conf_thresh` (`tta_min_prob`), then averages the variants; a sample
    is selected when its max probability passes `conf_thresh`. Padding
    rows (mask False) count nowhere; the teacher's GT files count in the
    accuracy but are never selected."""
    if tta:
        tta_mask = np.ones(len(labels), dtype=bool)
        if tta_consistent:
            pred_cls = probs.argmax(-1)  # [B, 4]
            tta_mask &= (pred_cls == pred_cls[:, :1]).all(-1)
        if tta_min_prob:
            tta_mask &= probs.max(-1).min(-1) > conf_thresh
        probs = probs.mean(1)
    pred_labels = probs.argmax(-1)
    max_probs = probs.max(-1)
    s.n_correct += int(((pred_labels == labels) & mask).sum())
    s.n_total += int(mask.sum())
    sel_mask = max_probs > conf_thresh
    if tta:
        sel_mask &= tta_mask
    sel_mask &= mask
    for i in range(len(labels)):
        if not mask[i] or class_relpath(paths[i]) in gt_paths:
            continue
        if not sel_mask[i]:
            continue
        name = s.class_names[pred_labels[i]]
        s.sel[name] += 1
        if pred_labels[i] == labels[i]:
            s.correct[name] += 1
        s.path2cls[paths[i]] = ({"cls": name, "prob": float(max_probs[i])}
                                if topk > 0 else name)


def topk_refilter(path2cls: Dict[str, Dict[str, Any]],
                  class_names: Sequence[str], topk: int,
                  true_class: Callable[[str], str]):
    """Per-class top-k by confidence (reference gen_data.py:202-228) ->
    (path -> class name, selected, correct). The order is numpy's
    `argsort(-probs)` over the class's files in selection order, as the
    JAX package takes it (not a stable sort: equal probabilities keep
    numpy's order). `true_class(path)` is the file's GT class name."""
    out, sel, correct = {}, {}, {}
    for name in class_names:
        correct[name] = 0
        paths = [p for p, d in path2cls.items() if d["cls"] == name]
        probs = np.array([path2cls[p]["prob"] for p in paths])
        k = min(topk, len(paths))
        for i in np.argsort(-probs)[:k]:
            if true_class(paths[i]) == name:
                correct[name] += 1
            out[paths[i]] = name
        sel[name] = k
    return out, sel, correct


def write_tree(save_path: str, path2cls: Dict[str, str],
               gt_data: Dict[str, str], ev_dst, class_names: Sequence[str],
               is_nin: bool) -> None:
    """Materialize the pseudo-labelled split as symlinks to the real files
    under <save_path>/training (N-ImageNet: extracted_train, class folders
    by wnid), class folders under their original names (the CoOp renames
    undone, the first original a renamed class came from winning), with
    the teacher's GT few-shot files merged in; then link the source's
    validation / testing (N-ImageNet: extracted_val) beside it and make
    every class folder, empty or not."""
    train_path = osp.join(save_path, "extracted_train" if is_nin
                          else "training")
    assert not osp.exists(save_path), f"{save_path} already exists!"
    os.makedirs(train_path, exist_ok=True)
    new_cnames = getattr(ev_dst, "new_cnames", None)
    orig_cname: Dict[str, str] = {}
    for k, v in (new_cnames or {}).items():
        orig_cname.setdefault(v, k)

    path2cls = dict(path2cls)
    missing_gt = []
    for rel, cls in gt_data.items():
        abs_path = ev_dst._resolve_split_path(rel)
        if osp.exists(abs_path):
            path2cls[abs_path] = cls
        else:
            missing_gt.append(rel)
    if missing_gt:
        print(f"WARNING: {len(missing_gt)} GT few-shot file(s) not found "
              f"under {ev_dst.root} (e.g. {missing_gt[:3]}) - the pseudo "
              "dataset will hold fewer labeled samples than the protocol "
              "expects")
    for path, pred_cls in path2cls.items():
        path = resolve_link(path)
        pred_cls = orig_cname.get(pred_cls, pred_cls)
        folder = ev_dst.name2folder[pred_cls] if is_nin else pred_cls
        new_path = osp.join(train_path, folder, osp.basename(path))
        os.makedirs(osp.dirname(new_path), exist_ok=True)
        if not osp.exists(new_path):  # the first link wins a name clash
            os.symlink(path, new_path)

    if is_nin:
        ori_val = resolve_link(osp.join(osp.dirname(ev_dst.root),
                                        "extracted_val"))
        os.symlink(ori_val, osp.join(save_path, "extracted_val"))
    else:
        for split in ("validation", "testing"):
            ori = osp.join(osp.dirname(ev_dst.root), split)
            if osp.exists(ori):
                os.symlink(resolve_link(ori), osp.join(save_path, split))
    print(f"\nPseudo-label dataset tree written to {save_path}")
    for k in class_names:
        k = orig_cname.get(k, k)
        folder = ev_dst.name2folder[k] if is_nin else k
        os.makedirs(osp.join(train_path, folder), exist_ok=True)


def build_teacher(params, args, test_set, device):
    """(classifier config, parameters) of the teacher: the towers, the
    prompts' text features, for --weight the trained checkpoint; then
    --prune_tokens, and --int8 (calibrated over the first --int8_calib
    batches of `loader` when asked) at the end."""
    clip_cfg = clip_arch_config(params.clip_dict["arch"])
    # bf16=False runs f32 (needed by random debug towers, whose ~1e-4
    # feature differences underflow bf16)
    dtype = (torch.bfloat16 if bool(params.get("bf16", True))
             else torch.float32)
    cls_cfg = build_classifier_config(params, clip_cfg, dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(0)
    clip, pretrained = resolve_clip_params(
        params, clip_cfg, gen, args.clip_ckpt or None, smoke=args.smoke,
        device=device)
    cls_cfg = snapshot_logit_scale(cls_cfg, clip, pretrained)
    if args.prune_tokens > 0:
        cls_cfg = dataclasses.replace(cls_cfg, keep_tokens=args.prune_tokens)
    text_feats = build_text_features(
        clip, clip_cfg, test_set.classes,
        params.clip_dict.get("prompt", DEFAULT_PROMPT), pretrained)
    model_params = init_classifier_params(cls_cfg, gen, clip=clip,
                                          text_feats=text_feats,
                                          device=device)
    if args.weight:
        load_checkpoint(args.weight, target=model_params)
        print(f"Loading weight: {args.weight}")
    return cls_cfg, model_params


def quantize_teacher(args, cls_cfg, model_params, loader, raster, device):
    """--int8: the W8A8 copy of the teacher; with --int8_calib NB, static
    activation scales from the FLOAT tower over the first NB batches'
    views (padding views included, as the JAX package takes them)."""
    act_amax = None
    if args.int8_calib > 0:
        spec, pp = raster
        for i, batch in enumerate(loader):
            if i >= args.int8_calib:
                break
            w = torch.from_numpy(batch["windows"]).to(device)
            with torch.no_grad():
                imgs = rasterize_for_clip(
                    spec, pp, w.reshape((-1,) + tuple(w.shape[-2:])))
            try:
                a = calibrate_visual_amax(model_params.clip.visual, imgs,
                                          dtype=cls_cfg.dtype)
            except ValueError as e:
                raise SystemExit(f"--int8: {e}") from None
            act_amax = a if act_amax is None else torch.maximum(act_amax, a)
    try:
        return quantize_classifier_params(model_params, act_amax=act_amax)
    except ValueError as e:
        raise SystemExit(f"--int8: {e}") from None


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Run the CLI; returns the selection (`path2cls`, the per-class
    counts), the accuracy, and the teacher's timing: wall and loader-wait
    seconds of the labelling loop, batches, samples and encoded views."""
    args = parse_args(argv)
    refuse_multi_host()
    params = load_params(args.params)
    if args.fp32:
        params.bf16 = False
    if args.data_root:
        params.data_root = args.data_root
    if args.save_path:
        assert not osp.exists(args.save_path), (
            f"{args.save_path} already exists!")
    device = torch.device("cpu" if args.cpu else "cuda")

    is_zs = params.model == "ZSCLIP"
    tta = args.tta
    is_nin = "n_imagenet" in params.dataset
    if not is_nin:
        assert params.dataset == "n_caltech", f"{params.dataset} not supported"
    print(f"Pseudo-labeling the {params.dataset} training split")

    test_set = build_dataset(params, val_only=False, gen_data=True, tta=tta)
    ev_dst = test_set.event_dataset
    class_names, ds_labels = test_set.classes, ev_dst.labels

    # the teacher's ground-truth few-shot labels (not pseudo-labelled again)
    gt_data: Dict[str, str] = {}
    if args.weight:
        assert not is_zs, (
            "--weight is for few-shot teachers; a zero-shot teacher "
            "carries no checkpoint")
    cls_cfg, model_params = build_teacher(params, args, test_set, device)
    if args.weight:
        assert args.gt_shots > 0, (
            "pass --gt_shots = the shot count the teacher was trained with")
        assert f"{args.gt_shots}shot" in args.weight or \
            f"{args.gt_shots}-shot" in args.weight
        if args.save_path:
            assert f"{args.gt_shots}shot" in args.save_path or \
                f"{args.gt_shots}-shot" in args.save_path
        gt_split = load_split_asset(
            type(ev_dst).__name__, args.gt_shots, True
        ) or load_split_asset(type(ev_dst).__name__, args.gt_shots, False)
        assert gt_split, f"no shipped {args.gt_shots}-shot split"
        gt_data = {k: class_names[v] for k, v in gt_split.items()}
    gt_paths = {class_relpath(k) for k in gt_data}

    spec = test_set.raster_spec()
    pp = ClipPreprocess(in_height=spec.height, in_width=spec.width,
                        image_size=cls_cfg.clip.vision.image_size)
    bs = max(int(params.get("val_batch_size", 32)), 1)
    if tta:
        bs = max(bs // 4, 1)
    loader = PrefetchLoader(test_set, bs, pad_last=True,
                            num_workers=params.get("num_workers", 8))
    if args.int8:
        model_params = quantize_teacher(args, cls_cfg, model_params, loader,
                                        (spec, pp), device)
    n_cls = len(class_names)

    @torch.inference_mode()
    def probs_step(windows, valid):
        lead = tuple(windows.shape[:-3])  # [B] or [B, 4]
        flat_w = windows.reshape((-1,) + tuple(windows.shape[-3:]))
        flat_v = valid.reshape((-1, valid.shape[-1]))
        imgs = rasterize_for_clip(spec, pp, flat_w)
        out = classifier_forward(model_params, cls_cfg, imgs, flat_v)
        return out["probs"].reshape(lead + (n_cls,))

    def place(batch):
        dev = [torch.from_numpy(np.ascontiguousarray(batch[k])).to(
            device, non_blocking=True) for k in ("windows", "valid_mask")]
        host = (batch["label"], batch["sample_mask"], batch["data_idx"],
                int(batch["valid_mask"].sum()))
        return dev, host

    sel = Selection(class_names)
    views = 0

    def consume(probs_dev, host):
        nonlocal views
        labels, mask, data_idx, n_views = host
        views += n_views
        paths = [str(ev_dst.labeled_files[i]) for i in data_idx]
        filter_batch(sel, probs_dev.float().cpu().numpy(), labels, mask,
                     paths, gt_paths, tta=tta,
                     tta_consistent=args.tta_consistent,
                     tta_min_prob=args.tta_min_prob,
                     conf_thresh=args.conf_thresh, topk=args.topk)

    # the host filters one batch behind the forward it just queued, so
    # fetching the probabilities never waits on that forward
    t0 = time.perf_counter()
    wait, n_batches, pending = 0.0, 0, None
    batches = device_prefetch(loader, place)
    while True:
        t_wait = time.perf_counter()
        item = next(batches, None)
        wait += time.perf_counter() - t_wait
        if item is None:
            break
        (windows, valid), host = item
        probs_dev = probs_step(windows, valid)
        n_batches += 1
        if pending is not None:
            consume(*pending)
        pending = (probs_dev, host)
    if pending is not None:
        consume(*pending)
    sync_device(device)
    wall = time.perf_counter() - t0

    gt_cnt = {k: int((ds_labels == i).sum())
              for i, k in enumerate(class_names)}
    report_selection(args, class_names, gt_cnt, sel.sel, sel.correct)
    print(f"\n\nTesting {args.params}")
    if args.weight:
        print(f"Model weight: {args.weight}")
    acc = sel.n_correct / max(sel.n_total, 1)
    print(f"\taccuracy@1 (probs): {acc * 100.:.2f}%")
    result = {"accuracy": acc, "path2cls": sel.path2cls, "sel": sel.sel,
              "correct": sel.correct, "gt_cnt": gt_cnt,
              "stats": {"wall_s": wall, "wait_s": wait,
                        "batches": n_batches, "samples": sel.n_total,
                        "views": views}}
    if not args.save_path:
        return result

    if args.topk > 0:
        new_cnames = getattr(ev_dst, "new_cnames", None)

        def true_class(path):
            name = osp.basename(osp.dirname(path))
            if is_nin:
                name = ev_dst.folder2name[name]
            if new_cnames is not None:
                name = new_cnames.get(name, name)
            return name

        path2cls, sel_cnt, correct = topk_refilter(
            sel.path2cls, class_names, args.topk, true_class)
        report_selection(args, class_names, gt_cnt, sel_cnt, correct)
        result.update(path2cls=path2cls, sel=sel_cnt, correct=correct)
    write_tree(args.save_path, result["path2cls"], gt_data, ev_dst,
               class_names, is_nin)
    return result


if __name__ == "__main__":
    main()
