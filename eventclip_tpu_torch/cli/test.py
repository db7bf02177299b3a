"""Evaluation CLI of the port: a dataset tree and checkpoints -> accuracies.

Port of the root test.py (reference test.py:21-186), run on the card
unless --cpu is given:

    python -m eventclip_tpu_torch.cli.test \
        --params configs/zsclip/zsclip_ncaltech_params.py \
        --clip_ckpt ViT-L-14.pt --data_root data/N-Caltech101 \
        [--weight ckpt.npz|ckpt.pth] [--N n] [--arch A] [--prompt P] \
        [--bs B] [--subset 1..9] [--train_shots K1 K2 ...] [--fp32]
        [--int8 [--int8_calib NB]] [--prune_tokens K]

- prints probs-based and logits-based top-1 (and top-5 on N-ImageNet);
- `--train_shots` sweeps `<ckpt_base>/<cfg>[-dupX]-<K>shot/models/`
  (best.npz / best.pth preferred, else the latest model_<step>), averaging
  over seed-duplicated runs and printing a LaTeX-ready `&`-joined row;
- `--subset` selects one of the 9 N-ImageNet robustness validation sets;
- `--int8` evaluates the W8A8 int8 visual tower (ops/quant.py), quantized
  after each checkpoint loads; with `--int8_calib NB` its activation
  scales are static, fitted on the float tower over the first NB val
  batches; `--prune_tokens K` keeps the K highest-variance patches.

Text features come from the config's prompt through the BPE tokenizer
(EVENTCLIP_BPE_PATH, or bpe_simple_vocab_16e6.txt.gz under
eventclip_tpu_torch/assets/). `--n_model > 1` is ROADMAP item 7: refused,
never ignored.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..data import PrefetchLoader, build_dataset, device_prefetch
from ..data.loader import eval_pack_buckets, pack_view_batch
from ..engine.checkpoint import load_checkpoint
from ..engine.train import make_eval_step
from ..engine.trainer import (build_text_features, resolve_clip_params,
                              snapshot_logit_scale, sync_device)
from ..models.classifier import (DEFAULT_PROMPT, build_classifier_config,
                                 init_classifier_params)
from ..models.clip.config import clip_arch_config
from ..ops.preprocess import ClipPreprocess
from ..ops.quant import calibrate_visual_amax, quantize_classifier_params
from ..ops.rasterize import rasterize_for_clip
from ..utils.config import load_params
from ..utils.meters import AverageMeter


def parse_args(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(description="EventCLIP port test")
    parser.add_argument("--params", type=str, required=True)
    parser.add_argument("--weight", type=str, default="")
    parser.add_argument("--N", type=int, default=-1)
    parser.add_argument("--arch", type=str, default="")
    parser.add_argument("--prompt", type=str, default="")
    parser.add_argument("--bs", type=int, default=-1)
    parser.add_argument("--subset", type=int, default=-1)
    parser.add_argument("--train_shots", nargs="+", default=[-1], type=int)
    parser.add_argument("--data_root", type=str, default="")
    parser.add_argument("--clip_ckpt", type=str,
                        default=os.environ.get("CLIP_CKPT", ""))
    parser.add_argument("--n_model", type=int, default=1)
    parser.add_argument("--ckpt_base", type=str, default="checkpoint")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (debug/smoke runs)")
    parser.add_argument("--smoke", action="store_true",
                        help="allow RANDOM CLIP weights (pipeline testing "
                        "only; accuracies will be garbage)")
    parser.add_argument("--fp32", action="store_true",
                        help="run activations in f32 instead of bf16")
    parser.add_argument("--int8", action="store_true",
                        help="W8A8 int8 visual tower (inference only)")
    parser.add_argument("--int8_calib", type=int, default=0,
                        help="with --int8: static activation scales from "
                        "the first N val batches (0: dynamic per-token)")
    parser.add_argument("--prune_tokens", type=int, default=0,
                        help="keep the K highest-variance ViT patches "
                        "(0: all)")
    return parser.parse_args(argv)


def refuse_unported(args) -> None:
    if args.n_model > 1:
        raise SystemExit("--n_model > 1 (tensor parallelism) is not ported "
                         "yet (ROADMAP item 7, multi-GPU)")


def load_and_override(args):
    """The eval CLI's param mutations (reference test.py:96-124): --N
    (thousands of events a window), --arch and --prompt are zero-shot only
    (a trained checkpoint is bound to what it was trained with); --bs and
    --data_root apply everywhere; --subset needs N-ImageNet. Returns
    (params, cfg_base)."""
    cfg_base = os.path.basename(
        args.params[:-3] if args.params.endswith(".py") else args.params)
    params = load_params(args.params)
    if args.fp32:
        params.bf16 = False

    is_zs = params.model == "ZSCLIP"
    if args.N > 0:
        params.quantize_args["N"] = int(args.N * 1e3)
        assert is_zs, "--N overrides are limited to zero-shot evaluation"
    if args.arch:
        params.clip_dict["arch"] = args.arch
        assert is_zs, "--arch overrides are limited to zero-shot evaluation"
    if args.prompt:
        params.clip_dict["prompt"] = args.prompt
        assert is_zs, "--prompt overrides are limited to zero-shot evaluation"
    if args.bs > 0:
        params.val_batch_size = args.bs
    if args.subset > 0:
        assert params.dataset == "n_imagenet", (
            "robustness subsets exist only for N-ImageNet")
    if args.data_root:
        params.data_root = args.data_root
    return params, cfg_base


def build_eval_context(params, args) -> Dict[str, Any]:
    """What an evaluation needs apart from the weight file: the dataset,
    the CLIP towers, the text features, the eval step and the loader,
    built once for every checkpoint of a --train_shots sweep. `timing`
    holds the CLIP load's and the text features' seconds; `evals` gets one
    record for each evaluation."""
    device = torch.device("cpu" if args.cpu else "cuda")
    kwargs = {"subset": args.subset} if args.subset > 0 else {}
    val_set = build_dataset(params, val_only=True, **kwargs)

    clip_cfg = clip_arch_config(params.clip_dict["arch"])
    # bf16=False runs f32 (needed by random debug towers, whose ~1e-4
    # feature differences underflow bf16)
    dtype = (torch.bfloat16 if bool(params.get("bf16", True))
             else torch.float32)
    cls_cfg = build_classifier_config(params, clip_cfg, dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(0)
    t0 = time.perf_counter()
    clip, pretrained = resolve_clip_params(
        params, clip_cfg, gen, args.clip_ckpt or None, smoke=args.smoke,
        device=device)
    sync_device(device)
    t1 = time.perf_counter()
    cls_cfg = snapshot_logit_scale(cls_cfg, clip, pretrained)
    if args.prune_tokens > 0:
        cls_cfg = dataclasses.replace(cls_cfg, keep_tokens=args.prune_tokens)
    text_feats = build_text_features(
        clip, clip_cfg, val_set.classes,
        params.clip_dict.get("prompt", DEFAULT_PROMPT), pretrained)
    sync_device(device)
    t2 = time.perf_counter()
    template = init_classifier_params(cls_cfg, gen, clip=clip,
                                      text_feats=text_feats, device=device)
    print(f"CLIP {clip_cfg.name} ({'pretrained' if pretrained else 'random'}"
          f") in {t1 - t0:.2f} s; text features {tuple(text_feats.shape)} "
          f"in {(t2 - t1) * 1e3:.1f} ms")

    spec = val_set.raster_spec()
    pp = ClipPreprocess(in_height=spec.height, in_width=spec.width,
                        image_size=clip_cfg.vision.image_size)
    top5 = params.dataset == "n_imagenet"
    bs = int(params.get("val_batch_size", 64))
    loader = PrefetchLoader(val_set, bs, pad_last=True,
                            num_workers=params.get("num_workers", 8))
    return {
        "device": device, "template": template, "cls_cfg": cls_cfg,
        "eval_step": make_eval_step(cls_cfg, template, top5=top5,
                                    pipeline=(spec, pp)),
        "loader": loader, "top5": top5, "raster": (spec, pp),
        # packed eval (data/loader.py::pack_view_batch): only the real
        # views of each batch are encoded
        "pack_buckets": eval_pack_buckets(bs, val_set.max_imgs, 1),
        "timing": {"clip_s": t1 - t0, "text_feats_s": t2 - t1}, "evals": [],
    }


def quantized_template(args, ctx):
    """The int8 copy of ctx's template, as it holds the checkpoint just
    loaded (the float template stays for the next one of a sweep). With
    --int8_calib NB, static activation scales: the max-abs per (layer,
    site) over the first NB val batches through the FLOAT tower (LoRA
    deltas left out of the pass, as in the JAX package)."""
    template, cls_cfg = ctx["template"], ctx["cls_cfg"]
    act_amax = None
    if args.int8_calib > 0:
        spec, pp = ctx["raster"]
        for i, batch in enumerate(ctx["loader"]):
            if i >= args.int8_calib:
                break
            with torch.no_grad():
                imgs = rasterize_for_clip(spec, pp, torch.from_numpy(
                    batch["windows"]).to(ctx["device"]))
            a = calibrate_visual_amax(
                template.clip.visual,
                imgs.reshape((-1,) + tuple(imgs.shape[-3:])),
                dtype=cls_cfg.dtype)
            act_amax = a if act_amax is None else torch.maximum(act_amax, a)
    try:
        return quantize_classifier_params(template, act_amax=act_amax)
    except ValueError as e:
        raise SystemExit(f"--int8: {e}") from None


def evaluate(params, args, weight: str = "", printing: bool = True,
             ctx=None):
    """(probs top-1, logits top-1) over the val set. A --train_shots sweep
    keeps the placed batches on the device across checkpoints while they
    fit EVENTCLIP_SWEEP_CACHE_MB (default 2048; 0 turns the cache off).
    Appends to ctx['evals'] the weight, the summed counters, the batch
    count, and the wall and host-loader wait seconds."""
    if ctx is None:
        ctx = build_eval_context(params, args)
    if weight:
        load_checkpoint(weight, target=ctx["template"])
        if printing:
            print(f"Loaded weight: {weight}")
    else:
        assert params.model == "ZSCLIP", "non-ZS evaluation needs --weight"
    device, eval_step, top5 = ctx["device"], ctx["eval_step"], ctx["top5"]
    if args.int8:
        eval_step = make_eval_step(ctx["cls_cfg"], quantized_template(args,
                                                                      ctx),
                                   top5=top5, pipeline=ctx["raster"])

    def prep(batch):
        dev = {k: v for k, v in batch.items()
               if k in ("windows", "valid_mask", "sample_mask")}
        dev["label"] = batch["label"].astype("int32")
        if ctx["pack_buckets"] and "windows" in dev:
            dev = pack_view_batch(dev, ctx["pack_buckets"])
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                    device, non_blocking=True) for k, v in dev.items()}

    cap = float(os.environ.get("EVENTCLIP_SWEEP_CACHE_MB", "2048")) * 1e6
    cached = ctx.get("dev_batches")
    t0 = time.perf_counter()
    wait = 0.0
    results = []
    if cached is not None:
        results = [eval_step(dev) for dev in cached]
    else:
        keep, total, fits = [], 0, cap > 0
        batches = device_prefetch(ctx["loader"], prep)
        while True:
            t_wait = time.perf_counter()
            dev = next(batches, None)
            wait += time.perf_counter() - t_wait
            if dev is None:
                break
            results.append(eval_step(dev))
            if fits:
                total += sum(t.numel() * t.element_size()
                             for t in dev.values())
                if total <= cap:
                    keep.append(dev)
                else:
                    fits, keep = False, []
        if fits:
            ctx["dev_batches"] = keep
    sums: Dict[str, float] = {}
    for res in results:
        for k, v in res.items():
            sums[k] = sums.get(k, 0.0) + float(v)
    wall = time.perf_counter() - t0
    n = max(sums.get("n", 1.0), 1.0)
    ctx["evals"].append(dict(sums, weight=weight, wall_s=wall, wait_s=wait,
                             batches=len(results)))
    probs_acc = sums.get("probs_correct", 0.0) / n
    logits_acc = sums.get("logits_correct", 0.0) / n
    if printing:
        print(f"Evaluated {int(n)} samples")
        print(f"\taccuracy@1 (probs): {probs_acc * 100.:.2f}%")
        print(f"\taccuracy@1 (logits): {logits_acc * 100.:.2f}%")
        if top5:
            print(f"\taccuracy@5 (probs): "
                  f"{sums.get('probs_correct5', 0.) / n * 100.:.2f}%")
            print(f"\taccuracy@5 (logits): "
                  f"{sums.get('logits_correct5', 0.) / n * 100.:.2f}%")
        print(f"\t{len(results)} batches in {wall:.2f} s "
              f"({n / wall:.1f} samples/s; host loader wait {wait:.2f} s)")
    return probs_acc, logits_acc


def find_weight(weight_dir: str) -> str:
    """best.npz / best.pth if present, else the latest model_<step>.npz /
    .pth (reference test.py:156-167; the reference trainer's .pth files
    load through models/clip/convert_method.py)."""
    for best in ("best.npz", "best.pth"):
        p = os.path.join(weight_dir, best)
        if os.path.exists(p):
            return p
    weights = [w for w in os.listdir(weight_dir)
               if w.endswith((".npz", ".pth")) and w.startswith("model_")]
    weights = sorted(
        weights, key=lambda x: int(x.rsplit(".", 1)[0].split("_")[1]))
    return os.path.join(weight_dir, weights[-1])


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Run the CLI; returns the accuracies (a sweep's per-shot means) and
    the evaluation context."""
    args = parse_args(argv)
    refuse_unported(args)
    params, cfg_base = load_and_override(args)
    ctx = build_eval_context(params, args)

    if args.train_shots[0] <= 0:
        probs, logits = evaluate(params, args, weight=args.weight, ctx=ctx)
        return {"probs_acc": probs, "logits_acc": logits, "ctx": ctx}

    all_probs, all_logits = [], []
    for num_shot in args.train_shots:
        base = os.path.join(args.ckpt_base, cfg_base)
        dirs = [f"{base}-{num_shot}shot"] + [
            f"{base}-dup{i}-{num_shot}shot" for i in range(1, 11)]
        probs_avg, logits_avg = AverageMeter(), AverageMeter()
        for d in dirs:
            mdir = os.path.join(d, "models")
            if not os.path.exists(mdir):
                continue
            w = find_weight(mdir)
            p, lg = evaluate(params, args, weight=w, printing=False, ctx=ctx)
            probs_avg.update(p, 1)
            logits_avg.update(lg, 1)
        print(f"\n\nTesting {cfg_base}-{num_shot}shot")
        print(f"Mean over {probs_avg.count} duplicate runs:")
        print(f"\taccuracy@1 (probs): {probs_avg.avg * 100.:.2f}%")
        print(f"\taccuracy@1 (logits): {logits_avg.avg * 100.:.2f}%\n")
        all_probs.append(round(probs_avg.avg * 100.0, 2))
        all_logits.append(round(logits_avg.avg * 100.0, 2))

    print("\n\n")
    print(f"accuracy@1 (probs): {all_probs}")
    print("\t", " & ".join(str(a) for a in all_probs))
    print(f"accuracy@1 (logits): {all_logits}")
    print("\t", " & ".join(str(a) for a in all_logits))
    return {"probs": all_probs, "logits": all_logits, "ctx": ctx}


if __name__ == "__main__":
    main()
