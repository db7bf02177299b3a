"""One-command real-asset parity harness of the port.

Port of scripts/parity_check.py, with its arguments, stages, result keys
and exit code, run on the card unless --cpu is given:

    python -m eventclip_tpu_torch.cli.parity_check --clip_ckpt ViT-B-32.pt \\
        [--data_root /data/N-Caltech101] \\
        [--params configs/zsclip/zsclip_ncaltech_params.py] \\
        [--npz_out clip_vitb32.npz] [--bs 32] [--cpu] \\
        [--method_ckpt best.pth ... --method_params cfg.py ...] \\
        [--fs_shots K [--fs_params cfg --fs_epochs E --fs_roundtrip]]

which, in order:
  1. loads + converts the checkpoint to the framework npz
     (models/clip/convert.py, as cli/convert_clip.py does);
  2. checks activation parity of both towers, built from the checkpoint
     in f32 (TF32 off), against an independent torch implementation of
     the reference model equations, `tests/torch_oracle.py` of the
     repository's checkout (loaded by file path), and a ResNet image
     tower against the torch ModifiedResNet of `tests/test_resnet.py`
     (its class definitions alone: that module imports JAX); the stage
     is skipped with a note where those files are absent;
  3. checks the BPE tokenizer against the published token ids of CLIP's
     README example, when the vocab asset is found (bpe_asset_paths(),
     EVENTCLIP_BPE_PATH first: a merge table of another vocabulary there
     rightly fails);
  4. runs zero-shot top-1 over --data_root with the converted weights
     through cli/test.py's main;
  5. evaluates each --method_ckpt (a reference-trained `.pth` or an npz)
     with its --method_params config through the same main (--weight);
  6. with --fs_shots K: trains a K-shot model from the converted weights
     through cli/train.py in a subprocess, evaluates its best checkpoint
     and, with --fs_roundtrip, exports it to the reference's .pth key
     space (cli/convert_checkpoint.py, a subprocess) and re-evaluates it
     on the same cached eval batches: the two must agree bit for bit;

then writes PARITY_RESULT.json next to the checkpoint (or --out) and exits
1 if any executed stage failed. A stage that cannot run (no asset, no
--data_root) is recorded with ok None and a note. Each stage's record
holds its wall seconds (`wall_s`); the conversion's are printed.
"""

from __future__ import annotations

import argparse
import ast
import collections
import importlib.util
import json
import os
import os.path as osp
import subprocess
import sys
import time
import traceback
import types
from typing import List, Optional

import numpy as np
import torch

# the repository's checkout: tests/torch_oracle.py and the configs
REPO = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(
        description="One-command real-asset parity harness of the port")
    p.add_argument("--clip_ckpt", required=True,
                   help="OpenAI CLIP checkpoint (.pt: torchscript archive "
                   "or plain state dict)")
    p.add_argument("--data_root", default="",
                   help="dataset tree for the zero-shot top-1 stage "
                   "(skipped when absent)")
    p.add_argument("--params",
                   default="configs/zsclip/zsclip_ncaltech_params.py",
                   help="zero-shot config for stage 4; its arch is "
                   "overridden by the checkpoint's")
    p.add_argument("--npz_out", default="",
                   help="where to write the converted npz "
                   "(default: <ckpt>.npz)")
    p.add_argument("--out", default="",
                   help="result JSON path (default: PARITY_RESULT.json "
                   "next to the checkpoint)")
    p.add_argument("--bs", type=int, default=0, help="eval batch override")
    p.add_argument("--tol", type=float, default=2e-3,
                   help="tower-activation tolerance (fp16-origin weights "
                   "re-accumulated in f32 land well inside 2e-3)")
    p.add_argument("--method_ckpt", nargs="*", default=[],
                   help="reference-trained method checkpoint(s) (.pth, or "
                   "an npz) to evaluate")
    p.add_argument("--method_params", nargs="*", default=[],
                   help="the experiment config each --method_ckpt was "
                   "trained with (same count, same order)")
    p.add_argument("--fs_shots", type=int, default=0,
                   help="also train a K-shot model from the converted "
                   "weights (cli.train subprocess) and evaluate its best "
                   "checkpoint")
    p.add_argument("--fs_params",
                   default="configs/fsclip/joint_adapter/"
                   "joint_fsclip_ncaltech_params.py",
                   help="few-shot config for --fs_shots; its arch is "
                   "overridden by the checkpoint's")
    p.add_argument("--fs_epochs", type=int, default=0,
                   help="epoch override for the --fs_shots run "
                   "(0 = the config's)")
    p.add_argument("--fs_roundtrip", action="store_true",
                   help="with --fs_shots: export the trained checkpoint "
                   "back to the reference's .pth key space and assert the "
                   "re-imported eval matches bit for bit")
    p.add_argument("--workdir", default="",
                   help="where --fs_shots writes checkpoints (default: "
                   "parity_fs/ next to the result JSON)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU; default: the card")
    args = p.parse_args(argv)
    if len(args.method_ckpt) != len(args.method_params):
        p.error("--method_ckpt and --method_params must pair up "
                f"({len(args.method_ckpt)} vs {len(args.method_params)})")
    return args


def bpe_available() -> bool:
    from ..models.clip.tokenizer import bpe_asset_paths

    return any(p and osp.exists(p) for p in bpe_asset_paths())


def load_oracle():
    """tests/torch_oracle.py of the checkout, loaded by file path, or None
    where the file is absent (an installed package without its tests)."""
    path = osp.join(REPO, "tests", "torch_oracle.py")
    if not osp.exists(path):
        return None
    spec = importlib.util.spec_from_file_location("_parity_torch_oracle",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_resnet_oracle():
    """tests/test_resnet.py's ModifiedResNetOracle (pure torch), or None
    where the file is absent. That module imports JAX at its top, so only
    its class definitions are executed here, in a namespace holding the
    names they use."""
    path = osp.join(REPO, "tests", "test_resnet.py")
    if not osp.exists(path):
        return None
    with open(path) as f:
        module = ast.parse(f.read(), path)
    classes = [n for n in module.body if isinstance(n, ast.ClassDef)]
    namespace = {"torch": torch, "nn": torch.nn, "TF": torch.nn.functional,
                 "OrderedDict": collections.OrderedDict}
    exec(compile(ast.Module(body=classes, type_ignores=[]), path, "exec"),
         namespace)
    return namespace["ModifiedResNetOracle"]


def tower_parity(sd, tree, cfg, tol, device):
    """Both towers of `tree` (the converted checkpoint) on `device` in f32
    against the oracles on the raw state dict `sd`, on the JAX harness's
    inputs (2 normal images, 2 token rows); a ResNet tower against
    tests/test_resnet.py's torch ModifiedResNet, and its int8 route must
    refuse it."""
    from ..models.clip.config import ResNetVisionConfig
    from ..models.clip.convert import clip_from_jax
    from ..models.clip.model import encode_image, encode_text
    from ..ops.quant import quantize_classifier_params

    oracle = load_oracle()
    resnet = isinstance(cfg.vision, ResNetVisionConfig)
    resnet_oracle = load_resnet_oracle() if resnet else None
    if oracle is None or (resnet and resnet_oracle is None):
        return {"ok": None, "note": "tests/torch_oracle.py or "
                "tests/test_resnet.py absent (no oracle in this "
                "installation) - tower parity skipped"}
    rng = np.random.default_rng(0)
    v = cfg.vision
    imgs = rng.normal(size=(2, 3, v.image_size, v.image_size)).astype(
        np.float32)
    vocab = sd["token_embedding.weight"].shape[0]
    sot, eot = vocab - 2, vocab - 1  # CLIP convention: last two BPE ids
    toks = np.zeros((2, cfg.text.context_length), dtype=np.int32)
    toks[:, 0] = sot
    toks[0, 1:4] = [320 % vocab, 2368 % vocab, eot]  # "a cat" + EOT
    toks[1, 1:3] = [1929 % vocab, eot]  # "dog" + EOT
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    clip = clip_from_jax(tree, cfg, device)
    res = {"arch": cfg.name, "device": str(device), "tol": tol}
    try:
        x = torch.from_numpy(imgs).to(device)
        with torch.inference_mode():
            ours = encode_image(clip.visual, x).cpu().numpy()
            ours_t = encode_text(clip.text, torch.from_numpy(toks).to(
                device)).cpu().numpy()
        if resnet:
            m = resnet_oracle(layers=v.layers, width=v.width,
                              image_size=v.image_size, heads=v.heads,
                              output_dim=v.output_dim).eval()
            m.load_state_dict({k[len("visual."):]: t for k, t in sd.items()
                               if k.startswith("visual.")})
            with torch.no_grad():
                ref = m(torch.from_numpy(imgs)).numpy()
            # the int8 path must refuse a ResNet tower loudly
            try:
                quantize_classifier_params(types.SimpleNamespace(clip=clip))
                raise AssertionError("int8 quantized a ResNet tower")
            except ValueError as e:
                assert "ViT" in str(e), str(e)
        else:
            ref = oracle.encode_image_torch(sd, imgs, v.heads, v.layers)
        ref_t = oracle.encode_text_torch(sd, toks, cfg.text.heads,
                                         cfg.text.layers)
        res["image_max_abs_diff"] = float(np.max(np.abs(ours - ref)))
        res["text_max_abs_diff"] = float(np.max(np.abs(ours_t - ref_t)))
        np.testing.assert_allclose(ours, ref, rtol=tol, atol=tol)
        np.testing.assert_allclose(ours_t, ref_t, rtol=tol, atol=tol)
        res["ok"] = True
    except AssertionError as e:
        res.update(ok=False, error=str(e)[:2000])
    return res


def tokenizer_check():
    from ..models.clip.tokenizer import (SimpleTokenizer, bpe_asset_paths,
                                         tokenize)

    path = next((p for p in bpe_asset_paths() if p and osp.exists(p)), None)
    if path is None:
        return {"ok": None, "note": "BPE asset absent - drop "
                "bpe_simple_vocab_16e6.txt.gz into eventclip_tpu_torch/"
                "assets/ or set EVENTCLIP_BPE_PATH"}
    tok = SimpleTokenizer(path)
    ids = [int(i) for i in tokenize(["a photo of a cat"], tok,
                                    context_length=77)[0]]
    expected = [49406, 320, 1125, 539, 320, 2368, 49407]
    ok = ids[: len(expected)] == expected and not any(ids[len(expected):])
    return {"ok": bool(ok), "ids": ids[: len(expected)],
            "expected": expected, "bpe_path": path}


def resolve_arch_name(cfg):
    """Registered arch name whose geometry matches the checkpoint's
    inferred config, registering the inferred one when nothing matches
    (the converter names by raw geometry, e.g. 'ViT-768/32@224'; the
    registry names by release, e.g. 'ViT-B/32')."""
    from ..models.clip.config import CLIP_ARCHS

    for reg_name, reg in CLIP_ARCHS.items():
        if (reg.vision, reg.text) == (cfg.vision, cfg.text):
            return reg_name
    CLIP_ARCHS[cfg.name] = cfg
    return cfg.name


def write_derived_config(workdir, base_path, cfg):
    """A config file that registers the checkpoint's inferred geometry and
    swaps the base config's arch to it: the evals and the cli.train
    subprocess load configs by path, and that process has no registration
    of this one."""
    base_path = osp.abspath(base_path)
    name = osp.basename(base_path)[:-3] + "_ckptarch"
    path = osp.join(workdir, name + ".py")
    with open(path, "w") as f:
        f.write(
            f'"""Written by eventclip_tpu_torch/cli/parity_check.py: '
            f'{osp.basename(base_path)} on the checkpoint\'s tower."""\n'
            f"import sys\n"
            f"sys.path.insert(0, {REPO!r})\n"
            f"from eventclip_tpu_torch.models.clip.config import (  "
            f"# noqa: F401\n"
            f"    CLIP_ARCHS, CLIPConfig, ResNetVisionConfig, TextConfig,\n"
            f"    VisionConfig)\n"
            f"from eventclip_tpu_torch.utils.config import load_params\n\n"
            f"_cfg = {cfg!r}\n"
            f"CLIP_ARCHS.setdefault(_cfg.name, _cfg)\n"
            f"_Base = type(load_params({base_path!r}))\n\n\n"
            f"class EventCLIPParams(_Base):\n"
            f"    clip_dict = dict(_Base.clip_dict, arch=_cfg.name)\n"
        )
    return path


def _config_on(cfg_path, arch, cfg, workdir):
    """(a config path whose arch is the checkpoint's, its params)."""
    from ..utils.config import load_params

    params = load_params(cfg_path)
    if params.clip_dict["arch"] != arch:
        print(f"[parity] overriding {osp.basename(cfg_path)} arch "
              f"{params.clip_dict['arch']} -> {arch} (the checkpoint's)")
        os.makedirs(workdir, exist_ok=True)
        cfg_path = write_derived_config(workdir, cfg_path, cfg)
        params = load_params(cfg_path)
    return cfg_path, params


def _eval_argv(args, cfg_path, npz_path):
    argv = ["--params", cfg_path, "--clip_ckpt", npz_path,
            "--data_root", args.data_root]
    if args.bs > 0:
        argv += ["--bs", str(args.bs)]
    return argv + (["--cpu"] if args.cpu else [])


def zero_shot(args, cfg, npz_path):
    from . import test as test_cli
    from ..utils.config import load_params

    if not bpe_available():
        # real weights + random text features = silently garbage numbers;
        # the eval layer refuses that combination, so skip loudly instead
        return {"ok": None, "note": "zero-shot stage needs the BPE asset "
                "to tokenize prompts - skipped"}
    arch = resolve_arch_name(cfg)
    params = load_params(args.params)
    assert params.model == "ZSCLIP", "--params must be a zero-shot config"
    if params.clip_dict["arch"] != arch:
        print(f"[parity] overriding config arch "
              f"{params.clip_dict['arch']} -> {arch} (the checkpoint's)")
    res = test_cli.main(_eval_argv(args, args.params, npz_path)
                        + ["--arch", arch])
    return {"ok": True, "dataset": params.dataset,
            "data_root": args.data_root, "arch": arch,
            "prompt": params.clip_dict.get("prompt"),
            "probs_top1": res["probs_acc"], "logits_top1": res["logits_acc"]}


def _text_note(params):
    """BPE-missing policy for method evals: prompt-tuned ('text-*') configs
    carry their trained text_feats IN the checkpoint, so the tokenizer is
    only needed to initialize the leaf that the weight load overwrites;
    EVENTCLIP_ALLOW_RANDOM_TEXT makes that explicit. Frozen-text configs
    would silently score with garbage text features; those skip."""
    if bpe_available():
        return None
    adapter_type = str(params.adapter_dict.get("adapter_type", ""))
    if adapter_type.startswith("text-"):
        os.environ["EVENTCLIP_ALLOW_RANDOM_TEXT"] = "1"
        return ("BPE asset absent - text init random; the prompt-tuned "
                "text_feats leaf loads from the checkpoint")
    return "skip"


def _workdir(args, out_path):
    return osp.abspath(
        args.workdir or osp.join(osp.dirname(out_path) or ".", "parity_fs"))


def method_eval(args, cfg, npz_path, ckpt, cfg_path, workdir):
    """Stage 5: a reference-trained method checkpoint through cli.test's
    main with --weight (load_checkpoint converts a .pth on the fly)."""
    from . import test as test_cli

    arch = resolve_arch_name(cfg)
    path, params = _config_on(cfg_path, arch, cfg, workdir)
    assert params.model != "ZSCLIP", (
        f"{cfg_path}: --method_params/--fs_params must be FS/FT configs")
    note = _text_note(params)
    if note == "skip":
        return {"ok": None, "ckpt": ckpt,
                "note": "frozen-text config needs the BPE asset to encode "
                "prompts - skipped"}
    res = test_cli.main(_eval_argv(args, path, npz_path)
                        + ["--weight", ckpt])
    out = {"ok": True, "ckpt": osp.abspath(ckpt), "params": cfg_path,
           "arch": arch, "dataset": params.dataset,
           "probs_top1": res["probs_acc"], "logits_top1": res["logits_acc"]}
    if note:
        out["note"], out["random_text_init"] = note, True
    return out


def few_shot(args, cfg, npz_path, workdir):
    """Stage 6: train a K-shot model from the converted weights through
    cli.train (a subprocess), evaluate its best checkpoint and, with
    --fs_roundtrip, its export to the reference's .pth key space on the
    same cached eval batches: the two must agree bit for bit."""
    from . import test as test_cli

    arch = resolve_arch_name(cfg)
    os.makedirs(workdir, exist_ok=True)
    params_path, base = _config_on(osp.abspath(args.fs_params), arch, cfg,
                                   workdir)
    note = _text_note(base)
    if note == "skip":
        return {"ok": None, "note": "frozen-text config needs the BPE "
                "asset to seed the text features - skipped"}

    cmd = [sys.executable, "-m", "eventclip_tpu_torch.cli.train",
           "--params", params_path, "--num_shots", str(args.fs_shots),
           "--clip_ckpt", osp.abspath(npz_path),
           "--data_root", osp.abspath(args.data_root),
           "--ckpt_base", workdir]
    if args.fs_epochs > 0:
        cmd += ["--max_epochs", str(args.fs_epochs)]
    if args.cpu:
        cmd += ["--cpu"]
    print(f"[parity] training: {' '.join(cmd)}")
    r = subprocess.run(cmd, cwd=REPO, env=dict(os.environ),
                       capture_output=True, text=True)
    if r.returncode != 0:
        return {"ok": False, "cmd": cmd,
                "error": (r.stdout[-1500:] + r.stderr[-1500:])}

    cfg_base = osp.basename(params_path)[:-3]
    mdir = osp.join(workdir, f"{cfg_base}-{args.fs_shots}shot", "models")
    weight = test_cli.find_weight(mdir)
    eval_args = test_cli.parse_args(_eval_argv(args, params_path, npz_path))
    params, _ = test_cli.load_and_override(eval_args)
    ctx = test_cli.build_eval_context(params, eval_args)
    probs_acc, logits_acc = test_cli.evaluate(
        params, eval_args, weight=weight, printing=True, ctx=ctx)
    out = {"ok": True, "shots": args.fs_shots, "params": params_path,
           "arch": arch, "weight": weight,
           "probs_top1": probs_acc, "logits_top1": logits_acc}
    if note:
        out["note"], out["random_text_init"] = note, True

    if args.fs_roundtrip:
        # export to the reference's key space, re-import, re-evaluate
        # against the SAME cached eval batches: must agree bit for bit
        pth = osp.join(mdir, "roundtrip.pth")
        conv = [sys.executable, "-m",
                "eventclip_tpu_torch.cli.convert_checkpoint", weight, pth]
        if params.model == "FTCLIP":
            conv.append(osp.abspath(npz_path))  # FT re-embeds the tower
        r = subprocess.run(conv, cwd=REPO, capture_output=True, text=True)
        if r.returncode != 0:
            out["ok"] = False
            out["roundtrip"] = {"error": r.stdout[-1500:] + r.stderr[-1500:]}
            return out
        p2, l2 = test_cli.evaluate(params, eval_args, weight=pth,
                                   printing=False, ctx=ctx)
        out["roundtrip"] = {
            "pth": pth, "probs_top1": p2, "logits_top1": l2,
            "bit_equal": bool(p2 == probs_acc and l2 == logits_acc),
        }
        out["ok"] = out["ok"] and out["roundtrip"]["bit_equal"]
    return out


def _staged(fn, *a, **extra):
    """Run one stage: its record with its wall seconds; an exception is
    recorded (ok False), never swallowed silently."""
    t0 = time.perf_counter()
    try:
        res = fn(*a)
    except Exception as e:  # recorded, not swallowed: ok goes False
        traceback.print_exc()
        res = {"ok": False, "error": str(e)[:2000], **extra}
    res["wall_s"] = time.perf_counter() - t0
    return res


def main(argv: Optional[List[str]] = None) -> int:
    """Run the harness; returns the exit code (0: every executed stage
    passed) after writing the result JSON."""
    from ..engine.checkpoint import save_checkpoint
    from ..models.clip.convert import flatten_tree, load_clip_checkpoint

    args = parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")
    result = {"ckpt": osp.abspath(args.clip_ckpt)}
    out_path = args.out or osp.join(
        osp.dirname(osp.abspath(args.clip_ckpt)) or ".",
        "PARITY_RESULT.json",
    )
    workdir = _workdir(args, out_path)

    # 1. load + convert
    t0 = time.perf_counter()
    obj = torch.load(args.clip_ckpt, map_location="cpu", weights_only=False)
    sd = obj.state_dict() if hasattr(obj, "state_dict") else obj
    sd = {k: v.float() for k, v in sd.items()
          if isinstance(v, torch.Tensor)}
    tree, cfg = load_clip_checkpoint(args.clip_ckpt)
    result["arch"] = cfg.name
    npz_path = args.npz_out or (osp.splitext(args.clip_ckpt)[0] + ".npz")
    save_checkpoint(npz_path, flatten_tree(tree), extra={"arch": cfg.name})
    result["converted_npz"] = osp.abspath(npz_path)
    print(f"[parity] {cfg.name}: converted -> {npz_path} "
          f"({time.perf_counter() - t0:.1f} s)")

    # 2. tower activation parity vs the torch oracle
    result["tower_parity"] = _staged(tower_parity, sd, tree, cfg, args.tol,
                                     device)
    del tree
    print(f"[parity] towers: {result['tower_parity']}")

    # 3. tokenizer golden ids (when the asset exists)
    result["tokenizer"] = _staged(tokenizer_check)
    print(f"[parity] tokenizer: {result['tokenizer']}")

    # 4. zero-shot top-1 (when a dataset tree is supplied)
    if args.data_root:
        result["zero_shot"] = _staged(zero_shot, args, cfg, npz_path)
    else:
        result["zero_shot"] = {"ok": None,
                               "note": "no --data_root supplied"}
    print(f"[parity] zero-shot: {result['zero_shot']}")

    # 5. reference-trained method checkpoints (the FS/FT leg of the
    #    parity matrix)
    evals = []
    for ckpt, cfg_path in zip(args.method_ckpt, args.method_params):
        if not args.data_root:
            evals.append({"ok": None, "ckpt": ckpt,
                          "note": "needs --data_root"})
        else:
            evals.append(_staged(method_eval, args, cfg, npz_path, ckpt,
                                 cfg_path, workdir, ckpt=ckpt))
        print(f"[parity] method eval: {evals[-1]}")
    if evals:
        result["method_evals"] = evals

    # 6. K-shot train-from-converted-weights + eval (+ .pth roundtrip)
    if args.fs_shots > 0:
        if not args.data_root:
            result["few_shot"] = {"ok": None, "note": "needs --data_root"}
        else:
            result["few_shot"] = _staged(few_shot, args, cfg, npz_path,
                                         workdir)
        print(f"[parity] few-shot: {result['few_shot']}")

    stages = [result["tower_parity"], result["tokenizer"],
              result["zero_shot"], *evals, result.get("few_shot")]
    executed = [v for v in stages if v is not None and v["ok"] is not None]
    result["ok"] = bool(executed) and all(v["ok"] for v in executed)
    with open(out_path, "w") as f:
        json.dump(result, f, indent=2)
    print(f"[parity] wrote {out_path}  ok={result['ok']}")
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
