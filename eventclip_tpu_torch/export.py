"""Frozen serving bundles: one self-contained file per deployment.

Port of eventclip_tpu/export.py over `torch.export`. A live
`serve.Predictor` rebuilds the model on every process start (config
import, CLIP construction, checkpoint load, text-tower prompting); this
module freezes its device programs into one bundle, so a serving host
needs no model-building code and no checkpoint or config files:

    # build host (has config + weights):
    python -m eventclip_tpu_torch.export --params configs/zsclip/... \\
        --classes names.txt --out model.eclip

    # serving host (has only the bundle and this package):
    from eventclip_tpu_torch.export import ExportedPredictor
    pred = ExportedPredictor("model.eclip")
    out = pred.predict(list_of_event_arrays)

What the bundle pins, as the JAX package's does:
- the traced device programs (rasterize -> preprocess -> CLIP ->
  aggregation) at fixed shapes: the padded step and one view-packed step
  per packing bucket, so a short request keeps live serving's small-request
  economy; the text program (tokens -> L2-normalized features) unless the
  checkpoint prompt-tunes or the build host has no BPE vocab; with
  `embed=True` the embeddings program;
- the weights (int8 towers included), stored ONCE as raw leaf bytes in a
  STORED zip member; every program takes them as its first argument (a
  list of leaves, through `torch.func.functional_call`), so the programs
  carry no weight-sized copies;
- the label space, TTA mode and sensor geometry in a JSON header from
  which `ExportedPredictor` (a `Predictor` subclass) rebuilds the host
  half: windowing, chunking, packing and TTA aggregation are the live
  code.

Kernels: the graphs keep the hand-written kernels as the `eventclip::`
custom ops of ops/custom_ops.py, so loading needs this package. Each op
dispatches on its inputs' device when the graph runs: on the card it
launches its CUDA kernel, on the CPU it runs its plain version.

The graphs are traced on the exporting predictor's device, with no_grad.
`platforms` lists the device types a bundle may load on (by default the
exporting one); a load on a listed type other than the traced device moves
the graph there (`torch.export.passes.move_to_device_pass`). A bundle
traced on the card lists the card only: its bf16 products are the card's
f32-accumulating GEMMs (`mm` with `out_dtype`), which the CPU lacks. A
bundle traced on the CPU may also list "cuda". Scope: single-card
programs.
"""

from __future__ import annotations

import io
import json
import os
import sys
import zipfile
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from .models.classifier import normalize
from .models.clip.model import encode_text
from .serve import Predictor, device_step, embed_features

_FORMAT = "eventclip_tpu_torch"
# a string, so the JAX package's loader, which expects its own integer,
# names this format in its refusal
_FORMAT_VERSION = f"{_FORMAT}/1"
_META_NAME = "meta.json"
_STEP_NAME = "step.pt2"
_TEXT_NAME = "text.pt2"
_EMBED_NAME = "embed.pt2"
_BPE_NAME = "bpe_vocab.bin"
_PARAMS_NAME = "params.bin"
_DEVICE_TYPES = ("cpu", "cuda")
_DTYPES = {str(d).removeprefix("torch."): d
           for d in (torch.float32, torch.bfloat16, torch.float16,
                     torch.int8, torch.int32, torch.int64, torch.bool)}


def _packed_name(bucket: int) -> str:
    return f"packed_{bucket}.pt2"


def _leaves(params: nn.Module):
    """(names, tensors) of every parameter and buffer of the weight tree,
    in module order: the positional contract between the bundle's weight
    member and every program's first argument."""
    named = [*params.named_parameters(), *params.named_buffers()]
    return [n for n, _ in named], [t.detach() for _, t in named]


class _Program(nn.Module):
    """One device program as a module over the weight tree (`params`, a
    submodule, so `functional_call` can put the leaves in its place)."""

    def __init__(self, params: nn.Module, fn: Callable):
        super().__init__()
        self.params = params
        self._fn = fn

    def forward(self, *args):
        return self._fn(self.params, *args)


class _Frozen(nn.Module):
    """The exported root: (leaves, *inputs) -> outputs. The program is not
    a submodule, so its weights are no state of the export: they arrive as
    the first argument."""

    def __init__(self, program: _Program, names: Sequence[str]):
        super().__init__()
        object.__setattr__(self, "_program", program)
        self._names = [f"params.{n}" for n in names]

    def forward(self, leaves: List[torch.Tensor], *args):
        return torch.func.functional_call(
            self._program, dict(zip(self._names, leaves)), args)


def _export(fn, params, names, leaves, args) -> bytes:
    """Trace fn(params, *args) with the weights as inputs -> a saved
    ExportedProgram, the `eventclip::` ops kept as nodes."""
    with torch.no_grad():
        ep = torch.export.export(_Frozen(_Program(params, fn), names),
                                 (leaves, *args), strict=False)
    ep.example_inputs = None  # the example leaves are the weights
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def _text_skip(pred: Predictor):
    """(why the bundle carries no text program or None, the BPE vocab
    path): JAX export.py's refusal texts."""
    if pred._cfg.prompt_tuning:
        return ("this checkpoint prompt-tunes its text features "
                "(trained parameters); swapping class names would "
                "discard the tuning — rebuild with a matching "
                "checkpoint, then re-export"), None
    from .models.clip.tokenizer import bpe_asset_paths

    src = next((p for p in bpe_asset_paths() if p and os.path.exists(p)),
               None)
    if src is None:
        return ("the build host had no BPE vocab asset, so the "
                "bundle carries no tokenizer — re-export with "
                "bpe_simple_vocab_16e6.txt.gz present (or "
                "EVENTCLIP_BPE_PATH set) to enable offline "
                "set_classes"), None
    return None, src


def export_predictor(pred: Predictor, path: str, *,
                     platforms: Optional[Sequence[str]] = None) -> dict:
    """Freeze `pred`'s device programs + weights into `path`.

    platforms: the device types ("cpu", "cuda") the bundle may load on;
        default: the exporting predictor's. A bundle traced on the card
        lists "cuda" only.

    Returns the metadata dict written into the bundle. The weights are
    written once as raw leaf bytes, so the file is about the size of the
    weights however many bucket programs freeze."""
    if getattr(pred, "data_parallel", False):
        raise ValueError(
            "export_predictor freezes single-device programs; build the "
            "Predictor with data_parallel=False (a multi-chip deployment "
            "re-shards at load time and should serve live)")
    dev = pred.device
    platforms = list(platforms or [dev.type])
    bad = [p for p in platforms if p not in _DEVICE_TYPES]
    if bad:
        raise ValueError(f"platforms {bad}: a bundle loads on "
                         f"{list(_DEVICE_TYPES)}")
    if dev.type == "cuda" and set(platforms) != {"cuda"}:
        raise ValueError(
            f"platforms {platforms}: a bundle traced on the card loads on "
            "the card only (its bf16 products are the card's "
            "f32-accumulating GEMMs); export on the CPU for a bundle that "
            "loads on both")
    params = pred._params
    names, leaves = _leaves(params)
    tf_idx = names.index("text_feats")
    cfg, spec, pp = pred._cfg, pred._spec, pred._pp
    bs, V, N = pred.batch_size, pred.views, pred.window
    buckets = list(pred._buckets or [])
    text_skip, bpe_src = _text_skip(pred)

    wins = torch.zeros((bs, V, N, 3), dtype=torch.int16, device=dev)
    valid = torch.ones((bs, V), dtype=torch.bool, device=dev)

    def step(p, w, v):
        return device_step(p, cfg, spec, pp, w, v)["probs"]

    def step_packed(p, w, src, v):
        return device_step(p, cfg, spec, pp, w, v, src)["probs"]

    def embed(p, w, v):
        return embed_features(device_step(p, cfg, spec, pp, w, v), v)

    def text(p, tokens):
        return normalize(encode_text(p.clip.text, tokens))

    def freeze(fn, *args):
        return _export(fn, params, names, leaves, args)

    programs = {_STEP_NAME: freeze(step, wins, valid)}
    for k in buckets:
        programs[_packed_name(k)] = freeze(
            step_packed, torch.zeros((k, N, 3), dtype=torch.int16,
                                     device=dev),
            torch.full((k,), bs * V, dtype=torch.int32, device=dev), valid)
    if text_skip is None:
        # one n_cls: the classification programs bake the class count into
        # their logits shape, so only same-count swaps can reuse them
        programs[_TEXT_NAME] = freeze(text, torch.zeros(
            (len(pred.class_names), cfg.clip.text.context_length),
            dtype=torch.int32, device=dev))
    if pred._embed:
        programs[_EMBED_NAME] = freeze(embed, wins, valid)

    bpe_text = None
    if text_skip is None:
        import gzip

        opener = gzip.open if bpe_src.endswith(".gz") else open
        with opener(bpe_src, "rt", encoding="utf-8") as f:
            bpe_text = f.read()

    manifest, offset = [], 0
    for t in leaves:
        nbytes = t.numel() * t.element_size()
        manifest.append({"dtype": str(t.dtype).removeprefix("torch."),
                         "shape": list(t.shape), "offset": offset,
                         "nbytes": nbytes})
        offset += nbytes
    meta = {
        "format": _FORMAT,
        "format_version": _FORMAT_VERSION,
        "model": cfg.model,
        "arch": cfg.clip.name,
        "class_names": list(pred.class_names),
        # host recipe for offline set_classes (or why it's unavailable);
        # text_feats_idx is the positional leaf the swap replaces
        "text_feats_idx": tf_idx,
        "text": ({"skip": text_skip} if text_skip is not None else {
            "prompt": pred._prompt,
            "context_length": int(cfg.clip.text.context_length),
            "n_cls": len(pred.class_names),
        }),
        "embed": bool(pred._embed),
        "batch_size": int(bs),
        "views": int(V),
        "window": int(N),
        "resolution": [int(pred.resolution[0]), int(pred.resolution[1])],
        "tta": bool(pred.tta),
        "buckets": [int(k) for k in buckets],
        "params_manifest": manifest,
        # the leaves are raw native-order bytes (bf16 included): a host of
        # the other byte order refuses them instead of viewing garbage
        "byteorder": sys.byteorder,
        "platforms": platforms,
        "traced_on": str(dev),
        "program_bytes": {k: len(v) for k, v in programs.items()},
        "weight_bytes": offset,
        "torch_version": torch.__version__,
    }
    tmp = path + ".tmp"
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr(_META_NAME, json.dumps(meta, indent=1))
        # weight bytes are dense float data: STORED (deflating them costs
        # minutes for nothing), written leaf by leaf from host copies
        info = zipfile.ZipInfo(_PARAMS_NAME)
        info.compress_type = zipfile.ZIP_STORED
        with z.open(info, "w", force_zip64=True) as fh:
            for t in leaves:
                fh.write(t.contiguous().reshape(-1).view(torch.uint8)
                         .cpu().numpy().tobytes())
        if bpe_text is not None:
            z.writestr(_BPE_NAME, bpe_text)
        for name, blob in programs.items():
            z.writestr(name, blob)
    os.replace(tmp, path)
    return meta


def _check_format(path: str, meta: dict) -> None:
    if meta.get("format") != _FORMAT:
        if isinstance(meta.get("format_version"), int):
            raise ValueError(
                f"{path} is an eventclip_tpu (JAX) bundle (format_version "
                f"{meta['format_version']}, jax {meta.get('jax_version')}): "
                "load it with eventclip_tpu.export.ExportedPredictor, or "
                "re-export with eventclip_tpu_torch.export")
        raise ValueError(f"{path}: not an {_FORMAT} bundle (format "
                         f"{meta.get('format')!r})")
    if meta.get("format_version") != _FORMAT_VERSION:
        raise ValueError(
            f"{path}: bundle format {meta.get('format_version')} "
            f"!= supported {_FORMAT_VERSION} — re-export with this "
            f"version's eventclip_tpu_torch.export")


class ExportedPredictor(Predictor):
    """Serve from a bundle written by `export_predictor`, on `device` (the
    card unless the caller asks for the CPU).

    Builds no model: the device phase is the loaded programs (padded, one
    per packing bucket, embed) fed the bundle's weight leaves; every host
    method (stream validation, content-seeded windowing, TTA variants,
    chunking and packing, probability finalization) is inherited
    unchanged, so its answers equal the exporting Predictor's on the same
    streams."""

    def __init__(self, path: str, device="cuda"):
        with zipfile.ZipFile(path) as z:
            meta = json.loads(z.read(_META_NAME).decode("utf-8"))
            _check_format(path, meta)
            build_order = meta.get("byteorder", "little")
            if build_order != sys.byteorder:
                raise ValueError(
                    f"{path} stores {build_order}-endian weight bytes but "
                    f"this host is {sys.byteorder}-endian — re-export on a "
                    "matching host (the leaves are raw native-order bytes)")
            self.device = torch.device(device)
            backend = self.device.type
            if backend not in meta["platforms"]:
                raise ValueError(
                    f"{path} was lowered for {meta['platforms']}, but this "
                    f"process runs on '{backend}' — re-export with "
                    f"platforms=('{backend}',) or a multi-platform list")
            members = set(z.namelist())
            blobs = {n: z.read(n) for n in members if n.endswith(".pt2")}
            bpe_text = (z.read(_BPE_NAME).decode("utf-8")
                        if _BPE_NAME in members else None)
            # leaf by leaf out of the STORED member: loading never holds a
            # second full copy of the weights on the host
            leaves = []
            with z.open(_PARAMS_NAME) as fh:
                for spec in meta["params_manifest"]:
                    raw = bytearray(fh.read(spec["nbytes"]))
                    t = torch.frombuffer(raw, dtype=torch.uint8) if raw \
                        else torch.empty(0, dtype=torch.uint8)
                    leaves.append(t.view(_DTYPES[spec["dtype"]]).reshape(
                        spec["shape"]).to(self.device))
        self.meta = meta
        self.class_names = list(meta["class_names"])
        self.batch_size = int(meta["batch_size"])
        self.views = int(meta["views"])
        self.window = int(meta["window"])
        self.resolution = (int(meta["resolution"][0]),
                           int(meta["resolution"][1]))
        self.tta = bool(meta["tta"])
        self._params = leaves
        self._tf_idx = int(meta["text_feats_idx"])
        # the preprocess resampling runs in full f32 (ops/preprocess.py)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        def load(name):
            from torch.export.passes import move_to_device_pass

            ep = torch.export.load(io.BytesIO(blobs[name]))
            if torch.device(meta["traced_on"]) != self.device:
                ep = move_to_device_pass(ep, self.device)
            return ep.module()

        self._step = load(_STEP_NAME)
        self._buckets = [int(k) for k in meta["buckets"]] or None
        self.data_parallel = False  # a bundle is a single-device program
        self._step_packed = {k: load(_packed_name(k))
                             for k in self._buckets or []}
        self._embed = _EMBED_NAME in blobs
        self._embed_step = load(_EMBED_NAME) if self._embed else None
        self._text_step = load(_TEXT_NAME) if _TEXT_NAME in blobs else None
        # offline label swaps: the tokenizer is built at the first swap
        self._bpe_text = bpe_text
        self._tokenizer = None

    @torch.inference_mode()
    def _dispatch_chunk(self, batch):
        """The loaded program a placed chunk selects: the packed one of its
        bucket (the packed axis length), or the padded one."""
        if "view_src" in batch:
            fn = self._step_packed[int(batch["windows"].shape[0])]
            return fn(self._params, batch["windows"], batch["view_src"],
                      batch["valid_mask"])
        return self._step(self._params, batch["windows"],
                          batch["valid_mask"])

    @torch.inference_mode()
    def _embed_chunk(self, batch):
        return self._embed_step(self._params, batch["windows"],
                                batch["valid_mask"])

    def set_classes(self, class_names) -> None:
        """Offline label swap: tokenize the prompted names with the
        bundled BPE vocab, run the frozen text program and replace the
        text-features leaf (the live `Predictor.set_classes` recipe).

        Same-count swaps only: every frozen classification program bakes
        n_cls into its logits shape. ValueError throughout: the category
        the HTTP layer maps to 400."""
        info = self.meta.get("text") or {}
        if self._text_step is None:
            raise ValueError("this bundle cannot swap labels: "
                             + info.get("skip", "it has no text program"))
        names = [str(n) for n in class_names]
        if not names:
            raise ValueError("class_names must be non-empty")
        if len(names) != info["n_cls"]:
            raise ValueError(
                f"the frozen programs bake n_cls={info['n_cls']} into "
                f"their logits shapes; an exported bundle can only swap to "
                f"the same count (got {len(names)}) — different counts "
                "need the live model and a re-export")
        from .models.classifier import tokenize_prompts
        from .models.clip.tokenizer import SimpleTokenizer, parse_merges

        if self._tokenizer is None:
            self._tokenizer = SimpleTokenizer(
                merges=parse_merges(self._bpe_text))
        toks = tokenize_prompts(names, info["prompt"], self._tokenizer,
                                info["context_length"])
        with torch.inference_mode():
            feats = self._text_step(self._params,
                                    torch.from_numpy(toks).to(self.device))
        self._params = list(self._params)
        self._params[self._tf_idx] = feats.clone()
        self.class_names = names

    def embed(self, event_streams):
        if not self._embed:
            raise RuntimeError(
                "the bundle was exported without --embed; re-export with "
                "--embed, or build a live Predictor(embed=True)")
        if not len(event_streams):
            dim = int(self.meta["params_manifest"][self._tf_idx]
                      ["shape"][-1])
            return np.zeros((0, dim), np.float32)
        wins, valids = self.gather_windows(event_streams)
        return self.embed_windows(wins, valids)


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse

    from .serve import resolve_class_names
    from .utils.config import load_params

    ap = argparse.ArgumentParser(
        description="Export a serving bundle (frozen programs + weights)")
    ap.add_argument("--params", required=True, help="experiment config .py")
    ap.add_argument("--out", required=True, help="output bundle path")
    ap.add_argument("--classes", default="", help="one class name per line")
    ap.add_argument("--data_root", default="",
                    help="derive class names from this dataset tree")
    ap.add_argument("--weight", default="", help="trained checkpoint "
                    "(.npz or reference .pth)")
    ap.add_argument("--clip_ckpt", default="", help="OpenAI CLIP .pt")
    ap.add_argument("--smoke", action="store_true",
                    help="random CLIP weights (pipeline validation)")
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--int8_calib", default="",
                    help="with --int8: glob of .npy raw event dumps to "
                    "calibrate STATIC activation scales on (the scales "
                    "freeze into the bundle)")
    ap.add_argument("--prune_tokens", type=int, default=0)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--tta", action="store_true")
    ap.add_argument("--embed", action="store_true",
                    help="also freeze the embeddings program "
                    "(raw events -> one L2-normalized CLIP feature per "
                    "stream, the retrieval use case)")
    ap.add_argument("--platforms", default="",
                    help="comma list of device types the bundle may load "
                    "on, e.g. cpu,cuda (default: the exporting one)")
    ap.add_argument("--cpu", action="store_true",
                    help="build and export on the CPU; default: the card")
    ap.add_argument("--check", action="store_true",
                    help="reload the bundle and verify it reproduces the "
                    "live predictor on random streams")
    args = ap.parse_args(argv)

    device = "cpu" if args.cpu else "cuda"
    params = load_params(args.params)
    names = resolve_class_names(params, args.classes, args.data_root)
    calib_streams = None
    if args.int8_calib:
        import glob as globlib

        files = sorted(globlib.glob(args.int8_calib))
        if not files:
            ap.error(f"--int8_calib matched no files: {args.int8_calib}")
        calib_streams = [np.load(f) for f in files]
    pred = Predictor(
        params, names, weight=args.weight,
        clip_ckpt=args.clip_ckpt or None, smoke=args.smoke,
        int8=args.int8, int8_calib_streams=calib_streams,
        prune_tokens=args.prune_tokens,
        batch_size=args.batch_size, tta=args.tta, embed=args.embed,
        device=device,
    )
    platforms = ([p.strip() for p in args.platforms.split(",") if p.strip()]
                 or None)
    meta = export_predictor(pred, args.out, platforms=platforms)
    size = os.path.getsize(args.out)
    print(f"wrote {args.out} ({size / 1e6:.1f} MB: weights "
          f"{meta['weight_bytes'] / 1e6:.1f} MB, programs "
          f"{sum(meta['program_bytes'].values()) / 1e6:.2f} MB): "
          f"{len(meta['class_names'])} classes, batch {meta['batch_size']}, "
          f"pack buckets {meta['buckets'] or 'off'}, "
          f"platforms {meta['platforms']}")
    if args.check:
        rng = np.random.default_rng(0)
        h, w = pred.resolution
        streams = [
            np.stack([rng.integers(0, w, n), rng.integers(0, h, n),
                      np.sort(rng.random(n)),
                      rng.choice([-1.0, 1.0], n)], axis=1).astype(np.float32)
            for n in (pred.window // 2, pred.window * pred.views)
        ]
        loaded = ExportedPredictor(args.out, device=device)
        live = pred.predict(streams)["probs"]
        frozen = loaded.predict(streams)["probs"]
        delta = float(np.abs(live - frozen).max())
        # both sides route the same bucket policy, so the only daylight is
        # float reduction order between the live and the traced program
        print(f"check: max |live - exported| prob delta = {delta:.2e}")
        if delta > 1e-4:
            raise SystemExit("check FAILED: exported bundle diverges")
        if loaded._text_step is not None:
            # the offline swap must track the live one: reversed labels
            # permute text features, both sides re-predict identically
            rev = list(reversed(pred.class_names))
            pred.set_classes(rev)
            loaded.set_classes(rev)
            d = float(np.abs(pred.predict(streams)["probs"]
                             - loaded.predict(streams)["probs"]).max())
            print(f"check: set_classes prob delta = {d:.2e}")
            if d > 1e-4:
                raise SystemExit("check FAILED: offline set_classes "
                                 "diverges from the live swap")
        if args.embed:
            d = float(np.abs(pred.embed(streams)
                             - loaded.embed(streams)).max())
            print(f"check: embed delta = {d:.2e}")
            if d > 1e-4:
                raise SystemExit("check FAILED: exported embed diverges")
        print("check OK")


if __name__ == "__main__":
    main()
