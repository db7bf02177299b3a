"""Frozen serving bundles: one self-contained file per deployment.

Port of eventclip_tpu/export.py over `torch.export`. A live
`serve.Predictor` rebuilds the model on every process start (config
import, CLIP construction, checkpoint load, text-tower prompting); this
module freezes its device programs into one bundle, so a serving host
needs no model-building code and no checkpoint or config files:

    # build host (has config + weights; on the card, one graph set for
    # the card and one for the CPU):
    python -m eventclip_tpu_torch.export --params configs/zsclip/... \\
        --classes names.txt --out model.eclip --platforms cuda,cpu

    # serving host (has only the bundle and this package):
    from eventclip_tpu_torch.export import ExportedPredictor
    pred = ExportedPredictor("model.eclip")  # or device="cpu"
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

`platforms` lists the device types a bundle may load on (by default the
exporting predictor's). The bundle holds one graph set (every program)
for each listed type this host can trace: the CPU always, the card when
one is present. Each set is traced with its weights and example inputs
on its own device, so every trace-time device branch takes that device's
arm: the card's set holds its bf16 products as `eventclip::dense_bf16`
nodes (D1, ops/dense.py), and the CPU's set the f32 products of the
rounded operands. A type with no set of its own (the card, listed on
a host without one) loads the CPU's set and moves the graph there
(`torch.export.passes.move_to_device_pass`): torch cannot trace a graph
for a device it does not have. The weights are stored once, whatever the
number of sets, and a loader reads only its own set. Scope: single-card
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
from .models.clip.config import EVAVisionConfig
from .models.clip.eva import refuse
from .models.clip.model import encode_text
from .serve import Predictor, device_step, embed_features

_FORMAT = "eventclip_tpu_torch"
# a string, so the JAX package's loader, which expects its own integer,
# names this format in its refusal
_FORMAT_VERSION = f"{_FORMAT}/2"
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


def _member(graph_set: str, name: str) -> str:
    """A program's zip member within a graph set, e.g. 'cuda/step.pt2'."""
    return f"{graph_set}/{name}"


def _trace_set(pred: Predictor, device: torch.device,
               text: bool) -> dict:
    """{member name: saved ExportedProgram} of every program of `pred`,
    traced on `device` from copies of the weights and example inputs made
    there (the predictor's own when it lives there)."""
    params = pred._params
    names, leaves = _leaves(params)
    leaves = [t.to(device) for t in leaves]
    cfg, spec, pp = pred._cfg, pred._spec, pred._pp
    bs, V, N = pred.batch_size, pred.views, pred.window
    wins = torch.zeros((bs, V, N, 3), dtype=torch.int16, device=device)
    valid = torch.ones((bs, V), dtype=torch.bool, device=device)

    def step(p, w, v):
        return device_step(p, cfg, spec, pp, w, v)["probs"]

    def step_packed(p, w, src, v):
        return device_step(p, cfg, spec, pp, w, v, src)["probs"]

    def embed(p, w, v):
        return embed_features(device_step(p, cfg, spec, pp, w, v), v)

    def text_fn(p, tokens):
        return normalize(encode_text(p.clip.text, tokens))

    def freeze(fn, *args):
        return _export(fn, params, names, leaves, args)

    programs = {_STEP_NAME: freeze(step, wins, valid)}
    for k in pred._buckets or []:
        programs[_packed_name(k)] = freeze(
            step_packed, torch.zeros((k, N, 3), dtype=torch.int16,
                                     device=device),
            torch.full((k,), bs * V, dtype=torch.int32, device=device),
            valid)
    if text:
        # one n_cls: the classification programs bake the class count into
        # their logits shape, so only same-count swaps can reuse them
        programs[_TEXT_NAME] = freeze(text_fn, torch.zeros(
            (len(pred.class_names), cfg.clip.text.context_length),
            dtype=torch.int32, device=device))
    if pred._embed:
        programs[_EMBED_NAME] = freeze(embed, wins, valid)
    return programs


def export_predictor(pred: Predictor, path: str, *,
                     platforms: Optional[Sequence[str]] = None) -> dict:
    """Freeze `pred`'s device programs + weights into `path`.

    platforms: the device types ("cpu", "cuda") the bundle may load on;
        default: the exporting predictor's. Each listed type this host can
        trace gets a graph set of its own (the module docstring).

    Returns the metadata dict written into the bundle. The weights are
    written once as raw leaf bytes, so the file is about the size of the
    weights however many programs and sets freeze."""
    if getattr(pred, "data_parallel", False):
        raise ValueError(
            "export_predictor freezes single-device programs; build the "
            "Predictor with data_parallel=False (a multi-chip deployment "
            "re-shards at load time and should serve live)")
    if isinstance(pred._cfg.clip.vision, EVAVisionConfig):
        raise refuse("export", pred._cfg.clip.vision)
    platforms = list(platforms or [pred.device.type])
    bad = [p for p in platforms if p not in _DEVICE_TYPES]
    if bad:
        raise ValueError(f"platforms {bad}: a bundle loads on "
                         f"{list(_DEVICE_TYPES)}")
    # the graph set each platform loads: its own where this host can
    # trace for it, else the CPU's
    set_of = {p: p if p == "cpu" or torch.cuda.is_available() else "cpu"
              for p in platforms}
    # each set on the exporting predictor's device where it is of the
    # set's type, else on the CPU or the current card
    traced_on = {s: pred.device if pred.device.type == s
                 else torch.device(s) for s in set_of.values()}
    names, leaves = _leaves(pred._params)
    tf_idx = names.index("text_feats")
    cfg = pred._cfg
    text_skip, bpe_src = _text_skip(pred)

    programs = {}
    for graph_set, device in traced_on.items():
        for name, blob in _trace_set(pred, device,
                                     text_skip is None).items():
            programs[_member(graph_set, name)] = blob

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
        "batch_size": int(pred.batch_size),
        "views": int(pred.views),
        "window": int(pred.window),
        "resolution": [int(pred.resolution[0]), int(pred.resolution[1])],
        "tta": bool(pred.tta),
        "buckets": [int(k) for k in pred._buckets or []],
        "params_manifest": manifest,
        # the leaves are raw native-order bytes (bf16 included): a host of
        # the other byte order refuses them instead of viewing garbage
        "byteorder": sys.byteorder,
        "platforms": platforms,
        # for each platform: the graph set it loads and where that set
        # was traced (a load elsewhere moves the graph)
        "sets": {p: {"set": s, "traced_on": str(traced_on[s])}
                 for p, s in set_of.items()},
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
            # this platform's graph set only: a bundle holds one set a
            # device type, and the others are never read
            graph_set = meta["sets"][backend]
            prefix = _member(graph_set["set"], "")
            traced_on = torch.device(graph_set["traced_on"])
            members = set(z.namelist())
            blobs = {n[len(prefix):]: z.read(n) for n in members
                     if n.startswith(prefix)}
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
            if traced_on != self.device:
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
                    "on, e.g. cuda,cpu (default: the exporting one); each "
                    "type this host can trace gets a graph set of its own")
    ap.add_argument("--cpu", action="store_true",
                    help="build and export on the CPU; default: the card")
    ap.add_argument("--check", action="store_true",
                    help="reload the bundle on every listed platform this "
                    "host has and verify it reproduces the live predictor "
                    "there on random streams")
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
        # every listed platform this host has, each against a live
        # predictor on the same weights on that device (made before any
        # label swap)
        lives = {p: pred if p == pred.device.type else pred.on_device(p)
                 for p in meta["platforms"]
                 if p == "cpu" or torch.cuda.is_available()}
        for p, live in lives.items():
            _check(args.out, p, live, streams, args.embed)
        print("check OK")


def _check(path: str, device: str, live: Predictor, streams,
           embed: bool) -> None:
    """The bundle loaded on `device` against `live` (on that device):
    probabilities, the offline label swap and embeddings within 1e-4."""
    loaded = ExportedPredictor(path, device=device)
    delta = float(np.abs(live.predict(streams)["probs"]
                         - loaded.predict(streams)["probs"]).max())
    # both sides route the same bucket policy, so the only daylight is
    # float reduction order between the live and the traced program
    print(f"check [{device}]: max |live - exported| prob delta = "
          f"{delta:.2e}")
    if delta > 1e-4:
        raise SystemExit(f"check FAILED [{device}]: exported bundle "
                         "diverges")
    if loaded._text_step is not None:
        # the offline swap must track the live one: reversed labels
        # permute text features, both sides re-predict identically
        rev = list(reversed(live.class_names))
        live.set_classes(rev)
        loaded.set_classes(rev)
        d = float(np.abs(live.predict(streams)["probs"]
                         - loaded.predict(streams)["probs"]).max())
        print(f"check [{device}]: set_classes prob delta = {d:.2e}")
        if d > 1e-4:
            raise SystemExit(f"check FAILED [{device}]: offline "
                             "set_classes diverges from the live swap")
    if embed:
        d = float(np.abs(live.embed(streams) - loaded.embed(streams)).max())
        print(f"check [{device}]: embed delta = {d:.2e}")
        if d > 1e-4:
            raise SystemExit(f"check FAILED [{device}]: exported embed "
                             "diverges")


if __name__ == "__main__":
    main()
