"""Reference-trained EventCLIP *method* checkpoints <-> parameter trees.

Port of eventclip_tpu/models/clip/convert_method.py, in both directions.
The reference trains adapters/prompts/LoRA on top of frozen CLIP and saves
CLIP-free torch checkpoints (``model_<it>.pth`` / ``best.pth``):

- ZS/FS drop every ``model.*`` key from ``state_dict()`` (reference
  models/clip_cls.py:208-219), leaving ``adapter.*`` (TransformerAdapter,
  reference models/adapter.py:53-109) and, for ``text-...`` prompt tuning,
  the ``text_feats`` parameter (models/clip_cls.py:252-257);
- FT also keeps the visual tower under ``model.visual.*``
  (models/clip_cls_ft.py:313-321). With LoRA, each resblock's
  ``attn.in_proj_weight`` becomes a module holding the frozen
  ``merged_proj`` plus ``lora_down_{q,k,v}`` [r, D] / ``lora_up_{q,k,v}``
  [D, r] (models/lora.py:104-148); ``qkvo-...`` specs also wrap
  ``attn.out_proj`` (``.linear.weight`` + ``.lora_down.weight`` /
  ``.lora_up.weight``, models/lora.py:8-58).

`convert_method_state_dict` maps those keys onto the JAX package's tree
paths (numpy leaves), the format engine/checkpoint.py's npz files use, so
`load_checkpoint(target=...)` consumes them through
models/clip/convert.py::jax_path; `export_method_state_dict` /
`save_method_checkpoint` go back to the reference's key space.
"""

from __future__ import annotations

import os
import pickle
import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from .convert import _np, convert_vit_visual

LORA_SLOTS = ("q", "k", "v")


def _unwrap(obj) -> Mapping[str, Any]:
    """torch.load output -> the state dict (nerv and lightning trainers wrap
    it under 'state_dict'/'model'; a plain dict of tensors passes through)."""
    for key in ("state_dict", "model"):
        if isinstance(obj, Mapping) and key in obj and isinstance(
                obj[key], Mapping):
            return obj[key]
    if hasattr(obj, "state_dict"):
        return obj.state_dict()
    assert isinstance(obj, Mapping), f"not a state dict: {type(obj)}"
    return obj


def _layer_indices(sd: Mapping[str, Any], pattern: str) -> int:
    """Number of layers L for keys matching ``pattern`` (one capture group
    holding the layer index); asserts 0..L-1 are all present."""
    idx = {int(m.group(1)) for k in sd for m in [re.match(pattern, k)] if m}
    assert idx == set(range(len(idx))), f"non-contiguous layers {sorted(idx)}"
    return len(idx)


def _convert_adapter(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """``adapter.*`` (torch TransformerAdapter) -> our adapter pytree
    (models/adapter.py here; layer-stacked like the CLIP towers). The
    layouts agree leaf-for-leaf (torch Linear weights are [out, in] on both
    sides), so this is gather + stack, no transposes — the same mapping
    tests/test_adapter.py::torch_adapter round-trips."""
    L = _layer_indices(sd, r"adapter\.transformer_encoder\.layers\.(\d+)\.")

    def gather(suffix):
        return np.stack([
            _np(sd[f"adapter.transformer_encoder.layers.{i}.{suffix}"])
            for i in range(L)
        ])

    return {
        "in_proj": {"w": _np(sd["adapter.in_proj.weight"]),
                    "b": _np(sd["adapter.in_proj.bias"])},
        "out_proj": {"w": _np(sd["adapter.out_proj.weight"]),
                     "b": _np(sd["adapter.out_proj.bias"])},
        "blocks": {
            "attn": {
                "wqkv": gather("self_attn.in_proj_weight"),
                "bqkv": gather("self_attn.in_proj_bias"),
                "wo": gather("self_attn.out_proj.weight"),
                "bo": gather("self_attn.out_proj.bias"),
            },
            "mlp": {
                "w1": gather("linear1.weight"), "b1": gather("linear1.bias"),
                "w2": gather("linear2.weight"), "b2": gather("linear2.bias"),
            },
            "ln_1": {"scale": gather("norm1.weight"),
                     "bias": gather("norm1.bias")},
            "ln_2": {"scale": gather("norm2.weight"),
                     "bias": gather("norm2.bias")},
        },
    }


def _split_lora(visual_sd: Dict[str, Any]):
    """Separate injected-LoRA keys from a ``visual.*`` state dict.

    Returns (plain visual sd with ``attn.in_proj_weight`` /
    ``attn.out_proj.weight`` restored to their pre-injection names, lora
    pytree or None). Orientation: our per-layer leaves are a [r, D] and
    b [D, r] applied as (x @ a.T) @ b.T (model.py::_lora_delta) — exactly
    the reference's ``down`` and ``up``, so again a pure gather."""
    pre = "visual.transformer.resblocks"
    if f"{pre}.0.attn.in_proj_weight.merged_proj" not in visual_sd:
        return visual_sd, None
    L = _layer_indices(visual_sd, re.escape(pre) + r"\.(\d+)\.")
    plain, lora = dict(visual_sd), {}

    def take(i, suffix):
        return _np(plain.pop(f"{pre}.{i}.attn.{suffix}"))

    targets = [s for s in LORA_SLOTS
               if f"{pre}.0.attn.in_proj_weight.lora_down_{s}" in visual_sd]
    for i in range(L):
        plain[f"{pre}.{i}.attn.in_proj_weight"] = take(
            i, "in_proj_weight.merged_proj")
        for s in targets:
            lora.setdefault(s, {"a": [], "b": []})
            lora[s]["a"].append(take(i, f"in_proj_weight.lora_down_{s}"))
            lora[s]["b"].append(take(i, f"in_proj_weight.lora_up_{s}"))
        if f"{pre}.{i}.attn.out_proj.linear.weight" in plain:
            plain[f"{pre}.{i}.attn.out_proj.weight"] = take(
                i, "out_proj.linear.weight")
            plain[f"{pre}.{i}.attn.out_proj.bias"] = take(
                i, "out_proj.linear.bias")
            lora.setdefault("o", {"a": [], "b": []})
            lora["o"]["a"].append(take(i, "out_proj.lora_down.weight"))
            lora["o"]["b"].append(take(i, "out_proj.lora_up.weight"))
    lora = {t: {k: np.stack(v) for k, v in ab.items()}
            for t, ab in lora.items()}
    return plain, lora


def convert_method_state_dict(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Reference method checkpoint (unwrapped state dict) -> nested pytree
    of this framework's parameter paths. Emits only what the checkpoint
    carries: 'adapter', 'text_feats', 'lora', 'clip'/'visual'."""
    out: Dict[str, Any] = {}
    if "text_feats" in sd:  # prompt tuning (clip_cls.py:252-257)
        out["text_feats"] = _np(sd["text_feats"])
    if "adapter.in_proj.weight" in sd:  # TransformerAdapter
        out["adapter"] = _convert_adapter(sd)
    visual_sd = {k[len("model."):]: v for k, v in sd.items()
                 if k.startswith("model.visual.")}
    if visual_sd:  # FT checkpoint (clip_cls_ft.py:313-321)
        if "visual.attnpool.c_proj.weight" in visual_sd:
            raise ValueError(
                "FT checkpoints with ResNet towers are not supported: the "
                "reference only fine-tunes ViT towers (every configs/ftclip "
                "config uses ViT-L/14)")
        visual_sd, lora = _split_lora(visual_sd)
        if lora is not None:
            out["lora"] = lora
        out["clip"] = {"visual": convert_vit_visual(visual_sd)}
    known = {"text_feats", "adapter.dummy"}  # dummy: IdentityAdapter's leaf
    leftovers = [
        k for k in sd
        if k not in known and not k.startswith(("adapter.", "model.visual."))
    ]
    if leftovers:
        raise ValueError(
            f"unrecognized checkpoint keys (not a reference EventCLIP "
            f"method checkpoint?): {sorted(leftovers)[:8]}"
        )
    assert out, "checkpoint holds no trainable weights (zero-shot model?)"
    return out


def load_method_checkpoint(path: str) -> Dict[str, Any]:
    """Load + convert a reference ``.pth`` method checkpoint from disk.

    Loads with ``weights_only=True``: method checkpoints are plain tensor
    dicts, and this path is reachable from every ``--weight`` flag — full
    pickle would execute arbitrary code from a third-party file. Set
    ``EVENTCLIP_UNSAFE_TORCH_LOAD=1`` to load a trusted checkpoint whose
    wrapper contains non-tensor objects."""
    unsafe = os.environ.get("EVENTCLIP_UNSAFE_TORCH_LOAD", "") == "1"
    try:
        obj = torch.load(path, map_location="cpu",
                         weights_only=not unsafe)
    except pickle.UnpicklingError as err:
        raise ValueError(
            f"{path} needs full (unsafe) unpickling — reference method "
            "checkpoints are plain tensor dicts; if you trust this file, "
            "re-run with EVENTCLIP_UNSAFE_TORCH_LOAD=1"
        ) from err
    return convert_method_state_dict(_unwrap(obj))


# ---------------------------------------------------------------------------
# Reverse direction: this framework's checkpoint -> reference .pth
# ---------------------------------------------------------------------------


def _export_adapter(tree: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Inverse of _convert_adapter: our stacked adapter pytree -> the
    reference TransformerAdapter's state-dict keys."""
    out = {
        "adapter.in_proj.weight": tree["in_proj"]["w"],
        "adapter.in_proj.bias": tree["in_proj"]["b"],
        "adapter.out_proj.weight": tree["out_proj"]["w"],
        "adapter.out_proj.bias": tree["out_proj"]["b"],
    }
    b = tree["blocks"]
    suffix_of = {
        "self_attn.in_proj_weight": b["attn"]["wqkv"],
        "self_attn.in_proj_bias": b["attn"]["bqkv"],
        "self_attn.out_proj.weight": b["attn"]["wo"],
        "self_attn.out_proj.bias": b["attn"]["bo"],
        "linear1.weight": b["mlp"]["w1"], "linear1.bias": b["mlp"]["b1"],
        "linear2.weight": b["mlp"]["w2"], "linear2.bias": b["mlp"]["b2"],
        "norm1.weight": b["ln_1"]["scale"], "norm1.bias": b["ln_1"]["bias"],
        "norm2.weight": b["ln_2"]["scale"], "norm2.bias": b["ln_2"]["bias"],
    }
    for suffix, stacked in suffix_of.items():
        for i, layer in enumerate(np.asarray(stacked)):
            out[f"adapter.transformer_encoder.layers.{i}.{suffix}"] = layer
    return out


def _export_vit_visual(visual: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Our visual pytree -> CLIP's torch key space (inverse of
    convert_vit_visual)."""
    pe = np.asarray(visual["patch_embed"])
    width = pe.shape[0]
    ps = int(round((pe.shape[1] / 3) ** 0.5))
    assert 3 * ps * ps == pe.shape[1], f"bad patch_embed shape {pe.shape}"
    out = {
        "visual.conv1.weight": pe.reshape(width, 3, ps, ps),
        "visual.class_embedding": np.asarray(visual["class_embedding"]),
        "visual.positional_embedding": np.asarray(
            visual["positional_embedding"]),
        "visual.ln_pre.weight": np.asarray(visual["ln_pre"]["scale"]),
        "visual.ln_pre.bias": np.asarray(visual["ln_pre"]["bias"]),
        "visual.ln_post.weight": np.asarray(visual["ln_post"]["scale"]),
        "visual.ln_post.bias": np.asarray(visual["ln_post"]["bias"]),
        "visual.proj": np.asarray(visual["proj"]),
    }
    blocks = visual["blocks"]
    wqkv = np.asarray(blocks["attn"]["wqkv"])  # [L, 3, D, D]
    L, _, D, _ = wqkv.shape
    for i in range(L):
        pre = f"visual.transformer.resblocks.{i}"
        out[f"{pre}.attn.in_proj_weight"] = wqkv[i].reshape(3 * D, D)
        out[f"{pre}.attn.in_proj_bias"] = np.asarray(
            blocks["attn"]["bqkv"])[i].reshape(3 * D)
        out[f"{pre}.attn.out_proj.weight"] = np.asarray(blocks["attn"]["wo"])[i]
        out[f"{pre}.attn.out_proj.bias"] = np.asarray(blocks["attn"]["bo"])[i]
        out[f"{pre}.mlp.c_fc.weight"] = np.asarray(blocks["mlp"]["w1"])[i]
        out[f"{pre}.mlp.c_fc.bias"] = np.asarray(blocks["mlp"]["b1"])[i]
        out[f"{pre}.mlp.c_proj.weight"] = np.asarray(blocks["mlp"]["w2"])[i]
        out[f"{pre}.mlp.c_proj.bias"] = np.asarray(blocks["mlp"]["b2"])[i]
        for ln, name in (("ln_1", "ln_1"), ("ln_2", "ln_2")):
            out[f"{pre}.{name}.weight"] = np.asarray(blocks[ln]["scale"])[i]
            out[f"{pre}.{name}.bias"] = np.asarray(blocks[ln]["bias"])[i]
    return out


def export_method_state_dict(
    tree: Mapping[str, Any],
    clip_visual: Mapping[str, Any] = None,
) -> Dict[str, np.ndarray]:
    """This framework's checkpoint pytree -> the reference's .pth key space
    (the exact state dict ``load_state_dict(strict=True)`` expects after
    the reference's CLIP re-injection, clip_cls.py:214-219).

    FT checkpoints: the reference saves the WHOLE ``model.visual.*`` tower
    while this framework saves only trainable leaves — so LoRA/partial-FT
    exports need ``clip_visual`` (the converted base tower, e.g.
    ``load_checkpoint('clip_vitl14.npz')[0]``-style tree's 'visual') to
    fill the frozen weights. A full-FT checkpoint is self-contained.
    LoRA deltas are re-emitted under the injected-module naming
    (models/lora.py:104-148) so the reference's LoRA-built model loads
    them strict."""
    tree = dict(tree)
    out: Dict[str, np.ndarray] = {}
    if "text_feats" in tree:
        out["text_feats"] = np.asarray(tree["text_feats"])
    if "adapter" in tree:
        out.update(_export_adapter(tree["adapter"]))
    lora = tree.get("lora")
    visual = tree.get("clip", {}).get("visual")
    if lora is not None or visual is not None:
        merged = (jax_free_merge(clip_visual, visual)
                  if clip_visual is not None else (visual or {}))
        try:
            vsd = _export_vit_visual(merged)
        except (KeyError, TypeError):
            raise ValueError(
                "this checkpoint holds only the trainable leaves (LoRA "
                "deltas / a partial tower) while the reference saves the "
                "whole model.visual.*; pass the base CLIP tower "
                "(clip_visual=... / the CLI's third argument) to fill the "
                "frozen weights"
            ) from None
        vsd = dict(vsd)
        if lora is not None:
            L = np.asarray(lora[next(iter(lora))]["a"]).shape[0]
            for i in range(L):
                base = f"visual.transformer.resblocks.{i}.attn"
                vsd[f"{base}.in_proj_weight.merged_proj"] = vsd.pop(
                    f"{base}.in_proj_weight")
                for t in LORA_SLOTS:
                    if t in lora:
                        vsd[f"{base}.in_proj_weight.lora_down_{t}"] = (
                            np.asarray(lora[t]["a"])[i])
                        vsd[f"{base}.in_proj_weight.lora_up_{t}"] = (
                            np.asarray(lora[t]["b"])[i])
                if "o" in lora:
                    vsd[f"{base}.out_proj.linear.weight"] = vsd.pop(
                        f"{base}.out_proj.weight")
                    vsd[f"{base}.out_proj.linear.bias"] = vsd.pop(
                        f"{base}.out_proj.bias")
                    vsd[f"{base}.out_proj.lora_down.weight"] = (
                        np.asarray(lora["o"]["a"])[i])
                    vsd[f"{base}.out_proj.lora_up.weight"] = (
                        np.asarray(lora["o"]["b"])[i])
        out.update({f"model.{k}": v for k, v in vsd.items()})
    assert out, "nothing to export (zero-shot model?)"
    if "adapter" not in tree:
        # FS 'text-identity' prompt tuning and every FTCLIP config
        # instantiate the IdentityAdapter, whose registered dummy leaf is
        # in the reference's expected state dict (models/adapter.py:34-50)
        # — strict load fails without it
        out["adapter.dummy"] = np.zeros(1, np.float32)
    return out


def jax_free_merge(base: Mapping[str, Any], overlay) -> Dict[str, Any]:
    """Overlay non-None leaves of ``overlay`` onto ``base`` (plain dicts)."""
    if overlay is None:
        return dict(base)
    merged = {}
    for k, v in base.items():
        o = overlay.get(k) if isinstance(overlay, Mapping) else None
        if isinstance(v, Mapping):
            merged[k] = jax_free_merge(v, o)
        else:
            merged[k] = v if o is None else o
    return merged


def unflatten(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """'/'-joined path keys (the npz checkpoint format) -> nested dicts."""
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_method_checkpoint(path: str, tree: Mapping[str, Any],
                           clip_visual: Mapping[str, Any] = None) -> None:
    """Export + torch.save under the nerv trainer's wrapper key."""
    sd = {k: torch.tensor(np.ascontiguousarray(v))
          for k, v in export_method_state_dict(tree, clip_visual).items()}
    torch.save({"state_dict": sd}, path)
