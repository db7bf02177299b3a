"""Weight bridge between the JAX package's parameter trees and the port's.

The JAX trees (eventclip_tpu/models/clip/model.py::init_clip_params, a
converted checkpoint, or a whole classifier tree {'clip', 'text_feats',
'adapter', 'lora'}) already hold weights in torch [out, in] order; their
transformer blocks are stacked along a leading layer axis. The port keeps
one block module per layer, the CLIP towers' fused in-projection `wqkv`
[L, 3, D, D] as [3D, D] per layer (the reshape the JAX forward does),
`bqkv` as [3D], and names layer-norm `scale` `weight`. The FS adapter's
`wqkv` is already [L, 3d, d] in the JAX tree, so only the towers' leaves
are reshaped. LoRA deltas stay stacked ([L, r, D] / [L, D, r]) on both
sides.

`jax_path` is the one name map, from a port parameter name to its JAX
'/'-joined tree path (and layer): partitioning, the optimizer's groups and
checkpoints all decide on and store under the JAX paths, so each package
reads the other's trainable checkpoints.

ResNet towers (models/clip/resnet.py) use the same map: their folded
batch norms name `scale` `weight` too, convolutions are bare leaves, and
the blocks after a stage's first, stacked under the JAX package's `rest`,
unstack into `rest.layers.<i>` as transformer blocks do under `blocks`.

Released OpenAI checkpoints (a torch state dict, or the .pt archives)
convert to the JAX package's tree as numpy first (`convert_clip_state_dict`,
`load_clip_checkpoint`: a copy of eventclip_tpu/models/clip/convert.py,
ViT and ResNet branches, every leaf cast to float32, batch norms folded by
the same numpy operations), and `clip_from_jax` builds the port's towers
from that tree.

EVA-CLIP's image towers (models/clip/eva.py) have no JAX tree: their
`visual.*` state dict (EVA's `eva_vit_model.py` names) maps straight onto
the port's layout (`eva_visual_state_dict`, `load_eva_visual_`).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

from .config import (CLIPConfig, EVAVisionConfig, ResNetVisionConfig,
                     TextConfig, VisionConfig)
from .model import CLIP


def jax_path(name: str) -> Tuple[str, Optional[int]]:
    """Port parameter name -> (JAX tree path, layer index or None), e.g.
    'clip.visual.blocks.layers.3.ln_1.weight' ->
    ('clip/visual/blocks/ln_1/scale', 3)."""
    parts = name.split(".")
    layer = None
    if "layers" in parts:
        i = parts.index("layers")
        layer = int(parts[i + 1])
        del parts[i:i + 2]
    if parts[-1] == "weight":  # only layer norms and folded BNs have one
        parts[-1] = "scale"
    return "/".join(parts), layer


def flatten_tree(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested dict -> {'/'-joined path: leaf}, None leaves dropped."""
    flat = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(flatten_tree(v, path + "/"))
        elif v is not None:
            flat[path] = v
    return flat


def _fused_qkv(path: str) -> bool:
    """A CLIP tower's fused in-projection (stored [3, D(, D)] a layer in
    JAX), in a classifier tree (`clip/...`) or a bare CLIP tree."""
    return (path.startswith(("clip/", "visual/", "text/"))
            and path.endswith(("/wqkv", "/bqkv")))


def port_leaves(path: str, value) -> Iterable[Tuple[str, np.ndarray]]:
    """One JAX leaf -> (port name, port-shaped array) pairs: stacked block
    leaves unstack into one name per layer."""
    value = np.asarray(value)
    parts = path.split("/")
    if parts[-1] == "scale":
        parts[-1] = "weight"
    stacked = [p for p in ("blocks", "rest") if p in parts]
    if not stacked:
        yield ".".join(parts), value
        return
    i = parts.index(stacked[0]) + 1
    for layer in range(value.shape[0]):
        leaf = value[layer]
        if _fused_qkv(path):  # [3, D(, D)] -> [3D(, D)]
            leaf = leaf.reshape((-1,) + leaf.shape[2:])
        yield ".".join(parts[:i] + ["layers", str(layer)] + parts[i:]), leaf


def from_jax_params(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX tree (numpy leaves) -> a float32 state dict for the port: a CLIP
    tree ({'visual', 'text', 'logit_scale'}) for `CLIP.load_state_dict`, or
    a classifier tree ({'clip', 'text_feats', 'adapter', 'lora'}) for
    `models.classifier.ClassifierParams`."""
    return {name: torch.from_numpy(np.array(leaf, dtype=np.float32))
            for path, value in flatten_tree(tree).items()
            for name, leaf in port_leaves(path, value)}


def jax_shapes(named: Iterable[Tuple[str, torch.Tensor]]
               ) -> Dict[str, Tuple[int, ...]]:
    """(port name, tensor) pairs -> {JAX path: the leaf's JAX shape}, as
    `to_jax_flat` would give them (reads shapes only: meta tensors do)."""
    shapes: Dict[str, Tuple[int, ...]] = {}
    layers: Dict[str, Tuple[int, Tuple[int, ...]]] = {}
    for name, t in named:
        path, layer = jax_path(name)
        shape = tuple(t.shape)
        if layer is None:
            shapes[path] = shape
            continue
        if _fused_qkv(path):
            shape = (3, shape[0] // 3) + shape[1:]
        layers[path] = (layers.get(path, (0, shape))[0] + 1, shape)
    shapes.update({p: (n,) + s for p, (n, s) in layers.items()})
    return shapes


def to_jax_flat(named: Iterable[Tuple[str, torch.Tensor]]
                ) -> Dict[str, np.ndarray]:
    """(port name, tensor) pairs -> {JAX path: numpy leaf in the JAX
    shape}: per-layer tensors stacked along a leading layer axis, the
    towers' `wqkv` / `bqkv` split back into their [3, D(, D)] form."""
    layers: Dict[str, Dict[int, np.ndarray]] = {}
    flat: Dict[str, np.ndarray] = {}
    for name, t in named:
        path, layer = jax_path(name)
        a = t.detach().float().cpu().numpy()
        if layer is None:
            flat[path] = a
        else:
            if _fused_qkv(path):
                a = a.reshape((3, -1) + a.shape[1:])
            layers.setdefault(path, {})[layer] = a
    for path, by_layer in layers.items():
        flat[path] = np.stack([by_layer[i] for i in range(len(by_layer))])
    return flat


@torch.no_grad()
def clip_from_jax(tree: Dict[str, Any], cfg: CLIPConfig,
                  device="cuda") -> CLIP:
    """Build the port's CLIP towers on `device` from a JAX parameter tree."""
    model = CLIP(cfg, device="meta")
    model = model.to_empty(device=device)
    model.load_state_dict(from_jax_params(tree), strict=True)
    return model


# ---------------------------------------------------------------------------
# released OpenAI checkpoints -> the JAX package's tree, as numpy
# ---------------------------------------------------------------------------


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, dtype=np.float32)


def _n_layers(sd: Mapping[str, Any], prefix: str, at: int) -> int:
    return 1 + max(int(k.split(".")[at]) for k in sd if k.startswith(prefix))


def _text_config(sd: Mapping[str, Any], output_dim: int) -> TextConfig:
    t_width = _np(sd["ln_final.weight"]).shape[0]
    vocab, _ = _np(sd["token_embedding.weight"]).shape
    return TextConfig(
        vocab_size=vocab, context_length=_np(sd["positional_embedding"])
        .shape[0], width=t_width,
        layers=_n_layers(sd, "transformer.resblocks.", 2),
        heads=max(t_width // 64, 1), output_dim=output_dim)


def infer_config_from_state_dict(sd: Mapping[str, Any]) -> CLIPConfig:
    """Recover a checkpoint's architecture from its shapes."""
    if "visual.attnpool.c_proj.weight" in sd:
        return _infer_resnet_config(sd)
    conv1 = _np(sd["visual.conv1.weight"])
    width, _, patch, _ = conv1.shape
    seq_len = _np(sd["visual.positional_embedding"]).shape[0]
    grid = int(round((seq_len - 1) ** 0.5))
    image_size = grid * patch
    output_dim = _np(sd["visual.proj"]).shape[1]
    return CLIPConfig(
        name=f"ViT-{width}/{patch}@{image_size}",
        vision=VisionConfig(
            image_size=image_size, patch_size=patch, width=width,
            layers=_n_layers(sd, "visual.transformer.resblocks.", 3),
            heads=max(width // 64, 1), output_dim=output_dim),
        text=_text_config(sd, output_dim),
    )


def _infer_resnet_config(sd: Mapping[str, Any]) -> CLIPConfig:
    """A ModifiedResNet checkpoint's architecture. The pool's heads are
    width * 32 // 64 and the name `RN-w<width>`, as the JAX package infers
    them (the arch table's own heads may differ: RN50x64 has 64)."""
    width = _np(sd["visual.conv3.weight"]).shape[0]  # stem output width
    layers = tuple(_n_layers(sd, f"visual.layer{s}.", 2)
                   for s in range(1, 5))
    output_dim = _np(sd["visual.attnpool.c_proj.weight"]).shape[0]
    n_tokens = _np(sd["visual.attnpool.positional_embedding"]).shape[0]
    grid = int(round((n_tokens - 1) ** 0.5))
    return CLIPConfig(
        name=f"RN-w{width}",
        vision=ResNetVisionConfig(
            image_size=grid * 32, layers=layers, width=width,
            heads=width * 32 // 64, output_dim=output_dim),
        text=_text_config(sd, output_dim),
    )


def _stack_blocks(sd: Mapping[str, Any], prefix: str,
                  layers: int) -> Dict[str, Any]:
    def gather(suffix):
        return np.stack([_np(sd[f"{prefix}.{i}.{suffix}"])
                         for i in range(layers)])

    wqkv = gather("attn.in_proj_weight")  # [L, 3D, D]
    bqkv = gather("attn.in_proj_bias")  # [L, 3D]
    L, _, D = wqkv.shape
    return {
        "ln_1": {"scale": gather("ln_1.weight"), "bias": gather("ln_1.bias")},
        "ln_2": {"scale": gather("ln_2.weight"), "bias": gather("ln_2.bias")},
        "attn": {
            "wqkv": wqkv.reshape(L, 3, D, D),
            "bqkv": bqkv.reshape(L, 3, D),
            "wo": gather("attn.out_proj.weight"),
            "bo": gather("attn.out_proj.bias"),
        },
        "mlp": {
            "w1": gather("mlp.c_fc.weight"),
            "b1": gather("mlp.c_fc.bias"),
            "w2": gather("mlp.c_proj.weight"),
            "b2": gather("mlp.c_proj.bias"),
        },
    }


def convert_vit_visual(sd: Mapping[str, Any],
                       layers: Optional[int] = None) -> Dict[str, Any]:
    """ViT visual-tower keys (`visual.*`) -> the JAX visual tree (also
    used by convert_method: FT checkpoints carry `model.visual.*` only)."""
    if layers is None:
        layers = 1 + max(int(k.split(".")[3]) for k in sd
                         if k.startswith("visual.transformer.resblocks."))
    conv1 = _np(sd["visual.conv1.weight"])
    return {
        "patch_embed": conv1.reshape(conv1.shape[0], -1),
        "class_embedding": _np(sd["visual.class_embedding"]),
        "positional_embedding": _np(sd["visual.positional_embedding"]),
        "ln_pre": {"scale": _np(sd["visual.ln_pre.weight"]),
                   "bias": _np(sd["visual.ln_pre.bias"])},
        "ln_post": {"scale": _np(sd["visual.ln_post.weight"]),
                    "bias": _np(sd["visual.ln_post.bias"])},
        "proj": _np(sd["visual.proj"]),
        "blocks": _stack_blocks(sd, "visual.transformer.resblocks", layers),
    }


def _fold_bn(sd: Mapping[str, Any], prefix: str,
             eps: float = 1e-5) -> Dict[str, np.ndarray]:
    """Frozen batch-norm statistics -> an affine scale / bias, by the JAX
    package's f32 numpy operations (so the leaves are bit-equal)."""
    gamma = _np(sd[f"{prefix}.weight"])
    beta = _np(sd[f"{prefix}.bias"])
    mean = _np(sd[f"{prefix}.running_mean"])
    var = _np(sd[f"{prefix}.running_var"])
    scale = gamma / np.sqrt(var + eps)
    return {"scale": scale, "bias": beta - mean * scale}


def _convert_resnet_visual(sd: Mapping[str, Any],
                           cfg: ResNetVisionConfig) -> Dict[str, Any]:
    """ModifiedResNet keys (`visual.*`) -> the JAX visual tree: folded
    batch norms, each stage's blocks after the first stacked as `rest`."""
    def conv_bn(pre, names):
        out = {}
        for i in names:
            out[f"conv{i}"] = _np(sd[f"{pre}.conv{i}.weight"])
            out[f"bn{i}"] = _fold_bn(sd, f"{pre}.bn{i}")
        return out

    def block(pre):
        p = conv_bn(pre, (1, 2, 3))
        # CLIP's downsample = Sequential(avgpool '-1', conv '0', bn '1')
        if f"{pre}.downsample.0.weight" in sd:
            p["downsample"] = {
                "conv": _np(sd[f"{pre}.downsample.0.weight"]),
                "bn": _fold_bn(sd, f"{pre}.downsample.1")}
        return p

    def stack(trees):
        return {k: stack([t[k] for t in trees]) if isinstance(v, dict)
                else np.stack([t[k] for t in trees])
                for k, v in trees[0].items()}

    visual: Dict[str, Any] = {"stem": conv_bn("visual", (1, 2, 3))}
    for s, n in enumerate(cfg.layers, start=1):
        pre = f"visual.layer{s}"
        rest = (stack([block(f"{pre}.{i}") for i in range(1, n)])
                if n > 1 else None)
        visual[f"layer{s}"] = {"block0": block(f"{pre}.0"), "rest": rest}

    def lin(name):
        return {"w": _np(sd[f"visual.attnpool.{name}.weight"]),
                "b": _np(sd[f"visual.attnpool.{name}.bias"])}

    visual["attnpool"] = {
        "positional_embedding": _np(
            sd["visual.attnpool.positional_embedding"]),
        **{name: lin(name) for name in ("q_proj", "k_proj", "v_proj",
                                        "c_proj")},
    }
    return visual


def convert_clip_state_dict(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """OpenAI state dict -> {'visual', 'text', 'logit_scale'} (the JAX
    package's tree, float32 numpy leaves)."""
    cfg = infer_config_from_state_dict(sd)
    text = {
        "token_embedding": _np(sd["token_embedding.weight"]),
        "positional_embedding": _np(sd["positional_embedding"]),
        "ln_final": {"scale": _np(sd["ln_final.weight"]),
                     "bias": _np(sd["ln_final.bias"])},
        "projection": _np(sd["text_projection"]),
        "blocks": _stack_blocks(sd, "transformer.resblocks", cfg.text.layers),
    }
    visual = (_convert_resnet_visual(sd, cfg.vision)
              if isinstance(cfg.vision, ResNetVisionConfig)
              else convert_vit_visual(sd, cfg.vision.layers))
    return {
        "visual": visual,
        "text": text,
        "logit_scale": _np(sd["logit_scale"]).reshape(()),
    }


def load_clip_checkpoint(path: str):
    """An OpenAI CLIP .pt (jit archive or plain state dict) -> (the JAX
    tree as numpy, the inferred CLIPConfig). Full unpickling, as the JAX
    package does: the released archives are TorchScript."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    return convert_clip_state_dict(obj), infer_config_from_state_dict(obj)


# -- EVA-CLIP image towers -----------------------------------------------------


def eva_visual_state_dict(sd: Mapping[str, Any], cfg: EVAVisionConfig
                          ) -> Dict[str, torch.Tensor]:
    """EVA-CLIP's image tower state dict (`visual.` prefix optional; EVA's
    names: `patch_embed.proj`, `cls_token`, `pos_embed`, per block
    `norm1`, `attn.{q,k,v}_proj.weight`, `attn.q_bias`, `attn.v_bias`,
    `attn.inner_attn_ln`, `attn.proj`, `norm2`, `mlp.w1`, `mlp.w2`,
    `mlp.ffn_ln`, `mlp.w3`; then `norm`, `head`) -> the port's
    `EVAVisionTower` state dict, float32: q/k/v fused with a zero k bias,
    W1 and W2 fused with their hidden padded to `cfg.mlp_stored`, W3's
    columns padded. The rotary buffers (`rope.freqs_*`) are left out: the
    port makes its tables from the config. Any other name raises."""
    sd = {(k[len("visual."):] if k.startswith("visual.") else k): v
          for k, v in sd.items()}
    used = {k for k in sd if "rope.freqs_" in k}

    def get(name):
        used.add(name)
        return torch.as_tensor(sd[name]).float()

    D, H, Hs = cfg.width, cfg.mlp_hidden, cfg.mlp_stored

    def pad_rows(t):
        return torch.cat([t, t.new_zeros((Hs - H,) + t.shape[1:])])

    out = {"patch_embed": get("patch_embed.proj.weight").reshape(D, -1),
           "patch_bias": get("patch_embed.proj.bias"),
           "class_embedding": get("cls_token").reshape(D),
           "positional_embedding": get("pos_embed").reshape(cfg.seq_len, D),
           "norm.weight": get("norm.weight"), "norm.bias": get("norm.bias"),
           "head": get("head.weight"), "head_bias": get("head.bias")}
    for i in range(cfg.layers):
        p = f"blocks.{i}."
        for a, b in (("norm1", "norm1"), ("norm2", "norm2"),
                     ("inner_attn_ln", "attn.inner_attn_ln"),
                     ("ffn_ln", "mlp.ffn_ln")):
            for leaf in ("weight", "bias"):
                out[p + a + "." + leaf] = get(p + b + "." + leaf)
        out[p + "wqkv"] = torch.cat([get(p + f"attn.{t}_proj.weight")
                                     for t in "qkv"])
        qb = get(p + "attn.q_bias")
        out[p + "bqkv"] = torch.cat([qb, torch.zeros_like(qb),
                                     get(p + "attn.v_bias")])
        out[p + "wo"] = get(p + "attn.proj.weight")
        out[p + "bo"] = get(p + "attn.proj.bias")
        out[p + "w12"] = torch.cat([pad_rows(get(p + "mlp.w1.weight")),
                                    pad_rows(get(p + "mlp.w2.weight"))])
        out[p + "b12"] = torch.cat([pad_rows(get(p + "mlp.w1.bias")),
                                    pad_rows(get(p + "mlp.w2.bias"))])
        w3 = get(p + "mlp.w3.weight")
        out[p + "w3"] = torch.cat([w3, w3.new_zeros((D, Hs - H))], dim=1)
        out[p + "b3"] = get(p + "mlp.w3.bias")
    left = sorted(set(sd) - used)
    if left:
        raise KeyError(f"EVA image tower: names the port does not map: "
                       f"{left[:8]}")
    return out


@torch.no_grad()
def load_eva_visual_(visual, sd: Mapping[str, Any]) -> None:
    """Copy an EVA-CLIP image tower state dict into the port's
    `EVAVisionTower` (models/clip/eva.py) in place, every leaf checked."""
    visual.load_state_dict(eva_visual_state_dict(sd, visual.cfg))
