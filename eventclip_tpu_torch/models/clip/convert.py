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
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from .config import CLIPConfig
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
    if parts[-1] == "weight":  # only layer norms have one
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
    if "blocks" not in parts:
        yield ".".join(parts), value
        return
    i = parts.index("blocks") + 1
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
