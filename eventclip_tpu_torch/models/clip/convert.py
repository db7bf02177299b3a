"""Weight bridge: the JAX package's CLIP parameter tree -> the port's towers.

The JAX tree (eventclip_tpu/models/clip/model.py::init_clip_params, or a
converted checkpoint) already holds weights in torch [out, in] order; its
transformer blocks are stacked along a leading layer axis. Here each layer
unstacks into its `Block`, `wqkv` [L, 3, D, D] reshapes to the fused
[3D, D] per layer (the same reshape the JAX forward does), `bqkv` to [3D],
and layer-norm `scale`/`bias` become `weight`/`bias`.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .config import CLIPConfig
from .model import CLIP

_TOWER_KEYS = {
    "visual": ("patch_embed", "class_embedding", "positional_embedding",
               "proj"),
    "text": ("token_embedding", "positional_embedding", "projection"),
}
_TOWER_NORMS = {"visual": ("ln_pre", "ln_post"), "text": ("ln_final",)}


def _blocks_state(prefix: str, blocks: Dict[str, Any]) -> Dict[str, np.ndarray]:
    wqkv = np.asarray(blocks["attn"]["wqkv"])  # [L, 3, D, D]
    L, _, D, _ = wqkv.shape
    per_layer = {
        "attn.wqkv": wqkv.reshape(L, 3 * D, D),
        "attn.bqkv": np.asarray(blocks["attn"]["bqkv"]).reshape(L, 3 * D),
        "attn.wo": blocks["attn"]["wo"],
        "attn.bo": blocks["attn"]["bo"],
        **{f"mlp.{k}": blocks["mlp"][k] for k in ("w1", "b1", "w2", "b2")},
        **{f"{ln}.{dst}": blocks[ln][src]
           for ln in ("ln_1", "ln_2")
           for dst, src in (("weight", "scale"), ("bias", "bias"))},
    }
    state = {}
    for name, stacked in per_layer.items():
        stacked = np.asarray(stacked)
        for i in range(L):
            state[f"{prefix}.blocks.layers.{i}.{name}"] = stacked[i]
    return state


def from_jax_params(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX CLIP tree ({'visual', 'text', 'logit_scale'}, numpy leaves) ->
    a float32 state dict for `CLIP.load_state_dict`."""
    state: Dict[str, np.ndarray] = {}
    for tower, keys in _TOWER_KEYS.items():
        sub = tree[tower]
        for k in keys:
            state[f"{tower}.{k}"] = sub[k]
        for ln in _TOWER_NORMS[tower]:
            state[f"{tower}.{ln}.weight"] = sub[ln]["scale"]
            state[f"{tower}.{ln}.bias"] = sub[ln]["bias"]
        state.update(_blocks_state(tower, sub["blocks"]))
    state["logit_scale"] = tree["logit_scale"]
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in state.items()}


@torch.no_grad()
def clip_from_jax(tree: Dict[str, Any], cfg: CLIPConfig,
                  device="cuda") -> CLIP:
    """Build the port's CLIP towers on `device` from a JAX parameter tree."""
    model = CLIP(cfg, device="meta")
    model = model.to_empty(device=device)
    model.load_state_dict(from_jax_params(tree), strict=True)
    return model
