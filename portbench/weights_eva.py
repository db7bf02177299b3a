"""EVA02 image-tower weights and class features made on the device from
`--seed`, as `weights.py` makes the ViT's.

One `torch.randn` call on the card fills every leaf of the image tower, in
EVA-CLIP's `visual.*` names (without the prefix: the layout
`reference/eva02.py` reads); each leaf is then scaled and shifted in place
by its kind's (mean, std) from the configuration's `init` table (the name
without `blocks.<i>.`). The same tensors go to the reference, and a copy
of them, in the port's layout (`models/clip/convert.py`
`load_eva_visual_`: q/k/v fused, the hidden padded), to the program.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def _kind(name: str) -> str:
    if name.startswith("blocks."):
        return name.split(".", 2)[2]
    return name


def eva_leaves(v: Dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(EVA name, shape) of every image-tower leaf, in a fixed order."""
    D, ps, L, H = v["width"], v["patch_size"], v["layers"], v["mlp_hidden"]
    S = (v["image_size"] // ps) ** 2 + 1
    out = [("patch_embed.proj.weight", (D, 3, ps, ps)),
           ("patch_embed.proj.bias", (D,)), ("cls_token", (1, 1, D)),
           ("pos_embed", (1, S, D))]
    for i in range(L):
        p = f"blocks.{i}."
        out += [(p + "norm1.weight", (D,)), (p + "norm1.bias", (D,)),
                (p + "attn.q_proj.weight", (D, D)),
                (p + "attn.k_proj.weight", (D, D)),
                (p + "attn.v_proj.weight", (D, D)),
                (p + "attn.q_bias", (D,)), (p + "attn.v_bias", (D,)),
                (p + "attn.inner_attn_ln.weight", (D,)),
                (p + "attn.inner_attn_ln.bias", (D,)),
                (p + "attn.proj.weight", (D, D)), (p + "attn.proj.bias", (D,)),
                (p + "norm2.weight", (D,)), (p + "norm2.bias", (D,)),
                (p + "mlp.w1.weight", (H, D)), (p + "mlp.w1.bias", (H,)),
                (p + "mlp.w2.weight", (H, D)), (p + "mlp.w2.bias", (H,)),
                (p + "mlp.ffn_ln.weight", (H,)), (p + "mlp.ffn_ln.bias", (H,)),
                (p + "mlp.w3.weight", (D, H)), (p + "mlp.w3.bias", (D,))]
    out += [("norm.weight", (D,)), ("norm.bias", (D,)),
            ("head.weight", (v["output_dim"], D)),
            ("head.bias", (v["output_dim"],))]
    return out


@torch.no_grad()
def make_weights(config: Dict, seed: int, device) -> Tuple[
        Dict[str, torch.Tensor], torch.Tensor]:
    """-> ({EVA name: f32 tensor}, [n_classes, embed] unit text features),
    all on `device`, all from `seed`."""
    v = config["vision"]
    leaves = eva_leaves(v)
    sizes = [int(torch.Size(s).numel()) for _, s in leaves]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (name, shape), n in zip(leaves, sizes):
        mean, std = config["init"][_kind(name)]
        out[name] = flat[at:at + n].view(shape).mul_(std).add_(mean)
        at += n
    text = torch.randn((config["n_classes"], v["output_dim"]),
                       generator=gen, device=device)
    text /= torch.linalg.vector_norm(text, dim=-1, keepdim=True)
    return out, text


@torch.no_grad()
def port_clip(weights: Dict[str, torch.Tensor], clip_cfg, device):
    """The port's `CLIP` module holding a copy of `weights` in its own
    layout (text tower zeroed: the class features are given)."""
    from eventclip_tpu_torch.models.clip.convert import load_eva_visual_
    from eventclip_tpu_torch.models.clip.model import CLIP

    clip = CLIP(clip_cfg, device="meta").to_empty(device=device)
    for p in clip.text.parameters():
        p.zero_()
    clip.logit_scale.zero_()
    load_eva_visual_(clip.visual, weights)
    return clip
