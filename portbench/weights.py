"""Weights and class features made on the device from `--seed`.

One `torch.randn` call on the card fills every leaf of the image tower
(OpenAI's names, the layout the reference reads); each leaf is then
scaled and shifted in place by its kind's (mean, std) from the
configuration's `init` table, and where the entry has a third element
`{"every": k, "scale": s}`, every k-th channel of its last axis is
multiplied by s (outlier channels, as trained towers have). The same tensors go to the reference, and
a copy of them, in the port's layout, to the program.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def _kind(name: str) -> str:
    """The `init` entry of a leaf: its name without the block prefix."""
    if name.startswith("transformer.resblocks."):
        return name.split(".", 3)[3]
    return name


def vit_leaves(v: Dict[str, int]) -> List[Tuple[str, Tuple[int, ...]]]:
    """(OpenAI name, shape) of every image-tower leaf, in a fixed order."""
    D, ps, L = v["width"], v["patch_size"], v["layers"]
    S = (v["image_size"] // ps) ** 2 + 1
    out = [("conv1.weight", (D, 3, ps, ps)), ("class_embedding", (D,)),
           ("positional_embedding", (S, D)), ("ln_pre.weight", (D,)),
           ("ln_pre.bias", (D,))]
    for i in range(L):
        p = f"transformer.resblocks.{i}."
        out += [(p + "ln_1.weight", (D,)), (p + "ln_1.bias", (D,)),
                (p + "attn.in_proj_weight", (3 * D, D)),
                (p + "attn.in_proj_bias", (3 * D,)),
                (p + "attn.out_proj.weight", (D, D)),
                (p + "attn.out_proj.bias", (D,)),
                (p + "ln_2.weight", (D,)), (p + "ln_2.bias", (D,)),
                (p + "mlp.c_fc.weight", (v["mlp_width"], D)),
                (p + "mlp.c_fc.bias", (v["mlp_width"],)),
                (p + "mlp.c_proj.weight", (D, v["mlp_width"])),
                (p + "mlp.c_proj.bias", (D,))]
    out += [("ln_post.weight", (D,)), ("ln_post.bias", (D,)),
            ("proj", (D, v["output_dim"]))]
    return out


@torch.no_grad()
def make_weights(config: Dict, seed: int, device) -> Tuple[
        Dict[str, torch.Tensor], torch.Tensor]:
    """-> ({OpenAI name: f32 tensor}, [n_classes, embed] unit text
    features), all on `device`, all from `seed`."""
    v = config["vision"]
    leaves = vit_leaves(v)
    sizes = [int(torch.Size(s).numel()) for _, s in leaves]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (name, shape), n in zip(leaves, sizes):
        mean, std, *outlier = config["init"][_kind(name)]
        out[name] = flat[at:at + n].view(shape).mul_(std).add_(mean)
        if outlier:
            out[name][..., ::outlier[0]["every"]] *= outlier[0]["scale"]
        at += n
    text = torch.randn((config["n_classes"], v["output_dim"]),
                       generator=gen, device=device)
    text /= torch.linalg.vector_norm(text, dim=-1, keepdim=True)
    return out, text


@torch.no_grad()
def port_clip(weights: Dict[str, torch.Tensor], clip_cfg, device):
    """The port's `CLIP` module holding a copy of `weights` in its own
    layout (text tower zeroed: the class features are given)."""
    from eventclip_tpu_torch.models.clip.model import CLIP

    clip = CLIP(clip_cfg, device="meta").to_empty(device=device)
    for p in clip.text.parameters():
        p.zero_()
    clip.logit_scale.zero_()
    vis = clip.visual
    D = clip_cfg.vision.width
    vis.patch_embed.copy_(weights["conv1.weight"].reshape(D, -1))
    for mine, theirs in (("class_embedding", "class_embedding"),
                         ("positional_embedding", "positional_embedding"),
                         ("proj", "proj")):
        getattr(vis, mine).copy_(weights[theirs])
    for ln in ("ln_pre", "ln_post"):
        getattr(vis, ln).weight.copy_(weights[ln + ".weight"])
        getattr(vis, ln).bias.copy_(weights[ln + ".bias"])
    for i, blk in enumerate(vis.blocks.layers):
        p = f"transformer.resblocks.{i}."
        for ln in ("ln_1", "ln_2"):
            getattr(blk, ln).weight.copy_(weights[p + ln + ".weight"])
            getattr(blk, ln).bias.copy_(weights[p + ln + ".bias"])
        blk.attn.wqkv.copy_(weights[p + "attn.in_proj_weight"])
        blk.attn.bqkv.copy_(weights[p + "attn.in_proj_bias"])
        blk.attn.wo.copy_(weights[p + "attn.out_proj.weight"])
        blk.attn.bo.copy_(weights[p + "attn.out_proj.bias"])
        blk.mlp.w1.copy_(weights[p + "mlp.c_fc.weight"])
        blk.mlp.b1.copy_(weights[p + "mlp.c_fc.bias"])
        blk.mlp.w2.copy_(weights[p + "mlp.c_proj.weight"])
        blk.mlp.b2.copy_(weights[p + "mlp.c_proj.bias"])
    return clip
