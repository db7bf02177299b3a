"""CLIP architecture configurations.

Copy of eventclip_tpu/models/clip/config.py (shape hyper-parameters of
OpenAI's released CLIP checkpoints), with its own copy of the ResNet config
dataclass so the table needs no JAX (the towers: models/clip/resnet.py).

`EVA_ARCHS` adds the port's own EVA02-CLIP towers (EVA-CLIP,
github.com/baaivision/EVA, `EVA02-CLIP-L-14-336.json` and
`EVA02-CLIP-L-14.json`; the tower: models/clip/eva.py), which the JAX
package does not have; `CLIP_ARCHS` stays the JAX package's table, and
`clip_arch_config` finds a name in either.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Tuple


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    image_size: int
    patch_size: int
    width: int
    layers: int
    heads: int
    output_dim: int

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def seq_len(self) -> int:
        return self.grid * self.grid + 1


@dataclasses.dataclass(frozen=True)
class ResNetVisionConfig:
    image_size: int
    layers: Tuple[int, int, int, int]
    width: int  # stem width (stage widths are width * 2^i, expansion 4)
    heads: int  # attention-pool heads
    output_dim: int

    @property
    def stage_widths(self) -> Tuple[int, ...]:
        return tuple(self.width * (2 ** i) for i in range(4))

    @property
    def embed_dim(self) -> int:
        return self.width * 32  # final channels = width * 8 * expansion(4)

    @property
    def grid(self) -> int:
        return self.image_size // 32


@dataclasses.dataclass(frozen=True)
class EVAVisionConfig:
    """An EVA02 image tower (EVA-CLIP's `eva_vit_model.py`): pre-norm
    blocks with 2-D rotary q/k, a layer norm on the heads' output
    (`inner_attn_ln`), a SwiGLU MLP of `mlp_hidden` with a layer norm on
    its hidden (`ffn_ln`), q and v biases only, a patch embedding with
    bias, no `ln_pre`, a final norm and a `head` with bias."""

    image_size: int
    patch_size: int
    width: int
    layers: int
    heads: int
    output_dim: int
    mlp_hidden: int  # int(width * 2.6667), as EVA-CLIP computes it
    rope_theta: float = 10000.0
    pt_hw_seq_len: int = 16  # the grid the rotary positions are scaled to
    eps: float = 1e-6

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def seq_len(self) -> int:
        return self.grid * self.grid + 1

    @property
    def mlp_stored(self) -> int:
        """The hidden width as stored: `mlp_hidden` rounded up to a
        multiple of 8 (16-byte bf16 rows, which D1's TMA needs), the pad
        rows of W1 / W2 and columns of W3 zero."""
        return -(-self.mlp_hidden // 8) * 8


@dataclasses.dataclass(frozen=True)
class TextConfig:
    vocab_size: int = 49408
    context_length: int = 77
    width: int = 512
    layers: int = 12
    heads: int = 8
    output_dim: int = 512
    # the MLP's activation: OpenAI's "quick_gelu", or exact "gelu"
    act: ClassVar[str] = "quick_gelu"


@dataclasses.dataclass(frozen=True)
class EVATextConfig(TextConfig):
    """EVA-CLIP's text tower: OpenAI's shape with exact GELU."""

    act: ClassVar[str] = "gelu"


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    name: str
    vision: VisionConfig
    text: TextConfig
    # debug towers (tiny shapes, no released OpenAI weights) may run with
    # random init without the explicit smoke escape hatch
    debug: bool = False

    @property
    def embed_dim(self) -> int:
        return self.vision.output_dim


def _vit(name, image, patch, width, layers, heads, embed, t_width, t_heads,
         t_layers=12, vocab=49408, context=77):
    return CLIPConfig(
        name=name,
        vision=VisionConfig(
            image_size=image,
            patch_size=patch,
            width=width,
            layers=layers,
            heads=heads,
            output_dim=embed,
        ),
        text=TextConfig(
            vocab_size=vocab, context_length=context,
            width=t_width, heads=t_heads, layers=t_layers, output_dim=embed,
        ),
    )


def _rn(name, image, layers, width, embed, t_width, t_heads):
    return CLIPConfig(
        name=name,
        vision=ResNetVisionConfig(
            image_size=image, layers=layers, width=width,
            heads=width * 32 // 64, output_dim=embed,
        ),
        text=TextConfig(width=t_width, heads=t_heads, layers=12,
                        output_dim=embed),
    )


CLIP_ARCHS = {
    "ViT-B/32": _vit("ViT-B/32", 224, 32, 768, 12, 12, 512, 512, 8),
    "ViT-B/16": _vit("ViT-B/16", 224, 16, 768, 12, 12, 512, 512, 8),
    "ViT-L/14": _vit("ViT-L/14", 224, 14, 1024, 24, 16, 768, 768, 12),
    "ViT-L/14@336px": _vit("ViT-L/14@336px", 336, 14, 1024, 24, 16, 768, 768, 12),
    # tiny debug tower (smoke tests / CI; not an OpenAI release)
    "ViT-T/8@32": dataclasses.replace(
        _vit("ViT-T/8@32", 32, 8, 64, 2, 2, 32, 32, 2, t_layers=2),
        debug=True,
    ),
}

_RESNET_SPECS = {
    # name: (image, layers, stem width, output_dim, text width, text heads)
    "RN50": (224, (3, 4, 6, 3), 64, 1024, 512, 8),
    "RN101": (224, (3, 4, 23, 3), 64, 512, 512, 8),
    "RN50x4": (288, (4, 6, 10, 6), 80, 640, 640, 10),
    "RN50x16": (384, (6, 8, 18, 8), 96, 768, 768, 12),
    "RN50x64": (448, (3, 15, 36, 10), 128, 1024, 1024, 16),
    # tiny debug ResNet (smoke tests; not an OpenAI release)
    "RN-T@32": (32, (1, 1, 1, 1), 8, 32, 32, 2),
}

for _name, (_img, _layers, _w, _embed, _tw, _th) in _RESNET_SPECS.items():
    CLIP_ARCHS[_name] = _rn(_name, _img, _layers, _w, _embed, _tw, _th)
# shrink the debug ResNet's text tower too
CLIP_ARCHS["RN-T@32"] = dataclasses.replace(
    CLIP_ARCHS["RN-T@32"],
    text=TextConfig(vocab_size=128, context_length=16, width=32,
                    heads=2, layers=2, output_dim=32),
    debug=True,
)


def _eva(name, image, patch, width, layers, heads, embed, mlp, t_width,
         t_heads, t_layers=12, pt=16, debug=False):
    return CLIPConfig(
        name=name,
        vision=EVAVisionConfig(
            image_size=image, patch_size=patch, width=width, layers=layers,
            heads=heads, output_dim=embed, mlp_hidden=mlp, pt_hw_seq_len=pt),
        text=EVATextConfig(width=t_width, heads=t_heads, layers=t_layers,
                           output_dim=embed),
        debug=debug,
    )


EVA_ARCHS = {
    "EVA02-CLIP-L-14-336": _eva("EVA02-CLIP-L-14-336", 336, 14, 1024, 24,
                                16, 768, int(1024 * 2.6667), 768, 12),
    "EVA02-CLIP-L-14": _eva("EVA02-CLIP-L-14", 224, 14, 1024, 24, 16, 768,
                            int(1024 * 2.6667), 768, 12),
    # tiny debug siblings (tests; not releases): a hidden of 170, not a
    # multiple of 8, and a grid of 6 rotated at 4 positions (the 336 px
    # tower's interpolation) or of 4 at 4 (the 224 px tower's)
    "EVA02-T/8@48": _eva("EVA02-T/8@48", 48, 8, 64, 2, 2, 32,
                         int(64 * 2.6667), 32, 2, t_layers=2, pt=4,
                         debug=True),
    "EVA02-T/8@32": _eva("EVA02-T/8@32", 32, 8, 64, 2, 2, 32,
                         int(64 * 2.6667), 32, 2, t_layers=2, pt=4,
                         debug=True),
}


def clip_arch_config(arch: str) -> CLIPConfig:
    cfg = CLIP_ARCHS.get(arch) or EVA_ARCHS.get(arch)
    if cfg is None:
        raise KeyError(
            f"Unknown CLIP arch {arch!r}; available: "
            f"{sorted(CLIP_ARCHS) + sorted(EVA_ARCHS)}"
        )
    return cfg
