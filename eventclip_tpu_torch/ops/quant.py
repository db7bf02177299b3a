"""W8A8 int8 inference quantization for the CLIP ViT tower.

Port of eventclip_tpu/ops/quant.py, same scheme:
- weights: static per-output-channel symmetric int8, scale = max|row| / 127,
  quantized once at load time (`quantize_visual`);
- activations, default: dynamic per-token symmetric int8, scale computed
  from each token's max-abs right before the product (`qdense`);
- activations, opt-in: static per-(layer, site) scales from a calibration
  pass (`calibrate_visual_amax`), out-of-range values clipped;
- the product runs int8 x int8 -> int32 (`torch._int_mm`, cuBLASLt on the
  card); the int32 sum is rescaled in f32 by (token scale x channel scale)
  and the f32 bias added, then rounded once to the activation dtype, the
  same accumulate-then-cast shape as the float `dense`.

The product is a library call, as in the JAX package (XLA's
`dot_general`): no hand-written kernel stands behind it. `torch._int_mm`
takes on the card only M > 16 rows and K, N multiples of 8, so `_int_mm`
zero-pads the operands (exact: zero rows and columns add nothing) and
slices the result; ViT-L/14's `patch_embed` has K = 3 * 14 * 14 = 588.

LayerNorm, softmax, the attention core (K2), residuals and the output
projection stay float. This is an inference path only (`torch.round` has
no useful gradient); training never sees a quantized tower.

A quantized weight is a `QWeight` module (`q` int8 [out, in], `s` f32
[out], optional `a` f32 scalar), put in place of the float Parameter;
models.clip.model.dense dispatches on it, so a quantized tower runs
through the unchanged forward.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# each block's quantized sites, in calibrate_visual_amax's column order
SITES = (("attn", "wqkv"), ("attn", "wo"), ("mlp", "w1"), ("mlp", "w2"))


def _over_127(t: torch.Tensor) -> torch.Tensor:
    """t / 127 as a true division on every device: a Python-scalar divisor
    becomes a multiply by its rounded reciprocal on CUDA, one ulp off the
    CPU's (and the JAX package's) quotient at times, which moves codes."""
    return t / t.new_full((), 127.0)


class QWeight(nn.Module):
    """An int8 weight: codes `q` [out, in], per-channel scales `s` [out]
    and, in static mode, the activation scale `a` (a 0-d f32)."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor,
                 a: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("s", s)
        self.register_buffer("a", a)


class AmaxRecorder(nn.Module):
    """A float weight that notes the max |x| of the input it last
    multiplied (a 0-d f32 `amax`); model.dense takes the float product
    through it. A calibration copy of the tower holds one at each
    quantized site."""

    def __init__(self, w: torch.Tensor):
        super().__init__()
        self.w = w
        self.amax: Optional[torch.Tensor] = None

    def see(self, x: torch.Tensor) -> torch.Tensor:
        self.amax = x.abs().amax().float()
        return self.w


def _require_vit(visual: nn.Module) -> None:
    if not (hasattr(visual, "blocks") and hasattr(visual, "patch_embed")):
        raise ValueError(
            "int8 quantization supports the ViT towers only "
            "(ResNet archs run bf16)"
        )
    # the sites are those of OpenAI's block, under `blocks.layers`
    if not hasattr(visual.blocks, "layers"):
        raise ValueError("int8 quantization supports OpenAI's ViT block "
                         f"only, not {type(visual).__name__}'s")


def quantize_weight(w: torch.Tensor) -> QWeight:
    """Symmetric per-output-channel int8: w is [..., out, in] (torch layout).
    `torch.round` is half-to-even, like `jnp.round`."""
    w = w.detach().float()
    s = torch.clamp(_over_127(w.abs().amax(-1)), min=1e-12)
    q = torch.round(w / s[..., None]).to(torch.int8)
    return QWeight(q, s)


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] @ int8 [K, N] -> int32 [M, N] through `torch._int_mm`,
    with M padded past 16 and K, N padded to multiples of 8 (the card's
    rules; the CPU takes any shape, and the padding is exact on both).
    `b` is the transposed row-major weight, the layout cuBLASLt's int8
    product takes."""
    M, K = a.shape
    N = b.shape[1]
    pk, pn, pm = -K % 8, -N % 8, max(17 - M, 0)
    if pk or pm:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = F.pad(b.t(), (0, pk, 0, pn)).t()
    y = torch._int_mm(a, b)
    return y[:M, :N] if (pm or pn) else y


def qdense(x: torch.Tensor, qw: QWeight,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantized counterpart of model.dense: x @ w.T + b.

    x [..., in] float; the product runs int8 x int8 with int32 sums.
    Activation scale: dynamic per-token max-abs by default; with the
    calibrated scalar `a` (static mode), x quantizes against it with
    clipping (no reduce over x before the product)."""
    xf = x.float()
    if qw.a is not None:
        ax = qw.a.float()
        xq = torch.clamp(torch.round(xf / ax), -127.0, 127.0).to(torch.int8)
    else:
        ax = torch.clamp(_over_127(xf.abs().amax(-1, keepdim=True)),
                         min=1e-12)
        xq = torch.round(xf / ax).to(torch.int8)
    lead = x.shape[:-1]
    y = _int_mm(xq.reshape(-1, x.shape[-1]), qw.q.t())
    y = y.reshape(*lead, qw.q.shape[0])
    yf = y.float() * ax * qw.s.float()
    if b is not None:
        yf = yf + b.float()
    return yf.to(x.dtype)


def _shared_copy(module: nn.Module) -> nn.Module:
    """A copy of the module tree that shares every parameter and buffer
    with the original (only the modules are new), so replacing a leaf in
    the copy leaves the original as it was."""
    memo = {id(t): t for t in (*module.parameters(), *module.buffers())}
    return copy.deepcopy(module, memo)


def _put(module: nn.Module, name: str, value: nn.Module) -> None:
    """Put `value` in place of the Parameter or module `name` (a module
    refuses a module assigned over a Parameter of the same name)."""
    delattr(module, name)
    setattr(module, name, value)


def quantize_visual(visual: nn.Module,
                    act_amax: Optional[torch.Tensor] = None) -> nn.Module:
    """Quantize a ViT visual tower's matmul weights (per channel): a copy
    of the tower with patch_embed and every block's attn.wqkv / attn.wo /
    mlp.w1 / mlp.w2 as QWeights, every other leaf shared with the float
    tower (embeddings, layer norms and the output projection stay float).
    Idempotent on an already-quantized tower.

    act_amax: optional [layers, 4] calibration maxima (from
    `calibrate_visual_amax`) — attaches static per-(layer, site)
    activation scales a = amax / 127 to wqkv/wo/w1/w2. patch_embed keeps
    the dynamic scale: its input is raw pixel patches."""
    out = _shared_copy(visual)
    if not isinstance(out.patch_embed, QWeight):
        _put(out, "patch_embed", quantize_weight(out.patch_embed))
    if act_amax is not None:
        scales = torch.clamp(_over_127(torch.as_tensor(
            act_amax, dtype=torch.float32, device=out.patch_embed.q.device)),
            min=1e-12)
    for i, block in enumerate(out.blocks.layers):
        for j, (group, key) in enumerate(SITES):
            sub = getattr(block, group)
            w = getattr(sub, key)
            if not isinstance(w, QWeight):
                w = quantize_weight(w)
            if act_amax is not None:
                w = QWeight(w.q, w.s, scales[i, j])
            _put(sub, key, w)
    return out


@torch.no_grad()
def calibrate_visual_amax(visual: nn.Module, images: torch.Tensor, *,
                          dtype=torch.bfloat16) -> torch.Tensor:
    """Run the FLOAT ViT forward over calibration images, return [L, 4]
    per-(layer, site) activation max-abs for static int8 scales, in SITES
    order: the inputs of wqkv (ln_1 out), wo (attention out), w1 (ln_2
    out) and w2 (gelu out).

    images: [N, 3, H, W] CLIP-preprocessed (call repeatedly and take the
    elementwise max to calibrate over more batches). The tower must be
    unquantized: the maxima are the float activations the static scales
    stand in for. It runs as a copy with an AmaxRecorder at each site."""
    from ..models.clip.model import encode_image

    _require_vit(visual)
    assert not isinstance(visual.patch_embed, QWeight), (
        "calibrate on the FLOAT tower (before quantize_visual)"
    )
    probe = _shared_copy(visual)
    sites = []
    for block in probe.blocks.layers:
        for group, key in SITES:
            sub = getattr(block, group)
            sites.append(AmaxRecorder(getattr(sub, key)))
            _put(sub, key, sites[-1])
    encode_image(probe, images, dtype=dtype)
    return torch.stack([r.amax for r in sites]).reshape(-1, len(SITES))


def quantize_classifier_params(model_params: nn.Module,
                               act_amax: Optional[torch.Tensor] = None
                               ) -> nn.Module:
    """Quantize the visual tower inside a ClassifierParams: a copy sharing
    every other leaf (the text tower, text features, adapter, LoRA).

    Call AFTER checkpoint loading (fine-tuned visual weights must be the
    ones quantized). ViT towers only. act_amax: optional calibration maxima
    for static activation scales (see quantize_visual)."""
    visual = model_params.clip.visual
    _require_vit(visual)
    out = _shared_copy(model_params)
    out.clip.visual = quantize_visual(visual, act_amax=act_amax)
    return out
