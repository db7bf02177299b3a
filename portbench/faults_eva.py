"""Faults an EVA02 serving cell can have, planted in the program's tower
(`eventclip_tpu_torch.models.clip.eva`), underneath the timed path.

Each takes `patch(owner, name, value)` (pytest's `monkeypatch.setattr`,
or `faults.Patches`) and replaces one piece of the tower's forward with a
broken copy; a run with one planted has to come out not correct. They are
planted before the tower's first forward (its rotary tables are made
then). `control_eva.py --fault <name>` reads them on the card, the tests
on the CPU.
"""

from __future__ import annotations


def _eva():
    from eventclip_tpu_torch.models.clip import eva

    return eva


def rope_off(patch):
    """The rotary positions left out: q and k as the product gives them."""
    patch(_eva(), "rope_qkv", lambda qkv, cos, sin, heads: None)


def no_interp(patch):
    """Positions not interpolated to the pre-training grid:
    t = arange(g) instead of arange(g) / g * pt_hw_seq_len."""
    from eventclip_tpu_torch.ops import rope

    # pt_seq_len = g scales t = arange(g) / g back to arange(g)
    patch(_eva(), "rope_tables", lambda cfg, device: rope.rope_tables(
        cfg.grid, cfg.width // cfg.heads, cfg.rope_theta, cfg.grid, device))


def _swiglu(gate_on_value: bool, norm: bool):
    import torch.nn.functional as F

    eva = _eva()

    def swiglu(h12, ffn_ln):
        Hs = h12.shape[-1] // 2
        H = ffn_ln.normalized_shape[0]
        a, b = h12[..., :H].float(), h12[..., Hs:Hs + H].float()
        if gate_on_value:
            a, b = b, a
        h = (F.silu(a) * b).to(h12.dtype)
        if norm:
            h = eva.layer_norm(h, ffn_ln)
        return F.pad(h, (0, Hs - H))
    return swiglu


def ffn_ln_off(patch):
    """The MLP's sub-norm `ffn_ln` left out."""
    patch(_eva(), "swiglu", _swiglu(False, False))


def silu_on_value(patch):
    """SiLU applied to the value half (W2's) instead of the gate (W1's)."""
    patch(_eva(), "swiglu", _swiglu(True, True))


def inner_ln_off(patch):
    """The attention's sub-norm `inner_attn_ln` left out."""
    eva = _eva()

    def attention(blk, h, rope):
        qkv = eva.dense(h, blk.wqkv, blk.bqkv)
        eva.rope_qkv(qkv, *rope, blk.heads)
        o = eva.fused_qkv_attention(qkv, blk.heads)
        return eva.dense(o, blk.wo, blk.bo)
    patch(eva, "attention", attention)


FAULTS = {"rope_off": rope_off, "no_interp": no_interp,
          "ffn_ln_off": ffn_ln_off, "inner_ln_off": inner_ln_off,
          "silu_on_value": silu_on_value}
