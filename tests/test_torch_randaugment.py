"""The port's RandAugment vs the JAX package's (eventclip_tpu/ops/randaugment.py).

The same frames (integer values 0..255 as f32, about 32 x 40) and the same
draws go through both: op indices and magnitudes from the JAX package's
`_sample_ops` (or picked by hand), never a matched seed. Frames are held to
the JAX suite's own frame rule (tests/test_rasterize.py:93-97): equal for
identity, posterize, solarize, autocontrast and equalize (integer
arithmetic on both sides); at most one quantum at a mismatch rate under
5e-3 for the geometric ops, brightness, color, contrast and sharpness,
where a float sum's order or an ulp of cos / atan can flip a .5 rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eventclip_tpu.ops.rasterize as RZ
from eventclip_tpu.ops import randaugment as R
from eventclip_tpu.ops.preprocess import ClipPreprocess as RefPreprocess
from eventclip_tpu_torch.ops import randaugment as P
from eventclip_tpu_torch.ops.preprocess import ClipPreprocess
from eventclip_tpu_torch.ops.rasterize import (RasterSpec,
                                               rasterize_augment_for_clip)

H, W = 32, 40
EXACT = {"Identity", "Posterize", "Solarize", "AutoContrast", "Equalize"}
# one program for every op (the switch's index traced), compiled once
JAX_ONE_OP = jax.jit(R._apply_one_op, static_argnums=(3,))


def event_frames(rng, shape, channels_equal=False):
    """Event-frame-like content: white background, dark and grey blobs,
    scattered single pixels; [..., C, H, W] f32 on the 0..255 grid."""
    *lead, C, h, w = shape
    out = np.full(shape, 255.0, np.float32)
    flat = out.reshape(-1, C, h, w)
    for img in flat:
        for _ in range(8):
            y, x = rng.integers(0, h - 6), rng.integers(0, w - 8)
            img[:, y:y + rng.integers(2, 7), x:x + rng.integers(2, 9)] = (
                rng.integers(0, 230, (1 if channels_equal else C, 1, 1)))
        n = h * w // 20
        ys, xs = rng.integers(0, h, n), rng.integers(0, w, n)
        img[:, ys, xs] = rng.integers(0, 256, (1 if channels_equal else C, n))
    return out


def assert_frames(got, want, exact, label=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, label
    np.testing.assert_array_equal(got, np.round(got), err_msg=label)
    if exact:
        np.testing.assert_array_equal(got, want, err_msg=label)
        return
    diff = np.abs(got - want)
    assert diff.max() <= 1.0, (label, diff.max())
    assert (diff > 0).mean() < 5e-3, (label, (diff > 0).mean())


def _mags(op):
    table = np.asarray(R.magnitude_table(H, W))
    mags = [table[op, b] for b in (3, 17, 29)]
    if R.SIGNED[op]:
        mags += [-m for m in mags]
    return mags


@pytest.mark.parametrize("op", range(14), ids=R.OP_NAMES)
def test_each_op_matches_jax(op):
    rng = np.random.default_rng(op)
    img = event_frames(rng, (3, H, W))
    name = R.OP_NAMES[op]
    for fill in (255.0, 0.0):
        for mag in _mags(op):
            want = JAX_ONE_OP(jnp.asarray(img), jnp.int32(op),
                              jnp.float32(mag), fill)
            got = P.apply_one_op(torch.from_numpy(img), op, mag, fill)
            assert_frames(got.numpy(), want, name in EXACT,
                          f"{name} mag {mag} fill {fill}")


@pytest.mark.parametrize("channels", [1, 3])
def test_batched_ops_match_jax_on_its_draws(channels):
    rng = np.random.default_rng(channels)
    B, T = 8, 2
    frames = event_frames(rng, (B, T, channels, H, W))
    seen = set()
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        op_idx, mag = R._sample_ops(key, B, 2, H, W)
        seen.update(np.asarray(op_idx).ravel().tolist())
        want = R.randaugment(jnp.asarray(frames), key, 2, 255.0)
        got = P.apply_ops(torch.from_numpy(frames),
                          torch.from_numpy(np.array(op_idx)),
                          torch.from_numpy(np.array(mag)), 255.0)
        assert_frames(got.numpy(), want, False, f"key {seed}")
    assert len(seen) >= 12  # the draws reach nearly every op


def test_views_of_a_sample_get_the_same_ops():
    rng = np.random.default_rng(0)
    B, T = 6, 3
    one = event_frames(rng, (B, 1, 3, H, W))
    frames = torch.from_numpy(np.repeat(one, T, axis=1))
    out = P.randaugment(frames, torch.Generator().manual_seed(3))
    assert out.shape == frames.shape
    for b in range(B):
        for t in range(1, T):
            torch.testing.assert_close(out[b, t], out[b, 0], rtol=0, atol=0)
    assert any(not torch.equal(out[0, 0], out[b, 0]) for b in range(1, B))
    assert out.min() >= 0 and out.max() <= 255
    torch.testing.assert_close(out, torch.round(out), rtol=0, atol=0)


@pytest.mark.parametrize("fill", [255.0, 0.0])
def test_one_channel_equals_three_channels(fill):
    """Grayscale frames are augmented on one channel and broadcast
    (ops/rasterize.py); on equal channels that is the 3-channel result, bit
    for bit, for every op (the 0.9999-weighted grayscale included)."""
    rng = np.random.default_rng(7)
    one = torch.from_numpy(event_frames(rng, (14, 2, 1, H, W)))
    three = one.expand(14, 2, 3, H, W).contiguous()
    ops = torch.tensor([[k, (k + 5) % 14] for k in range(14)])
    table = P.magnitude_table(H, W)
    mag = table[ops, (torch.arange(14) * 2 % 30)[:, None]]
    mag = torch.where(torch.arange(14)[:, None] % 2 == 0, mag, -mag)
    got1 = P.apply_ops(one, ops, mag, fill)
    got3 = P.apply_ops(three, ops, mag, fill)
    torch.testing.assert_close(got1.expand(got3.shape), got3, rtol=0, atol=0)


@pytest.mark.parametrize("hw", [(32, 40), (180, 240), (480, 640), (7, 5)])
def test_magnitude_table_is_exact(hw):
    np.testing.assert_array_equal(P.magnitude_table(*hw).numpy(),
                                  np.asarray(R.magnitude_table(*hw)))
    assert P.OP_NAMES == R.OP_NAMES
    assert P.SIGNED == tuple(bool(s) for s in R.SIGNED)


def test_sampler_draw_shapes_and_ranges():
    B, n_ops = 4000, 2
    op_idx, mag = P.sample_ops(torch.Generator().manual_seed(0), B, n_ops,
                               H, W)
    assert op_idx.shape == mag.shape == (B, n_ops)
    assert op_idx.dtype == torch.int64 and mag.dtype == torch.float32
    assert int(op_idx.min()) == 0 and int(op_idx.max()) == 13
    table = P.magnitude_table(H, W)
    signed = torch.tensor(P.SIGNED)[op_idx]
    # one magnitude bin per sample, shared by its ops: some bin gives
    # every op's |magnitude|
    for b in range(200):
        fits = [table[o] == abs(m) for o, m in zip(op_idx[b].tolist(),
                                                 mag[b].tolist())]
        assert torch.stack(fits).all(0).any(), b
    assert (mag[~signed] >= 0).all()
    neg = (mag < 0)[signed & (mag != 0)].float().mean()
    assert 0.45 < float(neg) < 0.55  # signed ops flip with p = 0.5


@pytest.mark.parametrize("grayscale,background", [(True, True),
                                                  (False, False)])
def test_rasterize_augment_for_clip_matches_jax(grayscale, background):
    """Rasterize, augment on JAX's draws, preprocess. CLIP inputs inherit
    the frame rule through the resize and normalization: at most one
    quantum (1/255/0.2613), with >= 99% of elements within 1e-5."""
    rng = np.random.default_rng(int(grayscale))
    B, T, N = 4, 2, 600
    wins = np.stack([rng.integers(0, W, (B, T, N)),
                     rng.integers(0, H, (B, T, N)),
                     rng.choice([-1, 1], (B, T, N))], -1).astype(np.int16)
    kw = dict(height=H, width=W, window=N, grayscale=grayscale,
              background_mask=background)
    key = jax.random.PRNGKey(11)
    op_idx, mag = R._sample_ops(key, B, 2, H, W)
    want = np.asarray(RZ.rasterize_augment_for_clip(
        RZ.RasterSpec(**kw), RefPreprocess(H, W, 32), jnp.asarray(wins), key))
    got = rasterize_augment_for_clip(
        RasterSpec(**kw), ClipPreprocess(H, W, 32), torch.from_numpy(wins),
        torch.from_numpy(np.array(op_idx)),
        torch.from_numpy(np.array(mag))).numpy()
    assert got.shape == want.shape == (B, T, 3, 32, 32)
    diff = np.abs(got - want)
    assert diff.max() <= 1 / 255 / 0.2613 + 1e-6, diff.max()
    assert (diff <= 1e-5).mean() >= 0.99, (diff <= 1e-5).mean()
