"""The port's rasterizer vs the JAX package's and the numpy oracle.

Histograms are exact. uint8 frames are held to the JAX suite's own bound
(tests/test_rasterize.py): at most one quantum, at a mismatch rate under
5e-3 (x/peak may be evaluated as x*rcp(peak), flipping values that land on
a .5 rounding boundary). CLIP inputs inherit that bound through the
normalization: at most 1/255/0.2613 ~ 0.015, with >= 99.9% of elements
within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eventclip_tpu.ops.rasterize as RZ
from eventclip_tpu.data.host_ops import gather_event_windows
from eventclip_tpu.ops.numpy_ref import events_to_frames_np
from eventclip_tpu.ops.preprocess import ClipPreprocess as RefPreprocess
from eventclip_tpu_torch.ops import numpy_ref
from eventclip_tpu_torch.ops.preprocess import ClipPreprocess
from eventclip_tpu_torch.ops.rasterize import (
    SMEM_LIMIT,
    RasterSpec,
    histogram_plan,
    histograms,
    histograms_plain,
    rasterize_for_clip,
    rasterize_windows,
)

GEOMETRIES = [(180, 240), (100, 120), (480, 640)]  # N-Caltech, N-Cars, N-IN
# 242 plane rows over 16 CTAs of 16 rows: the last CTA holds 2
RAGGED = (121, 1000)


def synth_events(rng, n, H, W, hot_pixels=0):
    ev = np.stack([
        rng.integers(0, W, n), rng.integers(0, H, n),
        np.sort(rng.uniform(0, 0.3, n)), rng.choice([-1.0, 1.0], n),
    ], axis=1).astype(np.float32)
    for _ in range(hot_pixels):  # a few hot pixels trigger their removal
        idx = rng.integers(0, n, size=int(0.05 * n))
        ev[idx, 0], ev[idx, 1] = rng.integers(0, W), rng.integers(0, H)
    return ev


def edge_windows(rng, M, N, H, W):
    """[M, N, 3] int16 windows with out-of-bounds coordinates (negative and
    past the edge, as centred packed events can be) and p == 0 padding."""
    x = rng.integers(-30, W + 30, (M, N))
    y = rng.integers(-30, H + 30, (M, N))
    p = rng.integers(-1, 2, (M, N))
    return np.stack([x, y, p], -1).astype(np.int16)


def oracle_histograms(wins, H, W):
    out = []
    for w in wins.astype(np.int64):
        keep = (w[:, 0] >= 0) & (w[:, 0] < W) & (w[:, 1] >= 0) & (w[:, 1] < H)
        h = numpy_ref.polarity_histogram(w[keep, 0], w[keep, 1],
                                         w[keep, -1], (H, W))
        out.append(np.moveaxis(h, -1, 0))
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("H,W", GEOMETRIES + [RAGGED])
def test_histogram_plain_equals_pallas_kernel_and_oracle(H, W, monkeypatch):
    rng = np.random.default_rng(H)
    wins = edge_windows(rng, 3, 300, H, W)
    # events chunked 128 at a time: the kernel accumulates over K = 3 steps
    monkeypatch.setattr(RZ, "_EVENT_CHUNK", 128)
    spec = RZ.RasterSpec(height=H, width=W, window=300)
    for layout in ("packed", "f32"):
        w = wins if layout == "packed" else np.concatenate(
            [wins[..., :2], np.zeros_like(wins[..., :1]), wins[..., 2:]],
            -1).astype(np.float32)
        got = histograms(torch.from_numpy(w), H, W).numpy()
        want = np.asarray(RZ._pallas_histograms(spec, jnp.asarray(w),
                                                interpret=True))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, oracle_histograms(wins, H, W))
    assert got.dtype == np.float32 and got.shape == (3, 2, H, W)


@pytest.mark.parametrize("H,W", GEOMETRIES + [(720, 1280), RAGGED])
def test_histogram_plan_covers_every_row_once(H, W):
    """The CUDA kernel's plan: every row of the [2H, W] plane in exactly one
    CTA, each CTA within a block's shared memory, clusters of at most 16
    CTAs; 720x1280 needs row bands, and RAGGED's rows do not divide evenly
    over its CTAs."""
    plan = histogram_plan(H, W)
    ranges = plan.row_ranges(H)
    rows = [r for first, end in ranges for r in range(first, end)]
    assert rows == list(range(2 * H))
    assert len(ranges) == plan.cluster * plan.bands
    assert plan.cluster in (1, 2, 4, 8, 16) and plan.bands >= 1
    assert plan.smem_bytes(W) <= SMEM_LIMIT == 232448
    assert plan.rows * W * 4 <= plan.smem_bytes(W)
    # the last band starts inside the plane: no band is wholly empty
    assert (plan.bands - 1) * plan.cluster * plan.rows < 2 * H
    if (H, W) == (720, 1280):
        assert plan.bands > 1
    if (H, W) == RAGGED:
        assert len({end - first for first, end in ranges}) > 1


def test_histogram_plan_follows_the_card_limit():
    # a smaller block limit gives smaller CTAs, never a row split
    big, small = histogram_plan(480, 640), histogram_plan(480, 640, 100_000)
    assert small.smem_bytes(640) <= 100_000 and small.rows < big.rows
    assert small.cluster * small.bands * small.rows >= 960
    with pytest.raises(ValueError):
        histogram_plan(8, 70_000)  # one row beyond a block's memory


def test_histogram_plain_counts_repeats_exactly():
    """Many events on one pixel of each polarity; f32 coordinates truncate
    toward zero like the JAX package's int cast."""
    w = np.zeros((2, 50, 4), np.float32)
    w[0, :30] = (5.7, 3.2, 0.0, 1.0)
    w[0, 30:] = (5.0, 3.9, 0.0, -1.0)
    w[1, :10] = (-0.5, 0.0, 0.0, 1.0)  # truncates to x = 0: counted
    got = histograms_plain(torch.from_numpy(w), 8, 8).numpy()
    assert got[0, 0, 3, 5] == 30 and got[0, 1, 3, 5] == 20
    assert got[1, 0, 0, 0] == 10 and got.sum() == 60
    spec = RZ.RasterSpec(height=8, width=8, window=50)
    np.testing.assert_array_equal(
        got, np.asarray(RZ._pallas_histograms(spec, jnp.asarray(w),
                                              interpret=True)))


def _frames_close(got, want):
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, f"max diff {diff.max()}"
    assert (diff != 0).mean() < 5e-3, f"mismatch rate {(diff != 0).mean()}"


@pytest.mark.parametrize("H,W", GEOMETRIES)
@pytest.mark.parametrize("grayscale,count_non_zero",
                         [(True, False), (True, True), (False, False),
                          (False, True)])
def test_uint8_frames_match_jax_and_oracle(H, W, grayscale, count_non_zero):
    rng = np.random.default_rng(W + int(grayscale) + 2 * int(count_non_zero))
    # enough events per window that hot-pixel removal (mean + 10 std over
    # the whole frame) keeps the single-count pixels; an all-zero frame is
    # 0/0 in the oracle
    N = 8000 if H * W > 100_000 else 1000
    ev = synth_events(rng, 3 * N + 700, H, W, hot_pixels=3)
    wins, _ = gather_event_windows(ev, N, 4, rng=None, packed=False)
    wins = wins[:4]
    kw = dict(thresh=10.0, count_non_zero=count_non_zero,
              background_mask=True, grayscale=grayscale)
    got = rasterize_windows(RasterSpec(height=H, width=W, window=N, **kw),
                            torch.from_numpy(wins)).numpy()
    want = np.asarray(RZ.rasterize_windows(
        RZ.RasterSpec(height=H, width=W, window=N, **kw), jnp.asarray(wins)))
    assert got.shape == want.shape and got.dtype == np.uint8
    _frames_close(got, want)
    oracle = events_to_frames_np(ev, N, (H, W), count_non_zero=count_non_zero,
                                 grayscale=grayscale)
    n_real = len(oracle)
    _frames_close(got[:n_real], oracle)


def test_packed_and_float_windows_give_the_same_frames(rng):
    ev = synth_events(rng, 2500, 180, 240)
    spec = RasterSpec(height=180, width=240, window=1000)
    f32, _ = gather_event_windows(ev, 1000, 3, packed=False)
    packed, _ = gather_event_windows(ev, 1000, 3, packed=True)
    np.testing.assert_array_equal(
        rasterize_windows(spec, torch.from_numpy(f32)).numpy(),
        rasterize_windows(spec, torch.from_numpy(packed)).numpy())


@pytest.mark.parametrize("image_size", [32, 224])
def test_rasterize_for_clip_matches_jax(image_size):
    rng = np.random.default_rng(image_size)
    H, W, N = 180, 240, 1000
    ev = synth_events(rng, 3 * N, H, W, hot_pixels=2)
    wins, _ = gather_event_windows(ev, N, 4, packed=True)
    got = rasterize_for_clip(
        RasterSpec(height=H, width=W, window=N),
        ClipPreprocess(H, W, image_size),
        torch.from_numpy(wins[None])).numpy()
    want = np.asarray(RZ.rasterize_for_clip(
        RZ.RasterSpec(height=H, width=W, window=N),
        RefPreprocess(H, W, image_size), jnp.asarray(wins[None])))
    assert got.shape == want.shape == (1, 4, 3, image_size, image_size)
    diff = np.abs(got - want)
    assert diff.max() <= 1 / 255 / 0.2613 + 1e-6, diff.max()
    assert (diff <= 1e-5).mean() >= 0.999, (diff <= 1e-5).mean()


def test_histogram_wrapper_checks_its_input():
    with pytest.raises(ValueError):
        histograms(torch.zeros((4, 10), dtype=torch.int16), 8, 8)
    with pytest.raises(TypeError):
        histograms(torch.zeros((1, 4, 3), dtype=torch.int32), 8, 8)
    with pytest.raises(ValueError):
        histograms(torch.zeros((1, 3, 4), dtype=torch.int16).transpose(1, 2),
                   8, 8)


def test_empty_window_is_a_white_frame_like_jax():
    """A window with no live event (all padding) has peak 0: the device
    rasterizers divide by 1 and composite to white, where the numpy oracle
    divides 0/0 (NaN, then an undefined uint8 cast)."""
    wins = np.zeros((2, 64, 3), np.int16)
    wins[1, :10] = (3, 4, 1)
    spec = dict(height=6, width=8, window=64)
    got = rasterize_windows(RasterSpec(**spec), torch.from_numpy(wins)).numpy()
    want = np.asarray(RZ.rasterize_windows(RZ.RasterSpec(**spec),
                                           jnp.asarray(wins)))
    np.testing.assert_array_equal(got, want)
    assert (got[0] == 255).all()
