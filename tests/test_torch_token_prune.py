"""The port's eval-time ViT token pruning (encode_image keep_tokens) vs the
JAX package's.

The same tower (JAX-initialised, crossed as numpy) and the same images
through both. K = grid² must be the full forward (rtol 1e-5, atol 1e-6,
as tests/test_token_prune.py holds the JAX package); a pruned forward is
held to the JAX pruned forward in f32 at the towers' parity tolerance
(rtol 2e-4, atol 2e-5, tests/test_torch_clip.py), which needs the same
kept patches. Event frames are mostly uniform background, so the cut
usually falls among equal scores: there the lowest index must win, as in
`jax.lax.top_k` (`torch.topk` leaves the order of ties unspecified).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventclip_tpu.models import classifier as ref_cls
from eventclip_tpu.models.clip import model as ref_model
from eventclip_tpu.models.clip.config import clip_arch_config as ref_arch
from eventclip_tpu_torch.models import classifier
from eventclip_tpu_torch.models.clip import model
from eventclip_tpu_torch.models.clip.config import clip_arch_config
from eventclip_tpu_torch.models.clip.convert import clip_from_jax

ARCH = "ViT-T/8@32"  # 32 / 8: a 4 x 4 grid of 16 patches


@pytest.fixture(scope="module")
def tiny():
    cfg = ref_arch(ARCH)
    tree = jax.tree_util.tree_map(
        np.asarray, ref_model.init_clip_params(jax.random.PRNGKey(4), cfg))
    return cfg, tree, clip_from_jax(tree, clip_arch_config(ARCH), "cpu")


def _sparse_frames(seed, n, n_marked, bg=0.7):
    """Uniform background with `n_marked` random patches scribbled in."""
    rng = np.random.default_rng(seed)
    imgs = np.full((n, 3, 32, 32), bg, np.float32)
    for b in range(n):
        for k in rng.permutation(16)[:n_marked]:
            i, j = divmod(int(k), 4)
            imgs[b, :, i * 8:(i + 1) * 8, j * 8:(j + 1) * 8] = rng.normal(
                size=(3, 8, 8))
    return imgs


def _both(tiny, imgs, keep, dtype=(jnp.float32, torch.float32)):
    cfg, tree, clip = tiny
    want = np.asarray(ref_model.encode_image(
        jax.tree_util.tree_map(jnp.asarray, tree["visual"]), cfg.vision,
        jnp.asarray(imgs), dtype=dtype[0], keep_tokens=keep))
    with torch.no_grad():
        got = model.encode_image(clip.visual, torch.from_numpy(imgs),
                                 dtype=dtype[1], keep_tokens=keep).numpy()
    return got, want


def test_keep_all_tokens_is_exact(tiny):
    _, _, clip = tiny
    imgs = torch.from_numpy(np.random.default_rng(0).normal(
        size=(3, 3, 32, 32)).astype(np.float32))
    with torch.no_grad():
        full = model.encode_image(clip.visual, imgs)
        kept = model.encode_image(clip.visual, imgs, keep_tokens=16)
    torch.testing.assert_close(kept, full, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_marked,keep", [(6, 8), (5, 8), (12, 8)],
                         ids=["ties-at-cut", "ties-5-of-8", "no-ties"])
def test_pruned_encode_matches_jax(tiny, n_marked, keep):
    """6 or 5 marked patches kept with 2-3 background patches chosen among
    the zero-variance ties (lowest index first), and a cut among distinct
    scores."""
    got, want = _both(tiny, _sparse_frames(n_marked, 4, n_marked), keep)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_pruned_encode_matches_jax_bf16(tiny):
    """bf16 tower: the score is the variance of the bf16-rounded patches,
    in f32 (held at the towers' bf16 limit, 1.5% of the feature norm)."""
    got, want = _both(tiny, _sparse_frames(7, 4, 6), 8,
                      (jnp.bfloat16, torch.bfloat16))
    rel = np.linalg.norm(got - want, axis=-1) / np.linalg.norm(want, axis=-1)
    assert rel.max() <= 1.5e-2, rel


def test_ties_keep_the_lowest_indices_like_top_k():
    """Scores zero except at patches 5, 100 and 200: the kept set is those
    three and then 0, 1, 2, 3, 4 (JAX top_k's order), in raster order."""
    x = torch.zeros(1, 257, 12)
    for k in (5, 100, 200):
        x[0, k, ::2] = float(k)
    got = model.prune_patches(x, 8)[0].tolist()
    score = jnp.asarray(x.numpy()).astype(jnp.float32).var(axis=-1)
    want = sorted(np.asarray(jax.lax.top_k(score, 8)[1][0]).tolist())
    assert got == want == [0, 1, 2, 3, 4, 5, 100, 200]


def test_pruning_selects_every_marked_patch(tiny):
    imgs = _sparse_frames(2, 1, 4, bg=0.0)
    x = torch.from_numpy(imgs).reshape(1, 3, 4, 8, 4, 8).permute(
        0, 2, 4, 1, 3, 5).reshape(1, 16, 192)
    kept = set(model.prune_patches(x, 8)[0].tolist())
    marked = {k for k in range(16) if x[0, k].abs().sum() > 0}
    assert len(marked) == 4 and marked <= kept


def test_classifier_prunes_only_at_eval(tiny):
    """keep_tokens leaves the training forward alone, in both packages, and
    the pruned eval forward equals the JAX one."""
    cfg, tree, clip = tiny
    rng = np.random.default_rng(3)
    tf = rng.normal(size=(4, cfg.embed_dim)).astype(np.float32)
    tf /= np.linalg.norm(tf, axis=-1, keepdims=True)
    imgs = rng.normal(size=(2, 2, 3, 32, 32)).astype(np.float32)
    valid = np.ones((2, 2), bool)
    base = classifier.ClassifierConfig(model="ZSCLIP",
                                       clip=clip_arch_config(ARCH))
    pruned = dataclasses.replace(base, keep_tokens=8)
    params = classifier.ClassifierParams(clip, torch.from_numpy(tf))
    args = (torch.from_numpy(imgs), torch.from_numpy(valid))
    with torch.no_grad():
        train_base = classifier.classifier_forward(params, base, *args,
                                                   train=True)["probs"]
        train_pruned = classifier.classifier_forward(params, pruned, *args,
                                                     train=True)["probs"]
        eval_pruned = classifier.classifier_forward(params, pruned,
                                                    *args)["probs"]
    assert torch.equal(train_base, train_pruned)
    assert not torch.allclose(eval_pruned, train_base)
    ref_cfg = ref_cls.ClassifierConfig(model="ZSCLIP", clip=cfg,
                                       dtype=jnp.float32, keep_tokens=8)
    want = ref_cls.classifier_forward(
        {"clip": jax.tree_util.tree_map(jnp.asarray, tree),
         "text_feats": jnp.asarray(tf)}, ref_cfg, jnp.asarray(imgs),
        jnp.asarray(valid))["probs"]
    np.testing.assert_allclose(eval_pruned.numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-5)
