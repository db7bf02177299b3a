"""The port's FT and FS training vs the JAX package's, on a tiny tower.

The same parameters (drawn by the JAX package, biases, norms and LoRA `b`
filled at random so every leaf carries gradient, crossed through
models/clip/convert.py) and the same numpy batch go through the JAX
`make_train_step` — its attention running the Pallas kernels, backward K3
included, in interpret mode — and through the port's train step (plain
kernels on the CPU). The one-update checks are f32; one check holds the
bf16 step's gradients against jax.grad.

Tolerances. Metrics: rtol 1e-5. Updated parameters: atol 1e-6. Adam's
first update is lr * g / (|g| + 1e-8): about lr * sign(g) wherever the
gradient is above its summation noise, so the two updates agree closely,
but where the gradient is at noise level its sign is noise — the key bias
is the case in point: softmax is shift-invariant in it, so its gradient is
zero up to rounding. Elements whose port gradient is below 1e-5 of their
leaf's largest are held only to |update| <= lr. Frozen leaves: bit-equal.
Since that update hardly sees the gradient's size, each trained leaf's
gradient is also held to jax.grad of the same loss: f32 rtol 1e-4, atol
1e-6 of the leaf's largest; bf16 see `test_ft_grads_bf16_match_jax`.
"""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eventclip_tpu.engine import OptimConfig as RefOptimConfig
from eventclip_tpu.engine import build_optimizer as ref_build_optimizer
from eventclip_tpu.engine import create_train_state
from eventclip_tpu.engine import make_train_step as ref_make_train_step
from eventclip_tpu.engine.optim import optimizer_labels as ref_labels
from eventclip_tpu.engine.schedule import warmup_cosine as ref_warmup_cosine
from eventclip_tpu.models import classifier as ref_cls
from eventclip_tpu.models.clip import config as ref_config
from eventclip_tpu.models.clip import model as ref_model
from eventclip_tpu.models.partition import trainable_mask as ref_mask
from eventclip_tpu.ops.preprocess import ClipPreprocess as RefPP
from eventclip_tpu.ops.rasterize import RasterSpec as RefSpec
from eventclip_tpu.parallel import make_mesh
from eventclip_tpu.utils.config import load_params as ref_load_params
from eventclip_tpu.utils.pytree import path_str
from eventclip_tpu_torch.engine.optim import (OptimConfig, Optimizer,
                                              optimizer_labels)
from eventclip_tpu_torch.engine.schedule import warmup_cosine
from eventclip_tpu_torch.engine import train
from eventclip_tpu_torch.engine.train import make_train_step
from eventclip_tpu_torch.models import classifier
from eventclip_tpu_torch.models.clip import config
from eventclip_tpu_torch.models.clip.convert import (flatten_tree,
                                                     from_jax_params,
                                                     jax_path, to_jax_flat)
from eventclip_tpu_torch.models.partition import trainable_mask
from eventclip_tpu_torch.ops.preprocess import ClipPreprocess
from eventclip_tpu_torch.ops.rasterize import RasterSpec
from eventclip_tpu_torch.utils.config import load_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_CLS = 5
LR, CLIP_LR = 1e-3, 1e-4
TINY = dict(
    vision=dict(image_size=32, patch_size=8, width=64, layers=2, heads=2,
                output_dim=32),
    text=dict(vocab_size=128, context_length=16, width=32, layers=2, heads=2,
              output_dim=32))


def _clip_cfg(mod):
    return mod.CLIPConfig(name="tiny", vision=mod.VisionConfig(**TINY["vision"]),
                          text=mod.TextConfig(**TINY["text"]))


def _cfgs(dtype="float32", **kw):
    kw = {"model": "FTCLIP", **kw}
    return (ref_cls.ClassifierConfig(clip=_clip_cfg(ref_config),
                                     dtype=jnp.dtype(dtype), **kw),
            classifier.ClassifierConfig(clip=_clip_cfg(config),
                                        dtype=getattr(torch, dtype), **kw))


@pytest.fixture
def pallas_attention(monkeypatch):
    """The JAX towers' attention through the Pallas kernels (interpret mode
    on the CPU), forward K2 and backward K3, as on the TPU."""
    monkeypatch.setattr(ref_model, "_use_pallas_attention",
                        lambda *a, **k: True)


def _tree(jcfg, seed=0):
    """JAX classifier params with every bias, norm and LoRA `b` random."""
    tree = jax.tree_util.tree_map(np.asarray, ref_cls.init_classifier_params(
        jax.random.PRNGKey(seed), jcfg, n_classes=N_CLS))
    rng = np.random.default_rng(seed + 100)

    def fill(path, a):
        key = getattr(path[-1], "key", None)
        if key in ("bias", "bqkv", "bo", "b1", "b2"):
            return (0.1 * rng.normal(size=a.shape)).astype(np.float32)
        if key == "scale":
            return (1 + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
        if key == "b" and path_str(path).startswith("lora"):
            return (0.05 * rng.normal(size=a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(fill, tree)


def _port_params(tree, pcfg):
    params = classifier.init_classifier_params(
        pcfg, torch.Generator().manual_seed(0), n_classes=N_CLS)
    params.load_state_dict(from_jax_params(tree), strict=True)
    return params


def _batch(seed=0, B=4, T=2, windows=False):
    rng = np.random.default_rng(seed)
    valid = np.ones((B, T), bool)
    valid[1, 1] = False  # a padded view
    batch = {"valid_mask": valid,
             "label": rng.integers(0, N_CLS, B).astype(np.int32)}
    if windows:
        H, W, N = 48, 64, 128
        batch["windows"] = np.stack([
            rng.integers(0, W, (B, T, N)), rng.integers(0, H, (B, T, N)),
            rng.choice([-1, 1], (B, T, N))], -1).astype(np.int16)
    else:
        batch["img"] = rng.normal(size=(B, T, 3, 32, 32)).astype(np.float32)
    return batch


def _pipelines():
    H, W, N = 48, 64, 128
    return ((RefSpec(height=H, width=W, window=N),
             RefPP(in_height=H, in_width=W, image_size=32)),
            (RasterSpec(height=H, width=W, window=N),
             ClipPreprocess(in_height=H, in_width=W, image_size=32)))


def _opt_cfgs(**kw):
    kw = dict(lr=LR, clip_lr=CLIP_LR, total_steps=10, warmup_steps_pct=0.0,
              **kw)
    return RefOptimConfig(**kw), OptimConfig(**kw)


def _jax_step(jcfg, tree, batch, accum=1, pipeline=None, **opt):
    ref_opt, _ = _opt_cfgs(**opt)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    tx = ref_build_optimizer(jcfg, ref_opt, params)
    state = create_train_state(params, tx, jax.random.PRNGKey(1))
    step = ref_make_train_step(jcfg, tx, make_mesh(n_data=1, n_model=1),
                               loss_weights={"ce_loss": 1.0},
                               pipeline=pipeline, accum_steps=accum)
    b = batch if accum == 1 else {
        k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])
        for k, v in batch.items()}
    state, metrics = step(state, jax.tree_util.tree_map(jnp.asarray, b))
    new = flatten_tree(jax.tree_util.tree_map(np.asarray,
                                              jax.device_get(state.params)))
    return new, {k: float(v) for k, v in metrics.items()}


def _jax_grads(jcfg, tree, batch):
    """jax.grad of the FT step's loss (ce_loss on `img`), {JAX path: f32
    numpy} over every leaf, frozen ones included."""
    def loss(p):
        out = ref_cls.classifier_forward(p, jcfg, jnp.asarray(batch["img"]),
                                         jnp.asarray(batch["valid_mask"]),
                                         train=True)
        return ref_cls.train_loss(jcfg, out,
                                  jnp.asarray(batch["label"]))["ce_loss"]

    grads = jax.grad(loss)(jax.tree_util.tree_map(jnp.asarray, tree))
    return flatten_tree(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), grads))


def _port_step(pcfg, params, batch, accum=1, pipeline=None, **opt):
    _, opt_cfg = _opt_cfgs(**opt)
    optim = Optimizer(pcfg, opt_cfg, params)
    step = make_train_step(pcfg, params, optim, loss_weights={"ce_loss": 1.0},
                           pipeline=pipeline, accum_steps=accum)
    metrics = step({k: torch.from_numpy(v) for k, v in batch.items()})
    return {k: float(v) for k, v in metrics.items()}


def _port_grads(params):
    """{JAX path: the port's gradient in the JAX shape} of trainable leaves."""
    return to_jax_flat((n, p.grad) for n, p in params.named_parameters()
                       if p.grad is not None)


def _assert_update_matches(before, jax_new, params, pcfg):
    got = to_jax_flat(params.named_parameters())
    grads = _port_grads(params)
    mask = {jax_path(n)[0]: m for n, m in
            trainable_mask(pcfg, params).items()}
    assert set(got) == set(jax_new) == set(mask)
    n_trained = 0
    for path, want in jax_new.items():
        old = flatten_tree(before)[path]
        if not mask[path]:
            np.testing.assert_array_equal(got[path], old, err_msg=path)
            np.testing.assert_array_equal(want, old, err_msg=path)
            continue
        n_trained += 1
        g = np.abs(grads[path])
        noise = g <= 1e-5 * g.max()
        lr = CLIP_LR if path.startswith(("clip/visual", "lora")) else LR
        np.testing.assert_allclose(got[path][~noise], want[~noise], rtol=0,
                                   atol=1e-6, err_msg=path)
        assert (np.abs(got[path] - old)[noise] <= lr * 1.01).all(), path
        assert not np.array_equal(got[path], old), f"{path} did not move"
    assert n_trained


def _assert_metrics_match(got, want):
    assert set(got) == set(want)
    for k in want:
        assert np.isclose(got[k], want[k], rtol=1e-5, atol=1e-6), (
            k, got[k], want[k])


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("mode", ["full", "ln", "bias", "lora"])
def test_ft_update_matches_jax(pallas_attention, mode, remat):
    kw = dict(ft_mode=mode, remat=remat, prompt_tuning=mode == "full")
    if mode == "lora":
        kw["lora"] = "qkvo-16"
    jcfg, pcfg = _cfgs(**kw)
    tree = _tree(jcfg)
    batch = _batch()
    jax_new, jax_m = _jax_step(jcfg, tree, batch)
    params = _port_params(tree, pcfg)
    port_m = _port_step(pcfg, params, batch)
    _assert_metrics_match(port_m, jax_m)
    _assert_update_matches(tree, jax_new, params, pcfg)
    want = _jax_grads(jcfg, tree, batch)
    got = _port_grads(params)
    assert got and set(got) <= set(want)
    for path, g in got.items():
        np.testing.assert_allclose(g, want[path], rtol=1e-4,
                                   atol=1e-6 * np.abs(want[path]).max(),
                                   err_msg=path)


@pytest.mark.parametrize("mode", ["full", "lora"])
def test_ft_grads_bf16_match_jax(pallas_attention, mode):
    """The bf16 step's gradients (bf16 activations over f32 weights, as the
    shipped FT configs train) against jax.grad of the same loss: `dense`'s
    f32 accumulation and its backward's roundings, layer_norm and
    quick_gelu in bf16, K3's rounding of p. Each trained leaf within 3% of
    its norm, cosine at least 0.9995; these inputs read at most 1.1% and
    0.99995 (one-ulp differences of the forward's sums carry into the
    backward)."""
    kw = dict(ft_mode=mode, remat=True, prompt_tuning=True)
    if mode == "lora":
        kw["lora"] = "qkvo-16"
    jcfg, pcfg = _cfgs(dtype="bfloat16", **kw)
    tree = _tree(jcfg)
    batch = _batch()
    want = _jax_grads(jcfg, tree, batch)
    params = _port_params(tree, pcfg)
    _port_step(pcfg, params, batch)
    got = _port_grads(params)
    mask = {jax_path(n)[0]: m for n, m in
            trainable_mask(pcfg, params).items()}
    assert set(got) == {k for k, m in mask.items() if m}
    for path, g in got.items():
        a, e = g.reshape(-1).astype(np.float64), want[path].reshape(-1)
        if not e.any():
            np.testing.assert_array_equal(a, 0, err_msg=path)
            continue
        assert np.linalg.norm(a - e) <= 3e-2 * np.linalg.norm(e), path
        assert a @ e >= 0.9995 * np.linalg.norm(a) * np.linalg.norm(e), path


def test_accumulated_update_matches_jax_and_one_batch(pallas_attention):
    """accum_steps 2 on raw event windows (the histogram, then the tower):
    the JAX package's accumulated step, and the port's one-batch step's
    gradient."""
    jcfg, pcfg = _cfgs(ft_mode="full", remat=True, prompt_tuning=True)
    tree = _tree(jcfg, seed=1)
    batch = _batch(seed=1, windows=True)
    ref_pipe, pipe = _pipelines()
    jax_new, jax_m = _jax_step(jcfg, tree, batch, accum=2, pipeline=ref_pipe)
    params = _port_params(tree, pcfg)
    port_m = _port_step(pcfg, params, batch, accum=2, pipeline=pipe)
    _assert_metrics_match(port_m, jax_m)
    _assert_update_matches(tree, jax_new, params, pcfg)

    accumulated = _port_grads(params)
    whole = _port_params(tree, pcfg)
    _port_step(pcfg, whole, batch, accum=1, pipeline=pipe)
    # the mean of two microbatch means vs one mean: f32 summation order
    for path, g in _port_grads(whole).items():
        np.testing.assert_allclose(accumulated[path], g, rtol=1e-4,
                                   atol=1e-6 * np.abs(g).max(), err_msg=path)


def test_warmup_cosine_matches_jax():
    for max_lr, total, pct in ((1.0, 100, 0.1), (2e-5, 400, 0.05),
                               (1e-3, 7, 0.0)):
        ref = ref_warmup_cosine(max_lr, total, pct)
        got = warmup_cosine(max_lr, total, pct)
        # the JAX schedule runs in f32, where 1 + cos(pi t) cancels near
        # the end of the decay: held to 1e-6 of max_lr there
        for step in range(total + 3):
            assert np.isclose(got(step), float(ref(step)), rtol=1e-6,
                              atol=1e-6 * max_lr), (max_lr, total, pct, step)
    assert warmup_cosine(1.0, 100, 0.1)(0) == pytest.approx(0.01)


@pytest.mark.parametrize("mode", ["full", "ln", "lora"])
def test_two_lr_groups_and_frozen_leaves(mode):
    """FTCLIP's groups: prompts at lr, the visual tower and LoRA at
    clip_lr (the JAX package's labels, leaf by leaf); the first Adam step
    moves each group by its own lr; frozen leaves stay bit-equal."""
    kw = dict(ft_mode=mode, prompt_tuning=True,
              lora="qkv-8" if mode == "lora" else None)
    jcfg, pcfg = _cfgs(**kw)
    tree = _tree(jcfg)
    want = {path_str(p): lab for p, lab in
            jax.tree_util.tree_flatten_with_path(ref_labels(
                jcfg, jax.tree_util.tree_map(jnp.asarray, tree)))[0]}
    params = _port_params(tree, pcfg)
    got = {jax_path(n)[0]: lab
           for n, lab in optimizer_labels(pcfg, params).items()}
    assert got == want
    _port_step(pcfg, params, _batch())
    new = to_jax_flat(params.named_parameters())
    old = flatten_tree(tree)
    for path, lab in want.items():
        delta = np.abs(new[path] - old[path]).max()
        if lab == "frozen":
            np.testing.assert_array_equal(new[path], old[path], err_msg=path)
        else:
            lr = LR if lab == "base" else CLIP_LR
            assert lr * 0.5 < delta <= lr * 1.01, (path, delta)


def test_grad_clip_norm_includes_frozen_gradients():
    """optax.clip_by_global_norm ahead of multi_transform takes the norm
    over every gradient jax.grad produces, frozen visual leaves included
    (`ln` mode: the tower's weights are frozen but get a gradient)."""
    jcfg, pcfg = _cfgs(ft_mode="ln", prompt_tuning=True)
    tree = _tree(jcfg)
    batch = _batch()
    flat_g = _jax_grads(jcfg, tree, batch)
    norm = float(optax.global_norm(flat_g))
    clip = 0.05 * norm  # clipping on
    mask = flatten_tree(jax.tree_util.tree_map(np.asarray, ref_mask(
        jcfg, jax.tree_util.tree_map(jnp.asarray, tree))))
    trained_norm = np.sqrt(sum(float((flat_g[k] ** 2).sum())
                               for k in flat_g if mask[k]))
    assert trained_norm < 0.9 * norm  # the frozen gradients matter here

    params = _port_params(tree, pcfg)
    _port_step(pcfg, params, batch, grad_clip=clip)
    clipped = _port_grads(params)
    assert set(clipped) == {k for k in mask if mask[k]}
    for path, g in clipped.items():
        np.testing.assert_allclose(g, flat_g[path] * clip / norm, rtol=1e-4,
                                   atol=1e-9, err_msg=path)
    # frozen leaves took part in the norm and were not updated
    for n, p in params.named_parameters():
        if jax_path(n)[0] in mask and not mask[jax_path(n)[0]]:
            assert p.grad is None


@pytest.mark.parametrize("prompt_tuning", [False, True])
@pytest.mark.parametrize("mode", ["full", "lora", "conv1", "bias", "ln",
                                  "cls_fc", "cls_token", "ZS"])
def test_trainable_mask_matches_jax(mode, prompt_tuning):
    if mode == "ZS":
        jcfg, pcfg = _cfgs(model="ZSCLIP", prompt_tuning=prompt_tuning)
    else:
        jcfg, pcfg = _cfgs(ft_mode=mode, prompt_tuning=prompt_tuning,
                           lora="qkvo-4" if mode == "lora" else None)
    tree = _tree(jcfg)
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, ref_mask(
        jcfg, jax.tree_util.tree_map(jnp.asarray, tree))))
    got = {}
    for name, m in trainable_mask(pcfg, _port_params(tree, pcfg)).items():
        path = jax_path(name)[0]
        assert got.setdefault(path, m) == m, path  # one decision per leaf
    assert got == {k: bool(v) for k, v in want.items()}


FT_CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "ftclip", "*.py")))


@pytest.mark.parametrize("path", FT_CONFIGS,
                         ids=[os.path.basename(p) for p in FT_CONFIGS])
def test_ft_classifier_config_matches_jax(path):
    want = ref_cls.build_classifier_config(
        ref_load_params(path), ref_config.clip_arch_config("ViT-T/8@32"))
    got = classifier.build_classifier_config(
        load_params(path), config.clip_arch_config("ViT-T/8@32"))
    for field in ("model", "agg_func", "logit_scale", "prompt_tuning", "lora",
                  "ft_mode", "use_logits_loss", "use_probs_loss", "remat"):
        assert getattr(got, field) == getattr(want, field), field


def test_lora_init_and_spec_match_jax():
    from eventclip_tpu_torch.models.clip.model import (init_lora_params,
                                                       parse_lora_spec)

    for spec in (16, -1, "qv-8", "qkv-4", "qkvo-16", None, True):
        assert parse_lora_spec(spec) == ref_model.parse_lora_spec(spec)
    vis = _clip_cfg(config).vision
    lora = init_lora_params(vis, "qkvo-16", torch.Generator().manual_seed(0))
    ref = ref_model.init_lora_params(jax.random.PRNGKey(0),
                                     _clip_cfg(ref_config).vision, "qkvo-16")
    assert set(lora) == set(ref)
    for t, f in lora.items():
        assert tuple(f.a.shape) == ref[t]["a"].shape
        assert tuple(f.b.shape) == ref[t]["b"].shape
        assert not f.b.any()  # B zero: the delta starts at zero
        spread = float(f.a.detach().std()) / float(jnp.std(ref[t]["a"]))
        assert abs(spread - 1) < 0.1


def test_classifier_tree_round_trips_through_the_bridge():
    jcfg, pcfg = _cfgs(ft_mode="lora", lora="qkvo-4", prompt_tuning=True)
    tree = _tree(jcfg)
    params = _port_params(tree, pcfg)
    got = to_jax_flat(params.named_parameters())
    want = flatten_tree(tree)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_fs_classifier_tree_round_trips_through_the_bridge():
    """An FS tree: the adapter's stacked [L, 3d, d] wqkv is not reshaped as
    the towers' [L, 3, D, D] is."""
    jcfg, pcfg = _fs_cfgs(prompt_tuning=True)
    tree = _tree(jcfg)
    assert tree["adapter"]["blocks"]["attn"]["wqkv"].shape == (2, 48, 16)
    params = _port_params(tree, pcfg)
    assert tuple(params.adapter.blocks.layers[1].attn.wqkv.shape) == (48, 16)
    got = to_jax_flat(params.named_parameters())
    want = flatten_tree(tree)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_augment_step_draws_from_seed_and_update_count():
    """augment=True builds and steps on event windows; its RandAugment
    draws are a function of (seed, update count, microbatch): the same
    seed gives the same update, another seed another one."""
    jcfg, pcfg = _cfgs(ft_mode="full", prompt_tuning=True)
    tree = _tree(jcfg, seed=2)
    batch = _batch(seed=2, windows=True)
    _, pipe = _pipelines()

    def run(seed):
        params = _port_params(tree, pcfg)
        optim = Optimizer(pcfg, _opt_cfgs()[1], params)
        step = make_train_step(pcfg, params, optim, pipeline=pipe,
                               augment=True, seed=seed)
        m = step({k: torch.from_numpy(v) for k, v in batch.items()})
        return float(m["total_loss"]), to_jax_flat(params.named_parameters())

    (loss_a, a), (loss_b, b), (loss_c, _) = run(0), run(0), run(1)
    assert np.isfinite(loss_a) and loss_a == loss_b
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert loss_c != loss_a
    assert train.step_seeds(0, 3, 0) == train.step_seeds(0, 3, 0)
    seeds = {train.step_seeds(*k) for k in ((0, 3, 0), (0, 4, 0), (0, 3, 1),
                                            (1, 3, 0))}
    assert len(seeds) == 4 and all(a != f for a, f in seeds)


LORA_SPECS = [True, False, 0, -1, 4, "qv-8"]


@pytest.mark.parametrize("lora", LORA_SPECS, ids=[repr(v) for v in LORA_SPECS])
def test_lora_setting_matches_jax(lora):
    """clip_dict['lora'] as both packages read it: a bool counts as an int
    (True: LoRA mode with no deltas, the tower frozen), then the trainable
    leaves of the classifier built from that config."""
    path = os.path.join(ROOT, "configs", "ftclip", "ft_text_fsclip_nin_params.py")
    ref_p, p = ref_load_params(path), load_params(path)
    ref_p.clip_dict = dict(ref_p.clip_dict, lora=lora)
    p.clip_dict = dict(p.clip_dict, lora=lora)
    jcfg = ref_cls.build_classifier_config(ref_p, _clip_cfg(ref_config))
    pcfg = classifier.build_classifier_config(p, _clip_cfg(config))
    assert (pcfg.ft_mode, pcfg.lora) == (jcfg.ft_mode, jcfg.lora)
    tree = _tree(jcfg)
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, ref_mask(
        jcfg, jax.tree_util.tree_map(jnp.asarray, tree))))
    got = {jax_path(n)[0]: m for n, m in
           trainable_mask(pcfg, _port_params(tree, pcfg)).items()}
    assert got == {k: bool(v) for k, v in want.items()}


def _fs_cfgs(prompt_tuning=True, dropout=0.0, **kw):
    """FSCLIP on the tiny tower: a 2-layer adapter (d_model 16, 2 heads)
    over its 32-wide features, in both packages."""
    ad = dict(adapter_type="trans", in_dim=32, d_model=16, num_heads=2,
              ffn_dim=64, num_layers=2, residual=0.8, dropout=dropout)
    from eventclip_tpu.models.adapter import AdapterConfig as RefAdapterConfig
    from eventclip_tpu_torch.models.adapter import AdapterConfig

    jcfg, pcfg = _cfgs(model="FSCLIP", prompt_tuning=prompt_tuning, **kw)
    return (dataclasses.replace(jcfg, adapter=RefAdapterConfig(**ad)),
            dataclasses.replace(pcfg, adapter=AdapterConfig(**ad)))


@pytest.mark.parametrize("prompt_tuning", [False, True])
def test_fs_update_matches_jax(pallas_attention, prompt_tuning):
    """One FS update (the adapter, and the prompts when tuned) in f32, no
    augment, dropout 0: the JAX step's updated leaves and jax.grad's
    gradients, as test_ft_update_matches_jax holds the FT ones."""
    jcfg, pcfg = _fs_cfgs(prompt_tuning)
    tree = _tree(jcfg, seed=3)
    batch = _batch(seed=3)
    jax_new, jax_m = _jax_step(jcfg, tree, batch)
    params = _port_params(tree, pcfg)
    port_m = _port_step(pcfg, params, batch)
    _assert_metrics_match(port_m, jax_m)
    _assert_update_matches(tree, jax_new, params, pcfg)
    want = _jax_grads(jcfg, tree, batch)
    got = _port_grads(params)
    assert {k.split("/")[0] for k in got} == (
        {"adapter", "text_feats"} if prompt_tuning else {"adapter"})
    for path, g in got.items():
        np.testing.assert_allclose(g, want[path], rtol=1e-4,
                                   atol=1e-6 * np.abs(want[path]).max(),
                                   err_msg=path)
    # the frozen tower recorded no graph: no visual leaf got a gradient
    assert all(p.grad is None for n, p in params.named_parameters()
               if n.startswith("clip."))


@pytest.mark.parametrize("prompt_tuning", [False, True])
def test_fs_trainable_mask_matches_jax(prompt_tuning):
    jcfg, pcfg = _fs_cfgs(prompt_tuning)
    tree = _tree(jcfg)
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, ref_mask(
        jcfg, jax.tree_util.tree_map(jnp.asarray, tree))))
    got = {jax_path(n)[0]: m for n, m in
           trainable_mask(pcfg, _port_params(tree, pcfg)).items()}
    assert got == {k: bool(v) for k, v in want.items()}
    assert any(k.startswith("adapter/") and v for k, v in got.items())


FS_CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "fsclip", "**",
                                           "*.py"), recursive=True)) + [
    os.path.join(ROOT, "configs", "debug", "fsclip_tiny_params.py")]


@pytest.mark.parametrize("path", FS_CONFIGS,
                         ids=[os.path.basename(p) for p in FS_CONFIGS])
def test_fs_classifier_config_matches_jax(path):
    want = ref_cls.build_classifier_config(
        ref_load_params(path), ref_config.clip_arch_config("ViT-T/8@32"))
    got = classifier.build_classifier_config(
        load_params(path), config.clip_arch_config("ViT-T/8@32"))
    assert got.model == "FSCLIP"
    assert dataclasses.asdict(got.adapter) == dataclasses.asdict(want.adapter)
    for field in ("model", "agg_func", "logit_scale", "prompt_tuning", "lora",
                  "ft_mode", "use_logits_loss", "use_probs_loss", "remat"):
        assert getattr(got, field) == getattr(want, field), field


def test_fs_trainer_learns_with_augment(tmp_path):
    """EventCLIPTrainer on configs/debug/fsclip_tiny_params.py on the CPU
    (tiny tower, FS adapter with prompt tuning, RandAugment on): over a
    separable set (each class a blob in its own quadrant) the training
    loss falls."""
    from eventclip_tpu_torch.data.event_windows import EventWindowDataset
    from eventclip_tpu_torch.data.host_ops import prepare_stream
    from eventclip_tpu_torch.engine.trainer import EventCLIPTrainer

    class Quadrants:
        resolution = (40, 48)
        max_t = 0.1
        max_n = 2000
        augmentation = False
        num_shots = None
        root = "quadrants"

        def __init__(self, n, seed):
            self.n, self.seed = n, seed
            self.classes = [f"c{i}" for i in range(4)]

        def __len__(self):
            return self.n

        def __getitem__(self, idx):
            rng = np.random.default_rng((self.seed, idx))
            label, (H, W) = idx % 4, self.resolution
            n = int(rng.integers(1200, 2000))
            cy, cx = 10 + 20 * (label // 2), 12 + 24 * (label % 2)
            ev = np.stack([
                np.floor(np.clip(rng.normal(cx, 4, n), 0, W - 1)),
                np.floor(np.clip(rng.normal(cy, 4, n), 0, H - 1)),
                np.sort(rng.uniform(0, self.max_t, n)),
                rng.choice([-1.0, 1.0], n)], 1).astype(np.float32)
            return {"events": prepare_stream(ev, self.resolution),
                    "label": label, "data_idx": idx}

    params = load_params(os.path.join(ROOT, "configs", "debug",
                                      "fsclip_tiny_params.py"))
    params.max_epochs = 12
    params.bf16 = False
    q = dict(params.quantize_args)
    train_set = EventWindowDataset(Quadrants(16, 0), q, augment=True)
    val_set = EventWindowDataset(Quadrants(8, 1), dict(q, max_imgs=10))
    trainer = EventCLIPTrainer(params, train_set, val_set, str(tmp_path),
                               smoke=True, device="cpu")
    assert trainer.cls_cfg.model == "FSCLIP" and trainer.train_set.augment
    assert trainer.evaluate(max_steps=1)["n"] == 4  # sanity eval, packed
    losses = [trainer.train_epoch(e)["total_loss"] for e in range(12)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-4:]) < 0.5 * np.mean(losses[:4]), losses


def test_trainer_fits_saves_and_resumes(tmp_path):
    """EventCLIPTrainer on the CPU with a tiny tower: the sanity eval,
    epochs of steps with an eval and a save after each, the trainable
    checkpoint and resume state on disk; a second trainer in the same
    directory resumes where the first stopped."""
    import json

    from eventclip_tpu_torch.data.event_windows import EventWindowDataset
    from eventclip_tpu_torch.engine.trainer import EventCLIPTrainer
    from tests.test_torch_loader import QUANT, StubEvents

    def make(max_epochs):
        params = load_params(os.path.join(
            ROOT, "configs", "ftclip", "ft_text_fsclip_nin_params.py"))
        params.clip_dict = dict(params.clip_dict, arch="ViT-T/8@32")
        params.dataset = "n_caltech"  # 4 stub classes: no top-5
        params.train_batch_size = params.val_batch_size = 4
        params.num_workers = 2
        params.max_epochs = max_epochs
        params.eval_interval = 1
        params.bf16 = False
        train = EventWindowDataset(StubEvents(n=9, seed=0), QUANT)
        val = EventWindowDataset(StubEvents(n=5, seed=1),
                                 dict(QUANT, max_imgs=10))
        return EventCLIPTrainer(params, train, val, str(tmp_path),
                                log_file=str(tmp_path / "log.jsonl"),
                                smoke=True, device="cpu")

    first = make(max_epochs=2)
    frozen = first.model_params.clip.text.positional_embedding.detach().clone()
    first.fit(san_check_val_step=1)
    assert first.optimizer.count == 4  # 2 epochs x 9 // 4 batches
    assert len(first.step_times) == 2
    models = tmp_path / "models"
    assert {p.name for p in models.iterdir()} == {
        "model_2.npz", "model_4.npz", "best.npz", "resume.pt"}
    torch.testing.assert_close(
        first.model_params.clip.text.positional_embedding, frozen, rtol=0,
        atol=0)
    records = [json.loads(line) for line in open(tmp_path / "log.jsonl")]
    assert [r["split"] for r in records] == ["val", "train", "val", "train",
                                             "val"]
    assert all(np.isfinite(r["ce_loss"]) for r in records)

    second = make(max_epochs=3)
    second.fit(san_check_val_step=0)
    assert second.optimizer.count == 6  # resumed after epoch 2
    assert (models / "model_6.npz").exists()
