"""Trainable checkpoints cross between the JAX package and the port.

Both packages write npz archives keyed by the JAX tree paths, holding the
trainable leaves only (FT: tower leaves, LoRA deltas, prompts; FS: the
adapter and prompts). A checkpoint the JAX package's `save_trainable`
writes loads into the port's parameters (whatever they held before) and
the port then gives the JAX package's probabilities; a checkpoint the port
writes loads with the JAX package's `load_checkpoint(target=...)`. f32
probabilities: atol 1e-5 (the towers' own parity tolerance).
"""

import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventclip_tpu.engine.checkpoint import load_checkpoint as ref_load
from eventclip_tpu.engine.checkpoint import save_trainable as ref_save
from eventclip_tpu.models import classifier as ref_cls
from eventclip_tpu.models.partition import trainable_mask as ref_mask
from eventclip_tpu_torch.engine.checkpoint import (CheckpointManager,
                                                   load_checkpoint,
                                                   save_trainable)
from eventclip_tpu_torch.engine.optim import OptimConfig, Optimizer
from eventclip_tpu_torch.models import classifier
from eventclip_tpu_torch.models.clip.convert import flatten_tree, to_jax_flat
from tests.test_torch_train import (N_CLS, _cfgs, _fs_cfgs, _port_params,
                                    _tree)

MODES = [dict(ft_mode="full", prompt_tuning=True),
         dict(ft_mode="lora", lora="qkvo-4"),
         dict(ft_mode="bias"),
         dict(model="FSCLIP", prompt_tuning=True),
         dict(model="FSCLIP", prompt_tuning=False)]
IDS = ["full", "lora", "bias", "fs_prompt", "fs"]


def _mode_cfgs(kw):
    """FT modes, or FSCLIP (the adapter, with or without prompt tuning;
    dropout is off outside training anyway). FS at a logit scale of 10:
    at 100 these random towers' probs saturate, and a changed adapter
    moves them by less than 1e-3."""
    if kw.get("model") == "FSCLIP":
        return _fs_cfgs(kw["prompt_tuning"], dropout=0.1, logit_scale=10.0)
    return _cfgs(**kw)


def _inputs(seed=0, B=3, T=2):
    rng = np.random.default_rng(seed)
    valid = np.ones((B, T), bool)
    valid[2, 1] = False
    return rng.normal(size=(B, T, 3, 32, 32)).astype(np.float32), valid


def _jax_probs(jcfg, tree, imgs, valid):
    out = ref_cls.classifier_forward(
        jax.tree_util.tree_map(jnp.asarray, tree), jcfg, jnp.asarray(imgs),
        jnp.asarray(valid))
    return np.asarray(out["probs"])


def _port_probs(pcfg, params, imgs, valid):
    with torch.no_grad():
        out = classifier.classifier_forward(
            params, pcfg, torch.from_numpy(imgs), torch.from_numpy(valid))
    return out["probs"].numpy()


def _replace(tree, flat):
    """A copy of a nested dict with the leaves at `flat`'s paths swapped."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _replace(v, {p[len(k) + 1:]: a for p, a in flat.items()
                                  if p.startswith(k + "/")})
        else:
            out[k] = flat.get(k, v)
    return out


def _trained_and_start(jcfg, seed):
    """(trained tree, start tree): the same frozen leaves, other values in
    every trainable leaf; and the trainable paths."""
    trained = _tree(jcfg, seed=seed)
    mask = flatten_tree(jax.tree_util.tree_map(np.asarray, ref_mask(
        jcfg, jax.tree_util.tree_map(jnp.asarray, trained))))
    other = flatten_tree(_tree(jcfg, seed=seed + 1))
    keys = {k for k in mask if mask[k]}
    return trained, _replace(trained, {k: other[k] for k in keys}), keys


@pytest.mark.parametrize("kw", MODES, ids=IDS)
def test_jax_checkpoint_serves_the_same_probs_in_the_port(tmp_path, kw):
    jcfg, pcfg = _mode_cfgs(kw)
    trained, start, _ = _trained_and_start(jcfg, seed=0)
    path = str(tmp_path / "best.npz")
    ref_save(path, jcfg, jax.tree_util.tree_map(jnp.asarray, trained),
             extra={"step": 7})
    params = _port_params(start, pcfg)
    imgs, valid = _inputs()
    want = _jax_probs(jcfg, trained, imgs, valid)
    assert not np.allclose(_port_probs(pcfg, params, imgs, valid), want,
                           atol=1e-3)
    _, extra = load_checkpoint(path, target=params)
    assert int(extra["step"]) == 7
    np.testing.assert_allclose(_port_probs(pcfg, params, imgs, valid), want,
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("kw", MODES, ids=IDS)
def test_port_checkpoint_serves_the_same_probs_in_jax(tmp_path, kw):
    jcfg, pcfg = _mode_cfgs(kw)
    trained, start, keys = _trained_and_start(jcfg, seed=2)
    params = _port_params(trained, pcfg)
    path = str(tmp_path / "model_3.npz")
    save_trainable(path, pcfg, params, extra={"step": 3})
    saved, _ = ref_load(path)
    assert set(saved) == keys
    loaded, extra = ref_load(path, target=jax.tree_util.tree_map(jnp.asarray,
                                                                start))
    assert int(extra["step"]) == 3
    got = flatten_tree(jax.tree_util.tree_map(np.asarray, loaded))
    for k, a in flatten_tree(trained).items():
        np.testing.assert_array_equal(got[k], a, err_msg=k)
    imgs, valid = _inputs(1)
    np.testing.assert_allclose(
        _jax_probs(jcfg, jax.tree_util.tree_map(np.asarray, loaded), imgs,
                   valid),
        _port_probs(pcfg, params, imgs, valid), atol=1e-5, rtol=0)


def test_load_refuses_leaves_the_model_lacks(tmp_path):
    jcfg, pcfg = _cfgs(ft_mode="lora", lora="qkv-4")
    path = str(tmp_path / "lora.npz")
    save_trainable(path, pcfg, _port_params(_tree(jcfg), pcfg))
    _, plain = _cfgs(ft_mode="full")
    params = classifier.init_classifier_params(
        plain, torch.Generator().manual_seed(0), n_classes=N_CLS)
    with pytest.raises(ValueError, match="match no parameter"):
        load_checkpoint(path, target=params)


def test_manager_keeps_best_and_prunes(tmp_path):
    jcfg, pcfg = _cfgs(ft_mode="ln")
    params = _port_params(_tree(jcfg), pcfg)
    mgr = CheckpointManager(str(tmp_path), pcfg, keep_last=2)
    for step, acc in ((1, 0.5), (2, 0.9), (3, 0.7), (4, 0.8)):
        mgr.save(params, step, {"probs_acc": acc})
    _, extra = load_checkpoint(str(tmp_path / "models" / "best.npz"))
    assert int(extra["step"]) == 2
    assert mgr.latest().endswith("best.npz")
    assert len(glob.glob(str(tmp_path / "models" / "model_*.npz"))) == 2


def test_resume_state_round_trips(tmp_path):
    jcfg, pcfg = _cfgs(ft_mode="full", prompt_tuning=True)
    tree = _tree(jcfg)
    params = _port_params(tree, pcfg)
    opt = Optimizer(pcfg, OptimConfig(lr=1e-2, clip_lr=1e-3,
                                            total_steps=10), params)
    for p in opt.trained:
        p.grad = torch.ones_like(p)
    opt.step()
    mgr = CheckpointManager(str(tmp_path), pcfg)
    mgr.best_metric = 0.25
    mgr.save_resume_state(params, opt, epoch=3)

    fresh = _port_params(_tree(jcfg, seed=5), pcfg)
    opt2 = Optimizer(pcfg, OptimConfig(lr=1e-2, clip_lr=1e-3,
                                             total_steps=10), fresh)
    mgr2 = CheckpointManager(str(tmp_path), pcfg)
    assert mgr2.load_resume_state(fresh, opt2) == 3
    assert mgr2.best_metric == 0.25 and opt2.count == 1
    want = to_jax_flat(params.named_parameters())
    got = to_jax_flat(fresh.named_parameters())
    mask = flatten_tree(jax.tree_util.tree_map(np.asarray, ref_mask(
        jcfg, jax.tree_util.tree_map(jnp.asarray, tree))))
    for k in want:
        if mask[k]:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    s1, s2 = opt.torch_opt.state_dict(), opt2.torch_opt.state_dict()
    for i, st in s1["state"].items():
        torch.testing.assert_close(s2["state"][i]["exp_avg"], st["exp_avg"])
