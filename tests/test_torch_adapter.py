"""The port's FS view adapter vs the JAX package's `apply_adapter`.

The adapter's parameters are drawn by the JAX package (biases and norms
filled at random so each one matters), cross to the port through
models/clip/convert.py, and the same numpy features and valid masks go
through both. f32 on the CPU: rtol / atol 1e-5, in eval mode and in train
mode with dropout 0 (dropout's masks are random draws, never matched
across packages). Fully padded rows are included: their softmax is NaN and
both zero it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventclip_tpu.models import adapter as ref_adapter
from eventclip_tpu.utils.pytree import path_str
from eventclip_tpu_torch.models import adapter
from eventclip_tpu_torch.models.clip.convert import (flatten_tree,
                                                     from_jax_params,
                                                     jax_path, to_jax_flat)

C, D, HEADS, FFN, LAYERS = 32, 16, 2, 64, 2


def _cfgs(**kw):
    kw = dict(adapter_type="trans", in_dim=C, d_model=D, num_heads=HEADS,
              ffn_dim=FFN, num_layers=LAYERS, residual=0.8, **kw)
    return ref_adapter.AdapterConfig(**kw), adapter.AdapterConfig(**kw)


def _tree(jcfg, seed=0):
    tree = jax.tree_util.tree_map(np.asarray, ref_adapter.init_adapter_params(
        jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed + 10)

    def fill(path, a):
        key = path_str(path).split("/")[-1]
        if key in ("b", "bqkv", "bo", "b1", "b2", "bias"):
            return (0.1 * rng.normal(size=a.shape)).astype(np.float32)
        if key == "scale":
            return (1 + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(fill, tree)


def _port(pcfg, tree):
    mod = adapter.Adapter(pcfg)
    state = {k[len("adapter."):]: v
             for k, v in from_jax_params({"adapter": tree}).items()}
    mod.load_state_dict(state, strict=True)
    return mod


def _inputs(seed=0, B=4, T=3):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, T, C)).astype(np.float32)
    valid = np.ones((B, T), bool)
    valid[1, 2] = False
    valid[2, 1:] = False
    valid[3] = False  # a fully padded row (a pad_last eval row)
    feats[~valid] = 0.0  # padded slots carry zeros, as in the classifier
    return feats, valid


def _run_both(jcfg, pcfg, tree, feats, valid, train):
    want = ref_adapter.apply_adapter(
        jax.tree_util.tree_map(jnp.asarray, tree), jcfg, jnp.asarray(feats),
        jnp.asarray(valid), train=train,
        rng=jax.random.PRNGKey(5) if train else None)
    got = adapter.apply_adapter(
        _port(pcfg, tree), pcfg, torch.from_numpy(feats),
        torch.from_numpy(valid), train=train,
        generator=torch.Generator().manual_seed(5) if train else None)
    return got.detach().numpy(), np.asarray(want)


@pytest.mark.parametrize("residual", [0.0, 0.8])
@pytest.mark.parametrize("train", [False, True])
def test_adapter_forward_matches_jax(train, residual):
    jcfg, pcfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, residual=residual, dropout=0.0)
    pcfg = dataclasses.replace(pcfg, residual=residual, dropout=0.0)
    tree = _tree(jcfg)
    feats, valid = _inputs()
    got, want = _run_both(jcfg, pcfg, tree, feats, valid, train)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_identity_adapter_passes_features_through():
    jcfg, pcfg = _cfgs()
    pcfg = dataclasses.replace(pcfg, adapter_type="identity")
    assert adapter.init_adapter_params(pcfg, torch.Generator()) is None
    assert ref_adapter.init_adapter_params(
        jax.random.PRNGKey(0),
        dataclasses.replace(jcfg, adapter_type="identity")) is None
    feats, valid = _inputs()
    x = torch.from_numpy(feats)
    assert adapter.apply_adapter(None, pcfg, x, torch.from_numpy(valid)) is x


def test_residual_mapping_and_full_residual():
    for r in (True, False, 0.0, 0.25, 1.0):
        assert (adapter.AdapterConfig.residual_value(r)
                == ref_adapter.AdapterConfig.residual_value(r))
    jcfg, pcfg = _cfgs()
    pcfg = dataclasses.replace(pcfg, residual=1.0)
    tree = _tree(jcfg)
    feats, valid = _inputs()
    got = adapter.apply_adapter(_port(pcfg, tree), pcfg,
                                torch.from_numpy(feats),
                                torch.from_numpy(valid))
    np.testing.assert_array_equal(got.detach().numpy(), feats)


def test_dropout_only_in_train_with_a_generator():
    jcfg, pcfg = _cfgs()  # dropout 0.1
    mod = _port(pcfg, _tree(jcfg))
    feats, valid = _inputs()
    x, v = torch.from_numpy(feats), torch.from_numpy(valid)

    def run(train, seed=None):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        return adapter.apply_adapter(mod, pcfg, x, v, train=train,
                                     generator=gen).detach()

    ref = run(False)
    torch.testing.assert_close(run(False, seed=1), ref, rtol=0, atol=0)
    torch.testing.assert_close(run(True), ref, rtol=0, atol=0)
    a, b = run(True, seed=1), run(True, seed=2)
    assert not torch.equal(a, ref) and not torch.equal(a, b)
    torch.testing.assert_close(run(True, seed=1), a, rtol=0, atol=0)


def test_init_names_shapes_and_spread_match_jax():
    jcfg, pcfg = _cfgs()
    want = flatten_tree(jax.tree_util.tree_map(
        np.asarray, ref_adapter.init_adapter_params(jax.random.PRNGKey(0),
                                                    jcfg)))
    mod = adapter.init_adapter_params(pcfg, torch.Generator().manual_seed(0))
    names = [jax_path("adapter." + n)[0] for n, _ in mod.named_parameters()]
    got = to_jax_flat(("adapter." + n, p) for n, p in mod.named_parameters())
    assert set(names) == {"adapter/" + k for k in want}
    # uniform draws: torch's bound for each leaf, from its fan
    fan_in = {"in_proj/w": C, "in_proj/b": C, "out_proj/w": D,
              "out_proj/b": D, "blocks/attn/wo": D, "blocks/mlp/w1": D,
              "blocks/mlp/b1": D, "blocks/mlp/w2": FFN, "blocks/mlp/b2": FFN}
    bounds = {k: f ** -0.5 for k, f in fan_in.items()}
    bounds["blocks/attn/wqkv"] = (6.0 / (4 * D)) ** 0.5  # xavier
    for k, a in want.items():
        g = got["adapter/" + k]
        assert g.shape == a.shape, k
        if k in bounds:
            for x in (g, a):
                assert 0.5 * bounds[k] < np.abs(x).max() <= bounds[k], k
        else:  # zero attention biases, identity norms
            np.testing.assert_array_equal(g, a, err_msg=k)
