"""The port's sharding rules (parallel/sharding.py) against the JAX
package's (eventclip_tpu/parallel/sharding.py).

- The rules: for every leaf of a ViT-T/8@32 FT tree with LoRA ('qkvo'),
  an FS tree (the adapter's stacked blocks are not a tower's) and a
  ViT-L/14-shaped FT/LoRA tree (shapes only, `jax.eval_shape`), n_model
  in {1, 2, 4} and n_data in {2, 4}, the port's Megatron and ZeRO-1 specs
  pick the JAX dims, and so do the placements of the port's tensors.
- The cuts, exactly: the JAX arrays placed on a (data, model) mesh of the
  8 host devices by `shard_params` (parameters) and `shard_opt_state` (the
  ZeRO-1 layout, applied to the same tree), and each device's
  `addressable_shards` crossed to the port's layout (`port_leaves`), equal
  bit for bit what the port's `shard_params` and `shard_opt_state` leave on
  the rank of that device's (data, model) index.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from eventclip_tpu.models import classifier as ref_cls
from eventclip_tpu.models.clip.config import clip_arch_config as ref_arch
from eventclip_tpu.parallel import sharding as ref
from eventclip_tpu.utils.pytree import path_str
from eventclip_tpu_torch.models import classifier
from eventclip_tpu_torch.models.clip.config import clip_arch_config
from eventclip_tpu_torch.models.clip.convert import (flatten_tree,
                                                     from_jax_params,
                                                     port_leaves)
from eventclip_tpu_torch.parallel import sharding

N_CLS = 10
LAYOUTS = [(2, 1), (4, 1), (2, 2), (4, 2), (2, 4)]  # (n_data, n_model)


def _jax_cfg(arch, model="FTCLIP", lora="qkvo-16"):
    kw = dict(model=model, clip=ref_arch(arch))
    if model == "FTCLIP":
        kw.update(lora=lora, ft_mode="lora")
    else:
        kw["adapter"] = ref_cls.AdapterConfig(adapter_type="trans",
                                              in_dim=ref_arch(arch).embed_dim)
    return ref_cls.ClassifierConfig(**kw)


def _jax_tree(cfg, shapes_only=False):
    init = lambda r: ref_cls.init_classifier_params(  # noqa: E731
        r, cfg, n_classes=N_CLS)
    key = jax.random.PRNGKey(0)
    tree = jax.eval_shape(init, key) if shapes_only else init(key)
    return tree


def _meta_params(cfg):
    """The port's ClassifierParams of `cfg` on the meta device (shapes
    only)."""
    from eventclip_tpu_torch.models.adapter import Adapter
    from eventclip_tpu_torch.models.clip.model import (CLIP, LoRA,
                                                       LoRAFactors,
                                                       parse_lora_spec)

    clip = CLIP(cfg.clip, device="meta")
    lora = adapter = None
    if cfg.lora is not None:
        spec = parse_lora_spec(cfg.lora)
        lora = LoRA({t: LoRAFactors(cfg.clip.vision.layers, spec["rank"],
                                    cfg.clip.vision.width, device="meta")
                     for t in spec["targets"]})
    if cfg.model == "FSCLIP":
        adapter = Adapter(cfg.adapter, device="meta")
    return classifier.ClassifierParams(
        clip, torch.empty(N_CLS, cfg.clip.embed_dim, device="meta"), lora,
        adapter)


def _spec(p, ndim):
    """A JAX PartitionSpec as a tuple of one entry a dim."""
    dims = tuple(p) + (None,) * (ndim - len(tuple(p)))
    return dims


def _flat_specs(tree, specs):
    leaves = {path_str(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(tree)[0]}
    sp = {path_str(k): v for k, v in jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
    return {k: _spec(sp[k], len(np.shape(v))) for k, v in leaves.items()}


CASES = [("ViT-T/8@32", "FTCLIP", False), ("ViT-T/8@32", "FSCLIP", False),
         ("ViT-L/14", "FTCLIP", True)]


@pytest.mark.parametrize("arch,model,shapes_only", CASES)
@pytest.mark.parametrize("n_data", [2, 4])
@pytest.mark.parametrize("n_model", [1, 2, 4])
def test_rules_pick_the_jax_dims(arch, model, shapes_only, n_data, n_model):
    tree = _jax_tree(_jax_cfg(arch, model), shapes_only=True)
    shapes = {path_str(k): tuple(v.shape) for k, v in
              jax.tree_util.tree_flatten_with_path(tree)[0]}
    want_p = _flat_specs(tree, ref.param_pspecs(tree, n_model))
    want_z = _flat_specs(tree, ref.zero1_pspecs(tree, n_data, n_model))
    assert sharding.param_pspecs(shapes, n_model) == want_p
    assert sharding.zero1_pspecs(shapes, n_data, n_model) == want_z
    if n_model > 1:
        assert any(sharding.MODEL_AXIS in s for s in want_p.values())
    # the placements of the port's own tensors carry the same specs
    port = _meta_params(_port_cfg(model, arch))
    for zero1, want in ((False, want_p), (True, want_z)):
        pls = sharding.placements(port.named_parameters(), n_model=n_model,
                                  n_data=n_data, zero1=zero1)
        assert {pl.path for pl in pls.values()} == set(want)
        for name, pl in pls.items():
            assert pl.spec == want[pl.path], (name, zero1)
            assert pl.shape == shapes[pl.path], name


def _device_index(mesh, device):
    d, m = np.argwhere(mesh.devices == device)[0]
    return int(d), int(m)


def _shard_leaves(path, shard, L):
    """A JAX shard of one leaf -> {port name: port-shaped array}, layers
    numbered from the shard's first (a shard split on the layer dim holds
    L / n of them)."""
    out = dict(port_leaves(path, np.asarray(shard.data)))
    n = np.asarray(shard.data).shape[0] if L else None
    if L and n != L:
        first = shard.index[0].start or 0
        renamed = {}
        for name, v in out.items():
            parts = name.split(".")
            i = parts.index("layers") + 1
            parts[i] = str(int(parts[i]) + first)
            renamed[".".join(parts)] = v
        out = renamed
    return out


@pytest.mark.parametrize("model", ["FTCLIP", "FSCLIP"])
@pytest.mark.parametrize("n_data,n_model", LAYOUTS)
def test_every_rank_holds_the_jax_shard_exactly(model, n_data, n_model):
    jcfg = _jax_cfg("ViT-T/8@32", model)
    tree = jax.tree_util.tree_map(np.asarray, _jax_tree(jcfg))
    flat = flatten_tree(tree)
    mesh = ref.make_mesh(n_data=n_data, n_model=n_model,
                         devices=jax.devices()[:n_data * n_model])
    placed_p = ref.shard_params(tree, mesh)
    placed_z = ref.shard_opt_state(tree, mesh)
    full = from_jax_params(tree)
    pls = sharding.placements(
        ((n, t) for n, t in full.items()), n_model=n_model)
    stacked = {path: (v.shape[0] if any(s in path.split("/")
                                        for s in ("blocks", "rest"))
                      else 0) for path, v in flat.items()}
    for placed, zero1 in ((placed_p, False), (placed_z, True)):
        per_device = {}
        for k, arr in jax.tree_util.tree_flatten_with_path(placed)[0]:
            path = path_str(k)
            for shard in arr.addressable_shards:
                idx = _device_index(mesh, shard.device)
                per_device.setdefault(idx, {}).update(
                    _shard_leaves(path, shard, stacked[path]))
        for (d, m), want in per_device.items():
            tp = sharding.TPContext(n_data=n_data, n_model=n_model,
                                    data_index=d, model_index=m)
            if not zero1:
                port = classifier.init_classifier_params(
                    _port_cfg(model), torch.Generator().manual_seed(0),
                    n_classes=N_CLS)
                port.load_state_dict(full, strict=True)
                sharding.shard_params(port, tp if n_model > 1 else None)
                got = {n: p.detach().numpy()
                       for n, p in port.named_parameters()}
            else:
                got = sharding.shard_opt_state(
                    full, pls, tp if n_model > 1 else None, n_data, d, True)
                got = {n: t.numpy() for n, t in got.items()}
            covered = {n for n in got if got[n].size}
            assert covered <= set(want) and covered, (d, m)
            for name in covered:
                g = got[name]
                if zero1:
                    g = sharding.port_layout(torch.from_numpy(g),
                                             pls[name]).numpy()
                np.testing.assert_array_equal(g, want[name],
                                              err_msg=f"{name} {(d, m)}")


def _port_cfg(model, arch="ViT-T/8@32"):
    clip = clip_arch_config(arch)
    kw = dict(model=model, clip=clip)
    if model == "FTCLIP":
        kw.update(lora="qkvo-16", ft_mode="lora")
    else:
        kw["adapter"] = dataclasses.replace(
            classifier.AdapterConfig(adapter_type="trans"),
            in_dim=clip.embed_dim)
    return classifier.ClassifierConfig(**kw)


def test_full_tensors_and_pieces_round_trip():
    """A model shard of each leaf, written back into a whole tensor by
    `piece` for every model index, rebuilds the leaf."""
    full = from_jax_params(jax.tree_util.tree_map(
        np.asarray, _jax_tree(_jax_cfg("ViT-T/8@32"))))
    pls = sharding.placements(full.items(), n_model=2)
    for name, t in full.items():
        pl = pls[name]
        back = torch.zeros_like(t)
        for m in range(2):
            local = sharding.port_layout(
                sharding.piece(t, pl, sharding.MODEL_AXIS, m, 2), pl)
            sharding.piece(back, pl, sharding.MODEL_AXIS, m, 2).copy_(
                local.view(sharding.piece(back, pl, sharding.MODEL_AXIS,
                                          m, 2).shape))
        assert torch.equal(back, t), name
