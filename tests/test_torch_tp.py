"""Tensor parallelism and ZeRO-1 (parallel/sharding.py, the Megatron
operators of models/clip/model.py, engine/optim.py's ZeRO-1) against the
JAX package's mesh steps and one port process.

Four gloo ranks on the CPU (`python -m tests.torch_ddp_worker <r> 4
<port> tp <dir>`, spawned once for the module) run every case of CASES on
the TINY towers of tests/test_torch_train.py (f32), each on its own
layout (`n_model` 2: a 2 x 2 data x model layout; 1: four data ranks),
from a JAX-drawn tree and global batches of 8 samples x 2 views:

- the eval forward's per-view features, logits and probabilities, each
  data group's rows in data order, against one port process and the
  JAX `classifier_forward` with its TPContext on a 4 x 2 mesh (rtol
  1e-5), and the counters of the JAX `make_eval_step` there;
- train steps with remat, with LoRA ('qkvo', o's delta inside the
  row-parallel sum), with grad_clip on (active) and FS (the frozen tower
  split; the adapter's `blocks`, which the JAX rule shards too, gathered
  for its forward), leaf by leaf against
  the JAX `make_train_step` on a 2 x 2 mesh and against one port process:
  atol 1e-6 where the gradient is above its summation noise; where it is
  at noise level (below 1e-5 of the leaf's largest, the key bias above
  all) Adam's step is lr times the noise's sign, held to 2 lr a step;
- ZeRO-1 bit-equal to the replicated update, under 2 x 2 and over four
  data ranks, alone, with accum_steps 2 and with the parameters'
  all-gather cut into 256-byte buckets; each rank's moment bytes are
  those of its `zero1_pspecs` slices (JAX's rule on the JAX tree);
- a resume.pt written after the first step under 2 x 2 with ZeRO-1,
  resumed by one process, takes the same second step;
- in every case, zero_grad frees every gradient (a rank that keeps one
  alive, as a ZeRO-1 slice's gradient view would, fails the spawn).

The CLIs: `cli.train --n_model 2 --zero1` and then `cli.test --n_model 2`
under two ranks (a 1 x 2 layout, so one data rank and ZeRO-1 a no-op, as
on a JAX mesh of data 1) against one process: the same best.npz (every
element within 2 lr a step, all but a share 1e-3 of each leaf's within
ATOL, the key bias apart: no gradients tell noise-level elements here),
the same printed accuracy lines from rank 0 and none from rank 1, and
the root test.py loads that best.npz and prints the same lines.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventclip_tpu.engine import OptimConfig as RefOptimConfig
from eventclip_tpu.engine import build_optimizer as ref_build_optimizer
from eventclip_tpu.engine import create_train_state
from eventclip_tpu.engine import make_eval_step
from eventclip_tpu.engine import make_train_step as ref_make_train_step
from eventclip_tpu.models import classifier as ref_cls
from eventclip_tpu.parallel import make_mesh, shard_batch, shard_params
from eventclip_tpu.parallel.sharding import make_tp_context, zero1_pspecs
from eventclip_tpu_torch.engine.checkpoint import CheckpointManager
from eventclip_tpu_torch.engine.optim import OptimConfig, Optimizer
from eventclip_tpu_torch.engine.train import make_train_step
from eventclip_tpu_torch.models import classifier
from eventclip_tpu_torch.models.clip.convert import (flatten_tree,
                                                     from_jax_params,
                                                     to_jax_flat)

from . import torch_ddp_worker as W
from .test_torch_cli import (REF_TEST, _eval_lines, files,  # noqa: F401
                             launch_env, ref_args)
from .test_torch_parallel import key_bias, spawn_ranks
from .test_torch_train import _cfgs, _tree

B, T = 8, 2
ATOL = 1e-6
SHARE = 1e-3
FT = dict(ft_mode="full", remat=True, prompt_tuning=True)
LORA = dict(ft_mode="lora", lora="qkvo-16", prompt_tuning=True)
# FS: the frozen tower split, the adapter's stacked blocks gathered whole
# (its dropout at 0 for parity: the packages draw it from other streams)
FS = dict(model="FSCLIP", prompt_tuning=True, adapter=dict(
    adapter_type="trans", in_dim=32, d_model=16, num_heads=2, ffn_dim=64,
    num_layers=2, residual=0.8, dropout=0.0))
CASES = {
    "tp_full": dict(cfg=FT, n_model=2, steps=2, tree="ft"),
    "tp_full_z1": dict(cfg=FT, n_model=2, steps=2, tree="ft", zero1=True,
                       resume=True),
    "tp_lora": dict(cfg=LORA, n_model=2, steps=1, tree="lora"),
    "tp_fs": dict(cfg=FS, n_model=2, steps=2, tree="fs"),
    "tp_clip": dict(cfg=dict(FT, remat=False), n_model=2, steps=1,
                    tree="ft", grad_clip=0.05),
    "dp": dict(cfg=FT, n_model=1, steps=1, tree="ft"),
    "dp_z1": dict(cfg=FT, n_model=1, steps=1, tree="ft", zero1=True),
    # all-gathers in buckets of 256 bytes: small leaves share one, each
    # larger one goes alone
    "dp_z1_buckets": dict(cfg=FT, n_model=1, steps=1, tree="ft",
                          zero1=True, bucket_bytes=256),
    "dp_accum": dict(cfg=FT, n_model=1, steps=1, tree="ft", accum=2),
    "dp_accum_z1": dict(cfg=FT, n_model=1, steps=1, tree="ft", accum=2,
                        zero1=True),
}


def _batches(n):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(n):
        valid = np.ones((B, T), bool)
        valid[1, 1] = valid[6, 0] = False
        out.append({"img": rng.normal(size=(B, T, 3, 32, 32)).astype(
                        np.float32),
                    "valid_mask": valid,
                    "label": rng.integers(0, W.N_CLS, B).astype(np.int32)})
    return out


def _jcfg(case):
    kw = dict(case["cfg"])
    if "adapter" in kw:
        kw["adapter"] = ref_cls.AdapterConfig(**kw["adapter"])
    return _cfgs(**kw)[0]


@pytest.fixture(scope="module")
def trees():
    return {"ft": _tree(_cfgs(**FT)[0]), "lora": _tree(_cfgs(**LORA)[0]),
            "fs": _tree(_jcfg(CASES["tp_fs"]))}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, trees):
    """The four ranks' results: {case: (npz dict, json)}."""
    out = tmp_path_factory.mktemp("tp")
    inputs = {f"{t}/{k}": v for t, tree in trees.items()
              for k, v in flatten_tree(tree).items()}
    for i, b in enumerate(_batches(2)):
        inputs.update({f"batch{i}/{k}": v for k, v in b.items()})
    np.savez(out / "inputs.npz", **inputs)
    (out / "cases.json").write_text(json.dumps(CASES))
    for rc, log in spawn_ranks("tests.torch_ddp_worker", ["tp", str(out)],
                               world=4):
        assert rc == 0, log
    res = {}
    for name in CASES:
        with np.load(out / f"{name}.npz") as z:
            res[name] = (dict(z), json.loads((out / f"{name}.json")
                                             .read_text()))
    return out, res


def _one(case, trees):
    """One port process on the whole global batches."""
    return W.tiny_run(dict(case, n_model=1, zero1=False),
                      flatten_tree(trees[case["tree"]]),
                      _batches(case["steps"]))


def _assert_update(got, want, before, grads, steps, err=""):
    """Leaves equal within ATOL where the gradient is above noise; at
    noise level, within 2 lr a step (see the module docstring)."""
    assert set(want) <= set(got)
    for path, w in want.items():
        g = got[path]
        if path not in grads:  # frozen
            np.testing.assert_array_equal(g, before[path], err_msg=path)
            continue
        a = np.abs(grads[path])
        noise = a <= 1e-5 * a.max()
        np.testing.assert_allclose(g[~noise], w[~noise], rtol=0, atol=ATOL,
                                   err_msg=f"{err} {path}")
        lr = W.CLIP_LR if path.startswith(("clip/visual", "lora")) else W.LR
        assert (np.abs(g - w)[noise] <= 2 * lr * steps * 1.01).all(), path


def _step_leaves(npz, i):
    return {k[len(f"step{i}/"):]: v for k, v in npz.items()
            if k.startswith(f"step{i}/")}


def _grads(npz):
    return {k[5:]: v for k, v in npz.items() if k.startswith("grad/")}


def _jax_mesh_steps(case, tree, n_data=2, n_model=2):
    jcfg = _jcfg(case)
    mesh = make_mesh(n_data=n_data, n_model=n_model,
                     devices=jax.devices()[:n_data * n_model])
    params = shard_params(jax.tree_util.tree_map(jnp.asarray, tree), mesh)
    tx = ref_build_optimizer(jcfg, RefOptimConfig(
        lr=W.LR, clip_lr=W.CLIP_LR, total_steps=10, warmup_steps_pct=0.0,
        grad_clip=case.get("grad_clip", 0.0)), params)
    state = create_train_state(params, tx, jax.random.PRNGKey(1))
    step = ref_make_train_step(jcfg, tx, mesh,
                               loss_weights={"ce_loss": 1.0})
    out = []
    for b in _batches(case["steps"]):
        state, _ = step(state, shard_batch(
            jax.tree_util.tree_map(jnp.asarray, b), mesh))
        out.append(flatten_tree(jax.tree_util.tree_map(
            np.asarray, jax.device_get(state.params))))
    return out


def test_eval_rows_equal_one_process_and_jax_4x2(ranks, trees):
    _, res = ranks
    npz, _ = res["tp_full"]
    jcfg, pcfg = _cfgs(**FT)
    b = _batches(1)[0]
    _, _, _, want, _ = _one(CASES["tp_full"], trees)
    mesh = make_mesh(n_data=4, n_model=2)
    p = shard_params(jax.tree_util.tree_map(jnp.asarray, trees["ft"]), mesh)
    x = shard_batch({k: jnp.asarray(b[k]) for k in ("img", "valid_mask")},
                    mesh)
    tp = make_tp_context(mesh)
    ref = jax.jit(lambda p, i, v: ref_cls.classifier_forward(
        p, jcfg, i, v, tp=tp))(p, x["img"], x["valid_mask"])
    for key in ("view_feats", "logits", "probs"):
        got = npz[f"rows/{key}"]
        np.testing.assert_allclose(got, want[key], rtol=1e-5,
                                   atol=1e-5 * np.abs(want[key]).max())
        np.testing.assert_allclose(got, np.asarray(ref[key]), rtol=1e-5,
                                   atol=1e-5 * np.abs(want[key]).max())
    # the counters of the JAX `make_eval_step` on the 4 x 2 mesh, from
    # the ranks' rows (tests/test_engine.py's TP check)
    ev = make_eval_step(jcfg, mesh)(p, shard_batch(
        {k: jnp.asarray(v) for k, v in dict(b, sample_mask=np.ones(
            B, bool)).items()}, mesh))
    label = b["label"]
    logits = npz["rows/logits"]
    logp = logits - np.log(np.exp(logits - logits.max(-1, keepdims=True))
                           .sum(-1, keepdims=True)) - logits.max(
                               -1, keepdims=True)
    mine = {"n": B,
            "probs_correct": (npz["rows/probs"].argmax(-1) == label).sum(),
            "logits_correct": (logits.argmax(-1) == label).sum(),
            "ce_loss_sum": -logp[np.arange(B), label].sum()}
    for k, v in mine.items():
        assert np.isclose(float(ev[k]), float(v), rtol=1e-5), k


@pytest.mark.parametrize("name", ["tp_full", "tp_lora", "tp_clip", "tp_fs"])
def test_tp_steps_equal_jax_2x2_and_one_process(ranks, trees, name):
    _, res = ranks
    npz, rec = res[name]
    case = CASES[name]
    tree = flatten_tree(trees[case["tree"]])
    grads = _grads(npz)
    assert grads
    one_leaves, _, one_m, _, _ = _one(case, trees)
    jax_leaves = _jax_mesh_steps(case, trees[case["tree"]])
    for i in range(case["steps"]):
        got = _step_leaves(npz, i)
        _assert_update(got, one_leaves[i], tree, grads, i + 1, "one")
        _assert_update(got, jax_leaves[i], tree, grads, i + 1, "jax")
    for k, v in one_m[0].items():
        assert np.isclose(rec["metrics"][0][k], v, rtol=1e-5), k
    if name == "tp_clip":
        # the clip was active: its norm is over the logical leaves
        unclipped = _one(dict(case, grad_clip=0.0), trees)[0][0]
        assert any(not np.allclose(unclipped[k], one_leaves[0][k])
                   for k in grads)


@pytest.mark.parametrize("z1,plain", [("tp_full_z1", "tp_full"),
                                      ("dp_z1", "dp"),
                                      ("dp_z1_buckets", "dp"),
                                      ("dp_accum_z1", "dp_accum")])
def test_zero1_is_bit_equal_to_the_replicated_update(ranks, trees, z1,
                                                     plain):
    _, res = ranks
    (a, ra), (b, rb) = res[z1], res[plain]
    for i in range(CASES[z1]["steps"]):
        got, want = _step_leaves(a, i), _step_leaves(b, i)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert ra["metrics"] == rb["metrics"]
    # each rank holds the moments of its zero1_pspecs slices (the JAX
    # rule on the JAX tree), and fewer than the replicated layout
    case = CASES[z1]
    n_model, n_data = case["n_model"], 4 // case["n_model"]
    tree = flatten_tree(trees[case["tree"]])
    trained = set(_grads(a))
    specs = zero1_pspecs({k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                          for k, v in tree.items() if k in trained},
                         n_data, n_model)
    want_bytes = 0
    for k in trained:
        div = 1
        for ax in tuple(specs[k]):
            div *= {"data": n_data, "model": n_model, None: 1}[ax]
        want_bytes += 2 * tree[k].nbytes // div
    assert ra["moment_bytes"] == [want_bytes] * 4
    assert max(ra["moment_bytes"]) * 1.5 < max(rb["moment_bytes"])


def test_resume_written_under_2x2_zero1_resumes_one_process(ranks, trees):
    out, res = ranks
    npz, _ = res["tp_full_z1"]
    case = CASES["tp_full_z1"]
    pcfg = W.tiny_cfg(**FT)
    params = classifier.init_classifier_params(
        pcfg, torch.Generator().manual_seed(0), n_classes=W.N_CLS)
    params.load_state_dict(from_jax_params(trees["ft"]), strict=True)
    opt = Optimizer(pcfg, OptimConfig(lr=W.LR, clip_lr=W.CLIP_LR,
                                      total_steps=10, warmup_steps_pct=0.0),
                    params)
    ckpt = CheckpointManager(str(out / "tp_full_z1"), pcfg)
    assert ckpt.load_resume_state(params, opt) == 1 and opt.count == 1
    first = to_jax_flat(params.named_parameters())
    for k, v in _step_leaves(npz, 0).items():
        np.testing.assert_array_equal(first[k], v, err_msg=k)
    step = make_train_step(pcfg, params, opt, loss_weights={"ce_loss": 1.0})
    step({k: torch.from_numpy(v) for k, v in _batches(2)[1].items()})
    _assert_update(to_jax_flat(params.named_parameters()),
                   _step_leaves(npz, 1), flatten_tree(trees["ft"]),
                   _grads(npz), case["steps"], "resumed")


# -- the CLIs under two ranks ------------------------------------------------


def _ft_config(path):
    """configs/debug/fsclip_tiny_params.py turned into a tiny FT config:
    the whole ViT-T/8@32 tower and the prompts train, f32, remat."""
    src = open(os.path.join(W.ROOT, "configs", "debug",
                            "fsclip_tiny_params.py")).read()
    src += """

class EventCLIPParams(EventCLIPParams):
    model = 'FTCLIP'
    adapter_dict = dict(adapter_type='text-identity')
    max_epochs = 1
    lr = 1e-3
    clip_lr = 1e-3
    warmup_steps_pct = 0.0
    img_aug = False
    bf16 = False
    remat = True
    visualize = False
"""
    path.write_text(src)


def test_train_and_test_clis_under_two_ranks_equal_one_process(
        files, tmp_path, capsys, monkeypatch):  # noqa: F811
    from eventclip_tpu_torch.cli import test as cli_test
    from eventclip_tpu_torch.cli import train as cli_train

    tree, pt, _ = files
    cfg = tmp_path / "tiny_ft_params.py"
    _ft_config(cfg)
    common = ["--params", str(cfg), "--cpu", "--data_root", tree,
              "--clip_ckpt", pt]
    train = common + ["--san_check_val_step", "0", "--n_model", "2",
                      "--zero1"]

    def test_argv(base):
        return common + ["--weight", str(
            base / "tiny_ft_params" / "models" / "best.npz")]

    two = tmp_path / "two"
    outs = spawn_ranks("tests.torch_ddp_worker", ["clis", json.dumps([
        ["train", train + ["--ckpt_base", str(two)]],
        ["test", test_argv(two) + ["--n_model", "2"]]])],
        env_of=launch_env("jax"))
    for rank, (rc, log) in enumerate(outs):
        assert rc == 0, log
        # one data group: both model ranks load every row
        assert "SHARD 0 1" in log, log
    assert "mesh: devices=2 data=1 model=2" in outs[0][1]
    lines = _eval_lines(outs[0][1])
    assert lines and not _eval_lines(outs[1][1])

    one = tmp_path / "one"
    torch.set_num_threads(2)
    cli_train.main(common + ["--san_check_val_step", "0", "--ckpt_base",
                             str(one)])
    capsys.readouterr()
    cli_test.main(test_argv(one))
    assert _eval_lines(capsys.readouterr().out) == lines

    with np.load(two / "tiny_ft_params" / "models" / "best.npz") as z2, \
            np.load(one / "tiny_ft_params" / "models" / "best.npz") as z1:
        assert set(z2.files) == set(z1.files)
        steps = int(z1["__extra__/step"])
        assert steps == int(z2["__extra__/step"]) > 0
        for k in z1.files:
            # no gradients to tell noise-level elements by here: all but
            # a share SHARE of each leaf's elements (the key bias apart)
            # within ATOL, and every one within 2 lr a step
            diff = np.abs(z2[k] - z1[k])
            kb = key_bias(k, z1[k].shape)
            assert (diff <= 2e-3 * steps).all(), k
            assert (diff[~kb] > ATOL).mean() <= SHARE, k
    # the root test.py loads the checkpoint the two ranks wrote
    args = ref_args(REF_TEST, [a for a in test_argv(two) if a != "--cpu"],
                    monkeypatch)
    params, _ = REF_TEST.load_and_override(args)
    REF_TEST.evaluate(params, args, weight=args.weight)
    assert _eval_lines(capsys.readouterr().out) == lines


# -- what tensor parallelism refuses -------------------------------------------


def _fake_tp(n_model=2):
    """A context for one rank with no process group: the model-group sums
    are no-ops, so only the refusals are exercised."""
    from eventclip_tpu_torch.parallel.sharding import TPContext

    return TPContext(n_data=1, n_model=n_model, data_index=0, model_index=0)


def _tiny_visual():
    from eventclip_tpu_torch.models.clip.model import init_clip_params

    cfg = W.tiny_cfg(**FT)
    return init_clip_params(cfg.clip, torch.Generator().manual_seed(0)).visual


def test_heads_that_do_not_split_are_refused():
    from eventclip_tpu_torch.ops.attention import tp_fused_qkv_attention

    qkv = torch.zeros(1, 4, 3 * 64)
    with pytest.raises(AssertionError, match=r"\(2, 4\)"):
        tp_fused_qkv_attention(qkv, 2, _fake_tp(4))


def test_int8_and_pruning_under_tp_are_refused():
    from eventclip_tpu_torch.models.clip.model import encode_image
    from eventclip_tpu_torch.ops.quant import quantize_visual

    imgs = torch.zeros(2, 3, 32, 32)
    with pytest.raises(AssertionError, match="single-chip inference"):
        encode_image(_tiny_visual(), imgs, keep_tokens=4, tp=_fake_tp())
    q = quantize_visual(_tiny_visual())
    with pytest.raises(AssertionError, match="int8 quantization"):
        encode_image(q, imgs, tp=_fake_tp())


def test_a_world_that_n_model_does_not_divide_is_refused(files):  # noqa
    from eventclip_tpu_torch.cli import test as cli_test
    from eventclip_tpu_torch.parallel.sharding import make_mesh

    with pytest.raises(AssertionError, match=r"n_devices % n_model"):
        make_mesh(2)  # one process: a world of 1
    tree, pt, _ = files
    with pytest.raises(AssertionError, match="composes with data "
                       "parallelism only; drop --n_model"):
        cli_test.main(["--params", W.os.path.join(
            W.ROOT, "configs", "debug", "zsclip_tiny_params.py"), "--cpu",
            "--data_root", tree, "--clip_ckpt", pt, "--int8",
            "--n_model", "2"])
    with pytest.raises(AssertionError, match=r"n_devices % n_model"):
        cli_test.main(["--params", W.os.path.join(
            W.ROOT, "configs", "debug", "zsclip_tiny_params.py"), "--cpu",
            "--data_root", tree, "--clip_ckpt", pt, "--n_model", "2"])
