"""The port's ZS and FS heads, Predictor and build_model vs the JAX
package's.

The JAX Predictor's own random towers and text features cross to the port
(as numpy), and the same raw streams go through both. With the
`bf16=False` override the probabilities agree to atol 1e-5 with the same
labels and top-k; under the default bf16 visual tower they agree to atol
2e-2 (both sides round activations to bf16 at every matmul, at slightly
different places). Streams: short (one view), multi-view, and longer than
the 10-view budget (content-seeded subsampling), packed and padded steps,
TTA off and on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventclip_tpu.models import classifier as ref_cls
from eventclip_tpu.models.clip.config import clip_arch_config as ref_arch
from eventclip_tpu.models.clip.model import init_clip_params as ref_init
from eventclip_tpu.serve import Predictor as RefPredictor
from eventclip_tpu.utils.config import load_params as ref_load_params
from eventclip_tpu_torch.models import classifier
from eventclip_tpu_torch.models.clip.config import clip_arch_config
from eventclip_tpu_torch.models.clip.convert import clip_from_jax
from eventclip_tpu_torch.serve import Predictor
from eventclip_tpu_torch.utils.config import load_params

CONFIG = "configs/debug/zsclip_tiny_params.py"
NAMES = ["airplanes", "ant", "brain", "camera", "dolphin"]
ARCH = "ViT-T/8@32"


def _streams(seed):
    rng = np.random.default_rng(seed)
    out = []
    for n in (600, 2800, 4100, 13700, 900, 2000):  # 1 .. >10 views of 1000
        out.append(np.stack([
            rng.integers(0, 240, n), rng.integers(0, 180, n),
            np.sort(rng.uniform(0, 0.3, n)), rng.choice([-1.0, 1.0], n),
        ], axis=1).astype(np.float32))
    out[4][:, 3] = (out[4][:, 3] > 0)  # a 0/1-polarity dump
    return out


def _pair(bf16, **kw):
    ref_params = ref_load_params(CONFIG)
    ref_params.bf16 = bf16
    ref = RefPredictor(ref_params, NAMES, smoke=True, batch_size=4, **kw)
    tree = jax.tree_util.tree_map(np.asarray, ref._params["clip"])
    params = load_params(CONFIG)
    params.bf16 = bf16
    port = Predictor(params, NAMES, clip_params=tree,
                     text_feats=np.asarray(ref._params["text_feats"]),
                     batch_size=4, device="cpu", **kw)
    return ref, port


@pytest.fixture(scope="module")
def f32_pair():
    return _pair(False)


@pytest.mark.parametrize("tta", [False, True])
def test_predictor_matches_jax_f32(f32_pair, tta):
    ref, port = f32_pair
    ref.tta = port.tta = tta
    try:
        streams = _streams(0)
        want = ref.predict(streams, top_k=3)
        got = port.predict(streams, top_k=3)
    finally:
        ref.tta = port.tta = False
    assert got["probs"].shape == (len(streams), len(NAMES))
    np.testing.assert_allclose(got["probs"], want["probs"], atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(got["label"], want["label"])
    np.testing.assert_array_equal(got["topk"], want["topk"])
    assert got["names"] == want["names"]


def test_padded_step_matches_jax_f32(f32_pair):
    ref, _ = f32_pair
    params = load_params(CONFIG)
    params.bf16 = False
    port = Predictor(params, NAMES,
                     clip_params=jax.tree_util.tree_map(np.asarray,
                                                        ref._params["clip"]),
                     text_feats=np.asarray(ref._params["text_feats"]),
                     batch_size=4, device="cpu", pack_views=False)
    streams = _streams(1)
    got = port.predict(streams, top_k=2)
    want = ref.predict(streams, top_k=2)
    np.testing.assert_allclose(got["probs"], want["probs"], atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(got["topk"], want["topk"])


def test_predictor_matches_jax_bf16():
    ref, port = _pair(True)
    streams = _streams(2)
    want = ref.predict(streams)
    got = port.predict(streams)
    np.testing.assert_allclose(got["probs"], want["probs"], atol=2e-2,
                               rtol=0)


def test_windows_equal_jax(f32_pair):
    ref, port = f32_pair
    for tta in (False, True):
        ref.tta = port.tta = tta
        try:
            got = port.gather_windows(_streams(3))
            want = ref.gather_windows(_streams(3))
        finally:
            ref.tta = port.tta = False
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert (port.window, port.views) == (ref.window, ref.views)
    assert port._buckets == ref._buckets


@pytest.fixture(scope="module")
def head_inputs():
    cfg = ref_arch(ARCH)
    tree = jax.tree_util.tree_map(np.asarray, ref_init(jax.random.PRNGKey(3),
                                                       cfg))
    rng = np.random.default_rng(4)
    tf = rng.normal(size=(7, cfg.embed_dim)).astype(np.float32)
    tf /= np.linalg.norm(tf, axis=-1, keepdims=True)
    B, T = 3, 4
    imgs = rng.normal(size=(B, T, 3, 32, 32)).astype(np.float32)
    valid = np.array([[1, 1, 0, 0], [1, 1, 1, 1], [0, 0, 0, 0]], bool)
    ref_params = {"clip": jax.tree_util.tree_map(jnp.asarray, tree),
                  "text_feats": jnp.asarray(tf)}
    port_params = classifier.ClassifierParams(
        clip_from_jax(tree, clip_arch_config(ARCH), "cpu"),
        torch.from_numpy(tf))
    return ref_params, port_params, imgs, valid


def _configs(agg):
    class P:
        model = "ZSCLIP"
        clip_dict = dict(arch=ARCH, agg_func=agg)

        def get(self, k, d=None):
            return getattr(self, k, d)

    return (ref_cls.build_classifier_config(P(), ref_arch(ARCH)),
            classifier.build_classifier_config(P(), clip_arch_config(ARCH)))


def _compare(got, want):
    for k in ("full_logits", "logits", "probs", "view_feats"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=2e-4, atol=2e-5, equal_nan=True,
                                   err_msg=k)


@pytest.mark.parametrize("agg", ["mean", "sum", "max"])
def test_classifier_forward_matches_jax(head_inputs, agg):
    ref_params, port_params, imgs, valid = head_inputs
    ref_cfg, cfg = _configs(agg)
    want = ref_cls.classifier_forward(ref_params, ref_cfg, jnp.asarray(imgs),
                                      jnp.asarray(valid))
    got = classifier.classifier_forward(port_params, cfg,
                                        torch.from_numpy(imgs),
                                        torch.from_numpy(valid))
    _compare(got, want)
    assert np.isnan(got["probs"][2].numpy()).all()  # no valid view: 0/0


def test_classifier_forward_packed_matches_jax(head_inputs):
    ref_params, port_params, imgs, valid = head_inputs
    ref_cfg, cfg = _configs("mean")
    B, T = valid.shape
    idx = np.flatnonzero(valid.reshape(-1))
    K = 8
    packed = np.zeros((K,) + imgs.shape[2:], np.float32)
    packed[: len(idx)] = imgs.reshape((B * T,) + imgs.shape[2:])[idx]
    src = np.full(K, B * T, np.int32)
    src[: len(idx)] = idx
    want = ref_cls.classifier_forward_packed(
        ref_params, ref_cfg, jnp.asarray(packed), jnp.asarray(src),
        jnp.asarray(valid))
    got = classifier.classifier_forward_packed(
        port_params, cfg, torch.from_numpy(packed), torch.from_numpy(src),
        torch.from_numpy(valid))
    _compare(got, want)


def _fs_configs():
    class P:
        model = "FSCLIP"
        clip_dict = dict(arch=ARCH, agg_func="mean")
        adapter_dict = dict(adapter_type="text-trans", d_model=16,
                            num_heads=2, ffn_dim=64, num_layers=2,
                            residual=0.8)

        def get(self, k, d=None):
            return getattr(self, k, d)

    return (ref_cls.build_classifier_config(P(), ref_arch(ARCH)),
            classifier.build_classifier_config(P(), clip_arch_config(ARCH)))


@pytest.fixture(scope="module")
def fs_inputs(head_inputs):
    """head_inputs' towers and text features plus a JAX-drawn adapter
    (biases random, so each leaf matters), in both packages."""
    from eventclip_tpu.models.adapter import init_adapter_params
    from eventclip_tpu_torch.models.adapter import Adapter
    from eventclip_tpu_torch.models.clip.convert import from_jax_params

    ref_params, port_params, imgs, valid = head_inputs
    ref_cfg, cfg = _fs_configs()
    rng = np.random.default_rng(6)
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(
            np.float32),
        init_adapter_params(jax.random.PRNGKey(5), ref_cfg.adapter))
    adapter = Adapter(cfg.adapter)
    adapter.load_state_dict({k[len("adapter."):]: v for k, v in
                             from_jax_params({"adapter": tree}).items()})
    ref = dict(ref_params, adapter=jax.tree_util.tree_map(jnp.asarray, tree))
    port = classifier.ClassifierParams(port_params.clip,
                                       port_params.text_feats.detach(),
                                       adapter=adapter)
    return ref, port, imgs, valid


def test_fs_classifier_forward_matches_jax(fs_inputs):
    """The FS head (adapter -> normalize -> mask, prompts re-normalized),
    padded: a row with no valid view is NaN in both."""
    ref_params, port_params, imgs, valid = fs_inputs
    ref_cfg, cfg = _fs_configs()
    want = ref_cls.classifier_forward(ref_params, ref_cfg, jnp.asarray(imgs),
                                      jnp.asarray(valid))
    with torch.no_grad():
        got = classifier.classifier_forward(port_params, cfg,
                                            torch.from_numpy(imgs),
                                            torch.from_numpy(valid))
    _compare(got, want)
    assert np.isnan(got["probs"][2].numpy()).all()


def test_fs_classifier_forward_packed_matches_jax(fs_inputs):
    ref_params, port_params, imgs, valid = fs_inputs
    ref_cfg, cfg = _fs_configs()
    B, T = valid.shape
    idx = np.flatnonzero(valid.reshape(-1))
    K = 8
    packed = np.zeros((K,) + imgs.shape[2:], np.float32)
    packed[: len(idx)] = imgs.reshape((B * T,) + imgs.shape[2:])[idx]
    src = np.full(K, B * T, np.int32)
    src[: len(idx)] = idx
    want = ref_cls.classifier_forward_packed(
        ref_params, ref_cfg, jnp.asarray(packed), jnp.asarray(src),
        jnp.asarray(valid))
    with torch.no_grad():
        got = classifier.classifier_forward_packed(
            port_params, cfg, torch.from_numpy(packed),
            torch.from_numpy(src), torch.from_numpy(valid))
    _compare(got, want)


def test_unknown_heads_raise():
    class P:
        model = "XXCLIP"
        clip_dict = dict(arch=ARCH)

        def get(self, k, d=None):
            return getattr(self, k, d)

    for build, arch in ((ref_cls.build_classifier_config, ref_arch),
                        (classifier.build_classifier_config,
                         clip_arch_config)):
        with pytest.raises(AssertionError):
            build(P(), arch(ARCH))


@pytest.mark.parametrize("config", [CONFIG,
                                    "configs/debug/fsclip_tiny_params.py"])
def test_build_model_matches_jax(head_inputs, tmp_path, config):
    """build_model from the same towers and text features in both
    packages; for FS the adapter and prompts come from a checkpoint the
    JAX package saved, through EventCLIPModel.load_weight."""
    from eventclip_tpu.engine.checkpoint import save_trainable
    from eventclip_tpu.models.factory import build_model as ref_build
    from eventclip_tpu_torch.models.factory import build_model

    ref_params, _, imgs, valid = head_inputs
    tree = jax.tree_util.tree_map(np.asarray, ref_params["clip"])
    tf = np.array(ref_params["text_feats"])
    names = [f"c{i}" for i in range(tf.shape[0])]
    ref = ref_build(ref_load_params(config), names, clip_params=ref_params[
        "clip"], text_feats=ref_params["text_feats"], dtype=jnp.float32)
    port = build_model(load_params(config), names, clip_params=tree,
                       text_feats=tf, dtype=torch.float32, device="cpu")
    assert port.cfg.model == ref.cfg.model
    if port.cfg.model == "FSCLIP":
        path = str(tmp_path / "best.npz")
        save_trainable(path, ref.cfg, ref.params)
        port.load_weight(path)
    want = ref({"img": jnp.asarray(imgs), "valid_mask": jnp.asarray(valid)})
    got = port({"img": torch.from_numpy(imgs),
                "valid_mask": torch.from_numpy(valid)})
    _compare(got, want)


def test_build_model_text_features_rule(head_inputs, monkeypatch,
                                        tmp_path):
    """Pretrained towers without text features and without the BPE vocab
    raise; random towers draw both, on the device asked for."""
    from eventclip_tpu_torch.models.clip import tokenizer
    from eventclip_tpu_torch.models.factory import build_model

    monkeypatch.setenv("EVENTCLIP_BPE_PATH", str(tmp_path / "none.txt.gz"))
    monkeypatch.setattr(tokenizer, "DEFAULT_BPE_PATHS", ())
    ref_params = head_inputs[0]
    tree = jax.tree_util.tree_map(np.asarray, ref_params["clip"])
    params = load_params(CONFIG)
    with pytest.raises(FileNotFoundError, match="BPE vocab"):
        build_model(params, NAMES, clip_params=tree, device="cpu")
    model = build_model(params, NAMES, device="cpu",
                        generator=torch.Generator().manual_seed(1))
    tf = model.params.text_feats
    assert tuple(tf.shape) == (len(NAMES), model.cfg.clip.embed_dim)
    torch.testing.assert_close(tf.norm(dim=-1), torch.ones(len(NAMES)))
    assert model.cfg.dtype == torch.bfloat16  # the JAX factory's default


def test_build_model_and_predictor_tokenize_like_jax(head_inputs,
                                                     monkeypatch, tmp_path):
    """With the vocab (a synthetic merge table on EVENTCLIP_BPE_PATH) and
    no text features, build_model and Predictor compute them from the
    config's prompt, to the JAX build_model's / Predictor's features
    (rtol 2e-4, atol 2e-5)."""
    import gzip

    from eventclip_tpu.models.factory import build_model as ref_build_model
    from eventclip_tpu_torch.models.factory import build_model

    from .test_tokenizer import MERGES

    vocab = tmp_path / "bpe.txt.gz"
    with gzip.open(vocab, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\n"
                + "\n".join(" ".join(m) for m in MERGES) + "\n")
    monkeypatch.setenv("EVENTCLIP_BPE_PATH", str(vocab))
    tree = jax.tree_util.tree_map(np.asarray, head_inputs[0]["clip"])
    want = np.asarray(ref_build_model(ref_load_params(CONFIG), NAMES,
                                      clip_params=tree).params["text_feats"])
    got = build_model(load_params(CONFIG), NAMES, clip_params=tree,
                      device="cpu").params.text_feats.detach().numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    pred = Predictor(load_params(CONFIG), NAMES, clip_params=tree,
                     device="cpu")
    np.testing.assert_allclose(pred._params.text_feats.detach().numpy(),
                               want, rtol=2e-4, atol=2e-5)
