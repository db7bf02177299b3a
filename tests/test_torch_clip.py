"""The port's CLIP towers vs the JAX package's on ViT-T/8@32.

JAX-initialised parameters cross to the port through the weight bridge
(models/clip/convert.py); inputs are numpy. f32 is held to the JAX suite's
torch-oracle tolerance (tests/test_clip_model.py: rtol 2e-4, atol 2e-5).
bf16 features are held to 1.5% of the feature norm: both sides round
activations to bf16 at every matmul, add the f32 bias to the f32
accumulator and round once, but sum in different orders, so a one-ulp
difference now and then carries through the layers. bf16 `dense` alone is
held to the JAX one element by element (at most 1e-3 of the elements one
bf16 ulp apart); a bias rounded to bf16 before the add differs in about a
quarter of them.

The JAX init leaves every bias zero and every layer norm the identity, so
the crossed trees of `filled_towers` draw those at random first.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventclip_tpu.models.clip import model as ref_model
from eventclip_tpu.models.clip.config import clip_arch_config as ref_arch
from eventclip_tpu_torch.models.clip import model
from eventclip_tpu_torch.models.clip.config import clip_arch_config
from eventclip_tpu_torch.models.clip.convert import clip_from_jax, from_jax_params

ARCH = "ViT-T/8@32"


@pytest.fixture(scope="module")
def towers():
    tree = ref_model.init_clip_params(jax.random.PRNGKey(0), ref_arch(ARCH))
    tree = jax.tree_util.tree_map(np.asarray, tree)
    return tree, clip_from_jax(tree, clip_arch_config(ARCH), device="cpu")


def _fill_biases_and_norms(tree, rng):
    """Random biases and layer-norm scales / shifts (the init's are 0 / 1)."""
    def fill(path, a):
        key = getattr(path[-1], "key", None)
        if key in ("bias", "bqkv", "bo", "b1", "b2"):
            return (0.5 * rng.normal(size=a.shape)).astype(np.float32)
        if key == "scale":
            return (1 + 0.5 * rng.normal(size=a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(fill, tree)


@pytest.fixture(scope="module")
def filled_towers():
    tree = ref_model.init_clip_params(jax.random.PRNGKey(1), ref_arch(ARCH))
    tree = _fill_biases_and_norms(jax.tree_util.tree_map(np.asarray, tree),
                                  np.random.default_rng(5))
    return tree, clip_from_jax(tree, clip_arch_config(ARCH), device="cpu")


def _images(seed, B=5):
    return np.random.default_rng(seed).normal(
        size=(B, 3, 32, 32)).astype(np.float32)


def test_encode_image_f32_matches_jax(towers):
    tree, clip = towers
    x = _images(0)
    want = np.asarray(ref_model.encode_image(
        jax.tree_util.tree_map(jnp.asarray, tree["visual"]),
        ref_arch(ARCH).vision, jnp.asarray(x)))
    got = model.encode_image(clip.visual, torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (5, 32)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_encode_image_bf16_matches_jax(towers):
    tree, clip = towers
    x = _images(1)
    want = np.asarray(ref_model.encode_image(
        jax.tree_util.tree_map(jnp.asarray, tree["visual"]),
        ref_arch(ARCH).vision, jnp.asarray(x), dtype=jnp.bfloat16))
    got = model.encode_image(clip.visual, torch.from_numpy(x),
                             dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    err = np.linalg.norm(got.detach().numpy() - want, axis=-1)
    assert (err <= 1.5e-2 * np.linalg.norm(want, axis=-1)).all(), err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_image_with_biases_matches_jax(filled_towers, dtype):
    tree, clip = filled_towers
    x = _images(3, B=8)
    want = np.asarray(ref_model.encode_image(
        jax.tree_util.tree_map(jnp.asarray, tree["visual"]),
        ref_arch(ARCH).vision, jnp.asarray(x), dtype=jnp.dtype(dtype)))
    got = model.encode_image(clip.visual, torch.from_numpy(x),
                             dtype=getattr(torch, dtype)).detach().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    else:
        err = np.linalg.norm(got - want, axis=-1)
        assert (err <= 1.5e-2 * np.linalg.norm(want, axis=-1)).all(), err


def _prompts(rng, n):
    toks = np.zeros((n, 77), np.int64)
    for i in range(n):  # SOT, ids, EOT (the highest id), padding
        L = 3 + 4 * i
        toks[i, 0] = 49406
        toks[i, 1:L + 1] = rng.integers(1, 49406, L)
        toks[i, L + 1] = 49407
    return toks


def test_encode_text_with_biases_matches_jax(filled_towers):
    tree, clip = filled_towers
    toks = _prompts(np.random.default_rng(4), 6)
    want = np.asarray(ref_model.encode_text(
        jax.tree_util.tree_map(jnp.asarray, tree["text"]),
        ref_arch(ARCH).text, jnp.asarray(toks)))
    got = model.encode_text(clip.text, torch.from_numpy(toks)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_encode_text_matches_jax(towers):
    tree, clip = towers
    rng = np.random.default_rng(2)
    toks = np.zeros((6, 77), np.int64)
    for i in range(6):  # SOT, ids, EOT (the highest id), padding
        L = 3 + 4 * i
        toks[i, 0] = 49406
        toks[i, 1:L + 1] = rng.integers(1, 49406, L)
        toks[i, L + 1] = 49407
    want = np.asarray(ref_model.encode_text(
        jax.tree_util.tree_map(jnp.asarray, tree["text"]),
        ref_arch(ARCH).text, jnp.asarray(toks)))
    got = model.encode_text(clip.text, torch.from_numpy(toks)).detach().numpy()
    assert got.shape == want.shape == (6, 32)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_primitives_match_jax(rng):
    x = rng.normal(size=(3, 7, 16)).astype(np.float32)
    w = rng.normal(size=(24, 16)).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    np.testing.assert_allclose(
        model.dense(torch.from_numpy(x), torch.from_numpy(w),
                    torch.from_numpy(b)).numpy(),
        np.asarray(ref_model.dense(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b))), rtol=1e-5, atol=1e-5)
    ln = torch.nn.LayerNorm(16)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(b[:16]))
        ln.bias.copy_(torch.from_numpy(w[0]))
    np.testing.assert_allclose(
        model.layer_norm(torch.from_numpy(x), ln).detach().numpy(),
        np.asarray(ref_model.layer_norm(
            jnp.asarray(x), {"scale": jnp.asarray(b[:16]),
                             "bias": jnp.asarray(w[0])})),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        model.quick_gelu(torch.from_numpy(x)).numpy(),
        np.asarray(ref_model.quick_gelu(jnp.asarray(x))), rtol=1e-6,
        atol=1e-6)
    np.testing.assert_array_equal(model.causal_mask(5).numpy(),
                                  np.asarray(ref_model.causal_mask(5)))


def test_dense_bf16_matches_jax(rng):
    # biases much larger than the products: a bias rounded to bf16 before
    # the add would show in about a quarter of the outputs
    x = rng.normal(size=(4, 16, 48)).astype(np.float32)
    w = (0.02 * rng.normal(size=(96, 48))).astype(np.float32)
    b = rng.normal(size=(96,)).astype(np.float32)
    want = np.asarray(ref_model.dense(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(b)
    ).astype(jnp.float32))
    got = model.dense(torch.from_numpy(x).bfloat16(), torch.from_numpy(w),
                      torch.from_numpy(b))
    assert got.dtype == torch.bfloat16 and got.shape == (4, 16, 96)
    got = got.float().numpy()
    ulp = np.spacing(np.abs(want).astype(np.float32)) * 2 ** 16  # bf16 ulp
    assert (np.abs(got - want) <= ulp).all()
    assert (got != want).mean() <= 1e-3


def test_dense_bf16_grads_match_jax(rng):
    """jax.vjp of bf16 `dense` against the port's autograd: dx and dw are
    f32 sums of exact products rounded once to bf16 (held to one bf16 ulp,
    at most 1e-3 of the elements apart: the summation orders differ), db
    is an f32 column sum of bf16 values."""
    x = rng.normal(size=(4, 16, 48)).astype(np.float32)
    w = (0.02 * rng.normal(size=(96, 48))).astype(np.float32)
    b = rng.normal(size=(96,)).astype(np.float32)
    g = rng.normal(size=(4, 16, 96)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    _, vjp = jax.vjp(ref_model.dense, xb, jnp.asarray(w), jnp.asarray(b))
    want = [np.asarray(t.astype(jnp.float32))
            for t in vjp(jnp.asarray(g, jnp.bfloat16))]

    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    wt, bt = (torch.from_numpy(a).requires_grad_() for a in (w, b))
    model.dense(xt, wt, bt).backward(torch.from_numpy(g).bfloat16())
    assert xt.grad.dtype == torch.bfloat16 and wt.grad.dtype == torch.float32
    got = [t.grad.float().numpy() for t in (xt, wt, bt)]
    for name, a, e in zip(("dx", "dw"), got[:2], want[:2]):
        ulp = np.spacing(np.abs(e).astype(np.float32)) * 2 ** 16
        assert (np.abs(a - e) <= ulp).all(), name
        assert (a != e).mean() <= 1e-3, name
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6, atol=1e-5)


def test_encode_image_bf16_grads_match_jax(filled_towers, monkeypatch):
    """jax.vjp of the bf16 visual tower (attention through the Pallas
    kernels in interpret mode: K2 forward, K3 backward) against the port's
    autograd (plain K2/K3 on the CPU), every parameter and the images.

    bf16 tolerance: each leaf's gradient within 2% of its norm, cosine at
    least 0.9995; these inputs read at most 0.75% and 0.99997. Both sides
    round at the same places, but one-ulp differences of the forward's
    sums (see the module docstring) carry into every backward product."""
    monkeypatch.setattr(ref_model, "_use_pallas_attention",
                        lambda *a, **k: True)
    tree, clip = filled_towers
    cfg = ref_arch(ARCH).vision
    x = _images(6, B=4)
    g = np.random.default_rng(7).normal(size=(4, cfg.output_dim)).astype(
        np.float32)
    visual = jax.tree_util.tree_map(jnp.asarray, tree["visual"])
    _, vjp = jax.vjp(lambda p, im: ref_model.encode_image(
        p, cfg, im, dtype=jnp.bfloat16), visual, jnp.asarray(x))
    d_visual, d_x = vjp(jnp.asarray(g))
    want = from_jax_params({"visual": jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), d_visual)})

    clip.zero_grad(set_to_none=True)
    xt = torch.from_numpy(x).requires_grad_()
    model.encode_image(clip.visual, xt, dtype=torch.bfloat16).backward(
        torch.from_numpy(g))
    pairs = [("images", xt.grad.numpy(), np.asarray(d_x, np.float32))]
    pairs += [(n, p.grad.float().numpy(), want[n].numpy())
              for n, p in clip.named_parameters() if n.startswith("visual.")]
    clip.zero_grad(set_to_none=True)
    assert len(pairs) == 1 + len(want)
    for name, a, e in pairs:
        a, e = a.reshape(-1).astype(np.float64), e.reshape(-1)
        assert np.linalg.norm(a - e) <= 2e-2 * np.linalg.norm(e), name
        assert a @ e >= 0.9995 * np.linalg.norm(a) * np.linalg.norm(e), name


def test_bridge_covers_every_parameter(towers):
    tree, clip = towers
    state = from_jax_params(tree)
    assert set(state) == set(clip.state_dict())
    L = ref_arch(ARCH).vision.layers
    wqkv = tree["visual"]["blocks"]["attn"]["wqkv"]
    assert len(clip.visual.blocks.layers) == L
    np.testing.assert_array_equal(
        clip.visual.blocks.layers[1].attn.wqkv.detach().numpy(),
        wqkv[1].reshape(-1, wqkv.shape[-1]))


def test_random_init_matches_jax_shapes_and_scales():
    cfg = clip_arch_config(ARCH)
    a = model.init_clip_params(cfg, torch.Generator().manual_seed(0))
    b = model.init_clip_params(cfg, torch.Generator().manual_seed(0))
    ref = from_jax_params(jax.tree_util.tree_map(
        np.asarray, ref_model.init_clip_params(jax.random.PRNGKey(0),
                                               ref_arch(ARCH))))
    for name, t in a.state_dict().items():
        assert t.shape == ref[name].shape, name
        torch.testing.assert_close(t, b.state_dict()[name], rtol=0, atol=0)
        if t.numel() > 1000:  # same init scheme: matching spreads
            assert abs(float(t.std()) / float(ref[name].std()) - 1) < 0.1, name
