"""consolver_torch's FLUX DiT and T5 encoder against the JAX package, with the
JAX init (perturbed) carried across by ``load_jax_params``.

Tolerances, f32 on the CPU on both sides:
  * packing, ids and buckets are index shuffles: equal;
  * RoPE tables and the rotation: the same f32 sin/cos/multiply from two
    libraries, 1e-6 (ids up to 63, so arguments under 64 rad);
  * QKNorm / T5LayerNorm: 1e-6;
  * the tiny DiT: 2e-4.  Its guidance embedding takes ``guidance * 1000``,
    so at guidance 2.5 sin/cos see arguments up to 2500 rad, where one f32
    ulp of the argument is 2.4e-4; XLA and torch round those arguments'
    products differently, and two blocks of each kind carry that on
    (measured: 1.2e-5 at guidance 1, 3.5e-5 at 2.5, 1.1e-4 at 7.5, against
    outputs up to 5.7);
  * the tiny T5: 1e-5 (two blocks, f32 softmax with an additive bias).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consolver_torch.kernels.attention import xla_attention
from consolver_torch.models import flux as tflux
from consolver_torch.models import t5 as tt5
from consolver_torch.models.convert import load_jax_params
from consolver_tpu.kernels.attention import xla_attention as j_xla_attention
from consolver_tpu.models import flux as jflux
from consolver_tpu.models import t5 as jt5

DIT_TOL = dict(rtol=2e-4, atol=2e-4)
T5_TOL = dict(rtol=1e-5, atol=1e-5)


def _perturb(params, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + scale * rng.standard_normal(x.shape)).astype(np.float32), params
    )


@pytest.mark.parametrize("shape", [(2, 8, 8, 4), (1, 4, 6, 16), (1, 128, 128, 16)])
def test_pack_unpack_match(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    tp = tflux.pack_latents(torch.from_numpy(x))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jflux.pack_latents(jnp.asarray(x))))
    np.testing.assert_array_equal(tflux.unpack_latents(tp, shape[1], shape[2]).numpy(), x)


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_ids_and_rope_tables_match(offset):
    ids = tflux.latent_image_ids(128, 96, offset=offset)
    j_ids = jflux.latent_image_ids(128, 96, offset=offset)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    assert ids.shape == (64 * 48, 3) and float(ids[0, 0]) == offset
    all_ids = torch.cat([torch.zeros(7, 3), ids])
    for axes in ((16, 56, 56), (8, 8, 8)):
        t_cos, t_sin = tflux.rope_freqs(all_ids, axes)
        j_cos, j_sin = jflux.rope_freqs(jnp.asarray(all_ids.numpy()), axes)
        np.testing.assert_allclose(t_cos.numpy(), np.asarray(j_cos), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(t_sin.numpy(), np.asarray(j_sin), rtol=1e-6, atol=1e-6)


def test_apply_rope_and_qknorm_match():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 20, 3, 24)).astype(np.float32)
    ids = np.asarray(jflux.latent_image_ids(8, 10, offset=1.0))
    j_cos, j_sin = jflux.rope_freqs(jnp.asarray(ids), (8, 8, 8))
    t_cos, t_sin = tflux.rope_freqs(torch.from_numpy(ids), (8, 8, 8))
    np.testing.assert_allclose(
        tflux.apply_rope(torch.from_numpy(x), t_cos, t_sin).numpy(),
        np.asarray(jflux.apply_rope(jnp.asarray(x), j_cos, j_sin)), rtol=1e-6, atol=1e-6)
    jnorm = jflux.QKNorm()
    params = _perturb(jnorm.init(jax.random.key(0), jnp.asarray(x)), 2, 0.3)
    tnorm = load_jax_params(tflux.QKNorm(24), params)
    np.testing.assert_allclose(tnorm(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jnorm.apply(params, jnp.asarray(x))), rtol=1e-6, atol=1e-6)


def _tiny_dit_inputs(b=2, h=8, w=8, s_txt=4, guidance=2.5, kontext=True, seed=3):
    cfg = jflux.FluxConfig.tiny()
    rng = np.random.default_rng(seed)
    target = rng.standard_normal((b, (h // 2) * (w // 2), cfg.in_channels)).astype(np.float32)
    ids = np.asarray(jflux.latent_image_ids(h, w))
    if kontext:
        ref = rng.standard_normal(target.shape).astype(np.float32)
        target = np.concatenate([target, ref], axis=1)
        ids = np.concatenate([ids, np.asarray(jflux.latent_image_ids(h, w, offset=1.0))])
    txt = rng.standard_normal((b, s_txt, cfg.joint_text_dim)).astype(np.float32)
    pooled = rng.standard_normal((b, cfg.pooled_text_dim)).astype(np.float32)
    t = np.asarray([999.0, 350.5][:b], np.float32)
    g = np.full((b,), guidance, np.float32)
    return target, txt, pooled, t, g, ids.astype(np.float32), np.zeros((s_txt, 3), np.float32)


@pytest.fixture(scope="module")
def tiny_dit():
    cfg = jflux.FluxConfig.tiny()
    model = jflux.FluxTransformer(cfg)
    args = _tiny_dit_inputs()
    params = _perturb(jax.jit(model.init)(jax.random.key(0), *map(jnp.asarray, args)), 4)
    tmodel = load_jax_params(tflux.FluxTransformer(tflux.FluxConfig.tiny(), device="cpu"), params)
    return model, params, tmodel


@pytest.mark.parametrize("guidance,kontext", [(2.5, True), (2.5, False), (1.0, True), (7.5, True)])
def test_tiny_dit_matches_jax(tiny_dit, guidance, kontext):
    model, params, tmodel = tiny_dit
    args = _tiny_dit_inputs(guidance=guidance, kontext=kontext)
    ref = np.asarray(model.apply(params, *map(jnp.asarray, args)))
    with torch.no_grad():
        out = tmodel(*map(torch.from_numpy, args))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, **DIT_TOL)


def test_tiny_dit_blocks_match_jax(tiny_dit):
    """One double- and one single-stream block alone, at a fixed vec."""
    _, params, tmodel = tiny_dit
    cfg = jflux.FluxConfig.tiny()
    rng = np.random.default_rng(5)
    img = rng.standard_normal((2, 16, cfg.hidden_size)).astype(np.float32)
    txt = rng.standard_normal((2, 4, cfg.hidden_size)).astype(np.float32)
    vec = rng.standard_normal((2, cfg.hidden_size)).astype(np.float32)
    ids = np.concatenate([np.zeros((4, 3)), np.asarray(jflux.latent_image_ids(8, 8))]).astype(np.float32)
    j_cos, j_sin = jflux.rope_freqs(jnp.asarray(ids), cfg.axes_dims)
    t_cos, t_sin = tflux.rope_freqs(torch.from_numpy(ids), cfg.axes_dims)
    p = params["params"]
    j_img, j_txt = jflux.DoubleStreamBlock(cfg).apply(
        {"params": p["transformer_blocks_0"]}, *map(jnp.asarray, (img, txt, vec)), j_cos, j_sin)
    j_x = jflux.SingleStreamBlock(cfg).apply(
        {"params": p["single_transformer_blocks_1"]},
        jnp.concatenate([jnp.asarray(txt), jnp.asarray(img)], axis=1), jnp.asarray(vec), j_cos, j_sin)
    with torch.no_grad():
        t_img, t_txt = tmodel.transformer_blocks[0](*map(torch.from_numpy, (img, txt, vec)), t_cos, t_sin)
        t_x = tmodel.single_transformer_blocks[1](
            torch.from_numpy(np.concatenate([txt, img], axis=1)), torch.from_numpy(vec), t_cos, t_sin)
    for t, j in ((t_img, j_img), (t_txt, j_txt), (t_x, j_x)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2e-5, atol=2e-5)


def test_full_config_param_count():
    """Built on the meta device: 11.9 B parameters, as the JAX test counts."""
    model = tflux.FluxTransformer(tflux.FluxConfig.flux_kontext(), device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert 11.5e9 < n < 12.5e9, n
    assert tflux.FluxConfig.flux_kontext().head_dim == 128
    for mode, dtype in (("quant_int8", torch.int8), ("quant_int4", torch.uint8)):
        quantized = tflux.FluxTransformer(tflux.FluxConfig(**{mode: True}), device="meta")
        kernels = [b for b in quantized.buffers() if b.dtype == dtype]
        assert len(kernels) == 19 * 14 + 38 * 6, mode  # every stream-block projection


@pytest.mark.parametrize("qlen,klen", [(8, 8), (77, 77), (512, 512), (5, 300)])
def test_relative_position_buckets_match(qlen, klen):
    np.testing.assert_array_equal(tt5.relative_position_buckets(qlen, klen),
                                  jt5.relative_position_buckets(qlen, klen))


def test_biased_xla_attention_matches_jax():
    """T5's path: q pre-scaled by sqrt(d), standard scaling, additive bias."""
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((2, 10, 4, 8)).astype(np.float32) for _ in range(3))
    bias = rng.standard_normal((1, 4, 10, 10)).astype(np.float32)
    ref = np.asarray(jax.nn.dot_product_attention(*map(jnp.asarray, (q, k, v)), bias=jnp.asarray(bias)))
    out = xla_attention(*map(torch.from_numpy, (q, k, v)), bias=torch.from_numpy(bias))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        xla_attention(*map(torch.from_numpy, (q, k, v))).numpy(),
        np.asarray(j_xla_attention(*map(jnp.asarray, (q, k, v)))), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cfg_name,seq", [("tiny", 10), ("edit", 4)])
def test_tiny_t5_matches_jax(cfg_name, seq):
    kw = (dict(vocab_size=512, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4)
          if cfg_name == "tiny" else
          dict(vocab_size=64, d_model=32, d_kv=8, d_ff=64, num_layers=1, num_heads=4))
    enc = jt5.T5Encoder(jt5.T5Config(**kw))
    ids = np.random.default_rng(7).integers(0, kw["vocab_size"], (2, seq)).astype(np.int32)
    params = _perturb(jax.jit(enc.init)(jax.random.key(1), jnp.asarray(ids)), 8, 0.3)
    tenc = load_jax_params(tt5.T5Encoder(tt5.T5Config(**kw), device="cpu"), params)
    assert tt5.T5Config.tiny() == tt5.T5Config(**{f: getattr(jt5.T5Config.tiny(), f)
                                                   for f in ("vocab_size", "d_model", "d_kv", "d_ff",
                                                             "num_layers", "num_heads")})
    with torch.no_grad():
        out = tenc(torch.from_numpy(ids))
    np.testing.assert_allclose(out.numpy(), np.asarray(enc.apply(params, jnp.asarray(ids))), **T5_TOL)


def test_xxl_param_count():
    enc = tt5.T5Encoder(tt5.T5Config.xxl(), device="meta")
    n = sum(p.numel() for p in enc.parameters())
    assert 4.5e9 < n < 5.0e9, n


def _jax_param_count(module, *args):
    shapes = jax.eval_shape(module.init, jax.random.key(0), *args)
    return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))


@pytest.mark.parametrize("name", ["flux_kontext", "t5_xxl", "flux_vae"])
def test_full_size_parameter_counts_match_jax(name):
    """The full-width edit stack, built on the meta device, has exactly the
    JAX modules' parameter counts (from ``jax.eval_shape``, no weights)."""
    from consolver_torch.models.vae import AutoencoderKL as TVae
    from consolver_torch.models.vae import VaeConfig as TVaeConfig
    from consolver_tpu.models.vae import AutoencoderKL, VaeConfig

    f32 = jnp.float32
    if name == "flux_kontext":
        j = _jax_param_count(
            jflux.FluxTransformer(jflux.FluxConfig.flux_kontext()),
            jax.ShapeDtypeStruct((1, 16, 64), f32), jax.ShapeDtypeStruct((1, 8, 4096), f32),
            jax.ShapeDtypeStruct((1, 768), f32), jax.ShapeDtypeStruct((1,), f32),
            jax.ShapeDtypeStruct((1,), f32), jax.ShapeDtypeStruct((16, 3), f32),
            jax.ShapeDtypeStruct((8, 3), f32))
        model = tflux.FluxTransformer(tflux.FluxConfig.flux_kontext(), device="meta")
    elif name == "t5_xxl":
        j = _jax_param_count(jt5.T5Encoder(jt5.T5Config.xxl()),
                             jax.ShapeDtypeStruct((1, 16), jnp.int32))
        model = tt5.T5Encoder(tt5.T5Config.xxl(), device="meta")
    else:  # the 16-channel VAE as scripts/train_flux.py builds it
        j = _jax_param_count(AutoencoderKL(VaeConfig(latent_channels=16, scaling_factor=0.3611)),
                             jax.ShapeDtypeStruct((1, 16, 16, 3), f32), jax.random.key(1))
        model = TVae(TVaeConfig(latent_channels=16, scaling_factor=0.3611), device="meta")
    assert sum(p.numel() for p in model.parameters()) == j
