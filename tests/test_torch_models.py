"""consolver_torch.models (layers, UNet, CLIP text, VAE, weight conversion)
against the JAX package's flax modules with the same weights.

The JAX params come from the modules' own ``init`` with every leaf then
perturbed (so zero biases and unit norm scales are exercised too) and are
carried across with ``load_jax_params``.  Tolerances, f32 on the CPU:
single blocks 2e-5 (a few convs/matmuls summed in another order); whole
tiny models 1e-4 (the same through 20-40 layers, with GroupNorm dividing by
small variances).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consolver_torch.models import layers as tl
from consolver_torch.models.clip_text import ClipTextConfig as TClipConfig
from consolver_torch.models.clip_text import ClipTextEncoder as TClip
from consolver_torch.models.convert import load_jax_params, state_dict_from_jax
from consolver_torch.models.unet_2d import UNet2DCondition as TUNet
from consolver_torch.models.unet_2d import UNetConfig as TUNetConfig
from consolver_torch.models.vae import AutoencoderKL as TVae
from consolver_torch.models.vae import VaeConfig as TVaeConfig
from consolver_torch.models.vae import decode_latents as t_decode_latents
from consolver_tpu.models import convert as jconvert
from consolver_tpu.models import layers as jl
from consolver_tpu.models.clip_text import ClipTextConfig, ClipTextEncoder
from consolver_tpu.models.unet_2d import UNet2DCondition, UNetConfig
from consolver_tpu.models.vae import AutoencoderKL, VaeConfig, decode_latents

BLOCK_TOL = dict(rtol=2e-5, atol=2e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


def _perturb(params, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + scale * rng.standard_normal(x.shape)).astype(np.float32), params
    )


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1).detach().numpy()


def _carry(jmod, tmod, *jargs, seed=0):
    params = _perturb(jmod.init(jax.random.key(seed), *jargs), seed)
    return params, load_jax_params(tmod, params)


def test_timestep_embedding_matches():
    """sin/cos of arguments up to 999 rad: one f32 ulp of the argument is
    6e-5 there, and the two libraries' exp() may differ by an ulp, so 2e-4."""
    t = np.array([0, 1, 250, 999])
    np.testing.assert_allclose(
        tl.timestep_embedding(torch.from_numpy(t), 320).numpy(),
        np.asarray(jl.timestep_embedding(jnp.asarray(t), 320)),
        rtol=0, atol=2e-4,
    )


def _spatial_case(name, rng):
    """(flax module, torch module, flax args, torch args, output is NCHW)."""
    x = _rand(rng, 2, 8, 8, 8)
    tokens = _rand(rng, 2, 16, 16)
    ctx = _rand(rng, 2, 5, 12)
    if name == "resnet_temb":
        temb = _rand(rng, 2, 24)
        return (jl.ResnetBlock2D(16, groups=4), tl.ResnetBlock2D(8, 16, 4, temb_channels=24),
                (x, temb), (_nchw(x), torch.from_numpy(temb)), True)
    if name == "resnet_same":
        return (jl.ResnetBlock2D(8, groups=4), tl.ResnetBlock2D(8, 8, 4), (x,), (_nchw(x),), True)
    if name == "timestep_embedding":
        e = _rand(rng, 3, 32)
        return (jl.TimestepEmbedding(64), tl.TimestepEmbedding(32, 64), (e,), (torch.from_numpy(e),), False)
    if name == "self_attention":
        return (jl.Attention(2, 8), tl.Attention(16, 2, 8), (tokens,), (torch.from_numpy(tokens),), False)
    if name == "cross_attention":
        return (jl.Attention(2, 8, cross_dim=12), tl.Attention(16, 2, 8, cross_dim=12),
                (tokens, ctx), (torch.from_numpy(tokens), torch.from_numpy(ctx)), False)
    if name == "geglu":
        return (jl.GEGLU(24), tl.GEGLU(16, 24), (tokens,), (torch.from_numpy(tokens),), False)
    if name == "feed_forward":
        return (jl.FeedForward(16), tl.FeedForward(16), (tokens,), (torch.from_numpy(tokens),), False)
    if name == "transformer_block":
        return (jl.BasicTransformerBlock(2, 8, 12), tl.BasicTransformerBlock(16, 2, 8, 12),
                (tokens, ctx), (torch.from_numpy(tokens), torch.from_numpy(ctx)), False)
    if name == "transformer_2d":
        return (jl.Transformer2D(2, 4, 12, groups=4), tl.Transformer2D(8, 2, 4, 12, groups=4),
                (x, ctx), (_nchw(x), torch.from_numpy(ctx)), True)
    if name == "downsample":
        return (jl.Downsample2D(16), tl.Downsample2D(8, 16), (x,), (_nchw(x),), True)
    if name == "upsample":
        return (jl.Upsample2D(16), tl.Upsample2D(8, 16), (x,), (_nchw(x),), True)
    if name == "vae_attention":
        return (jl.VaeAttention(groups=4), tl.VaeAttention(8, groups=4), (x,), (_nchw(x),), True)
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "resnet_temb", "resnet_same", "timestep_embedding", "self_attention", "cross_attention",
    "geglu", "feed_forward", "transformer_block", "transformer_2d", "downsample", "upsample",
    "vae_attention",
])
def test_block_matches(name):
    rng = np.random.default_rng(len(name))
    jmod, tmod, jargs, targs, spatial = _spatial_case(name, rng)
    params, tmod = _carry(jmod, tmod, *jargs)
    ref = np.asarray(jmod.apply(params, *jargs))
    with torch.no_grad():
        out = tmod(*targs)
    out = _nhwc(out) if spatial else out.numpy()
    np.testing.assert_allclose(out, ref, **BLOCK_TOL)


def _tiny_unet(seed=0):
    cfg = UNetConfig.tiny()
    jmod = UNet2DCondition(cfg)
    params = jax.jit(jmod.init)(jax.random.key(seed), jnp.zeros((1, 8, 8, 4)),
                                jnp.zeros((1,), jnp.int32), jnp.zeros((1, 4, cfg.cross_attention_dim)))
    params = _perturb(params, seed)
    return jmod, params, load_jax_params(TUNet(TUNetConfig.tiny(), device="cpu"), params)


def _tiny_clip(seed=1):
    jmod = ClipTextEncoder(ClipTextConfig.tiny())
    params = _perturb(jax.jit(jmod.init)(jax.random.key(seed), jnp.zeros((1, 4), jnp.int32)), seed)
    return jmod, params, load_jax_params(TClip(TClipConfig.tiny(), device="cpu"), params)


def _tiny_vae(seed=2):
    jmod = AutoencoderKL(VaeConfig.tiny())
    params = jax.jit(jmod.init)(jax.random.key(seed), jnp.zeros((1, 16, 16, 3)), jax.random.key(9))
    params = _perturb(params, seed)
    return jmod, params, load_jax_params(TVae(TVaeConfig.tiny(), device="cpu"), params)


def test_tiny_unet_forward_matches():
    jmod, params, tmod = _tiny_unet()
    rng = np.random.default_rng(3)
    x, ctx = _rand(rng, 2, 16, 16, 4), _rand(rng, 2, 8, 32)
    t = np.array([999, 500])
    ref = np.asarray(jax.jit(jmod.apply)(params, x, t, ctx))
    with torch.no_grad():
        out = tmod(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx)).numpy()
    assert out.shape == (2, 16, 16, 4)
    np.testing.assert_allclose(out, ref, **MODEL_TOL)


def test_tiny_clip_forward_matches():
    jmod, params, tmod = _tiny_clip()
    ids = np.random.default_rng(4).integers(0, 1000, (2, 77))
    ref, ref_pooled = jmod.apply(params, ids, return_pooled=True)
    with torch.no_grad():
        out, pooled = tmod(torch.from_numpy(ids), return_pooled=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **MODEL_TOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(ref_pooled), **MODEL_TOL)


def test_tiny_vae_decode_and_encode_match():
    jmod, params, tmod = _tiny_vae()
    rng = np.random.default_rng(5)
    z = _rand(rng, 2, 8, 8, 4)
    ref = np.asarray(jax.jit(lambda p, z: jmod.apply(p, z, method=jmod.decode))(params, z))
    img = np.clip(_rand(rng, 2, 16, 16, 3), -1, 1)
    ref_mean, ref_logvar = jax.jit(lambda p, x: jmod.apply(p, x, method=jmod.encode))(params, img)
    with torch.no_grad():
        out = tmod.decode(torch.from_numpy(z)).numpy()
        mean, logvar = tmod.encode(torch.from_numpy(img))
        scaled = t_decode_latents(tmod, torch.from_numpy(z), chunk=1).numpy()
    np.testing.assert_allclose(out, ref, **MODEL_TOL)
    np.testing.assert_allclose(mean.numpy(), np.asarray(ref_mean), **MODEL_TOL)
    np.testing.assert_allclose(logvar.numpy(), np.asarray(ref_logvar), **MODEL_TOL)
    ref_scaled = np.asarray(decode_latents(jmod, params, jnp.asarray(z)))
    np.testing.assert_allclose(scaled, ref_scaled, **MODEL_TOL)


@pytest.mark.parametrize("kind", ["unet", "vae", "clip_text"])
def test_state_dict_names_convert_back_to_jax_tree(kind):
    """The JAX converters, given the port's state_dict, rebuild the JAX init
    tree exactly: the port's names are the diffusers/JAX names."""
    build, convert = {
        "unet": (_tiny_unet, jconvert.convert_unet),
        "vae": (_tiny_vae, jconvert.convert_vae),
        "clip_text": (_tiny_clip, jconvert.convert_clip_text),
    }[kind]
    _, params, tmod = build()
    back = convert(tmod.state_dict())["params"]
    jconvert.assert_tree_matches(back, params["params"])
    jax.tree.map(np.testing.assert_array_equal, back, jax.tree.map(np.asarray, params["params"]))
    # the forward walk and its inverse agree key for key
    assert len(state_dict_from_jax(params)) == len(tmod.state_dict())


def test_sd15_parameter_counts():
    """Same counts as the JAX package's SD-1.5 UNet and VAE tests."""
    def count(m):
        return sum(p.numel() for p in m.parameters())

    assert count(TUNet(TUNetConfig.sd15(), device="meta")) == 859_520_964
    assert count(TVae(TVaeConfig.sd15(), device="meta")) == 83_653_863


def test_quant_configs_raise():
    """The quantized configs build int8 layers (``tests/test_torch_quant.py``
    holds them against JAX); what the card's int8 GEMM cannot take raises
    when the weights are quantized."""
    import dataclasses

    from consolver_torch.kernels import quant as tq

    unet = TUNet(dataclasses.replace(TUNetConfig.tiny(), quant_int8=True), device="meta")
    vae = TVae(dataclasses.replace(TVaeConfig.tiny(), quant_int8=True), device="meta")
    assert isinstance(unet.mid_block.resnets[0].conv1, tq.Int8Conv2d)
    assert isinstance(vae.decoder.mid_block.attentions[0].to_q, tq.Int8Linear)
    assert isinstance(vae.encoder.mid_block.attentions[0].to_q, torch.nn.Linear)
    odd = dataclasses.replace(TUNetConfig.tiny(), block_out_channels=(36, 64), norm_num_groups=4)
    with pytest.raises(ValueError, match="multiples of 8"):
        tq.quantize_like(TUNet(dataclasses.replace(odd, quant_int8=True), device="meta"),
                         TUNet(odd, device="cpu"))
