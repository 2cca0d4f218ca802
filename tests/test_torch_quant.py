"""consolver_torch.kernels.quant (W8A8 int8, W4A16 int4) and the quantized
models and pipelines against the JAX package's ``consolver_tpu.kernels.quant``.

The activation quantization is held against the JITTED JAX functions (XLA
turns ``amax / 127`` into ``amax * f32(1/127)``), the weight quantization
against the eager ones that ``quantize_params_like`` calls (a true division).
Tolerances, f32 on the CPU:

  * weights, packed int4 bytes, group scales and quantized activations:
    bit-equal;
  * int8 / int4 layers: the int32 accumulators are exact on both sides and
    the dequantization repeats the JAX order of f32 operations, so the
    outputs hold 1e-6 relative (XLA may contract ``y * s + b`` into one
    fused multiply-add); the int4 and attention products are f32 matmuls
    summed in another order, 1e-5;
  * every quantized layer of a tiny quantized model, fed the input that
    layer received inside the jitted JAX model (captured with
    ``flax.linen.intercept_methods``): the JAX layer's output within 1e-6
    relative (int4: 1e-5);
  * whole tiny quantized models and pipelines: the float layers between
    the quantized ones differ by about 1e-6 between the two libraries, and
    such a difference can flip one activation's rounding, which moves that
    activation by a whole quantization step (1/127 of its row's or
    sample's largest magnitude); the tiny random models carry such flips
    on to a few percent of their output.  So the port's quantized output is
    held to differ from the JAX quantized output by less than quantization
    itself moves the JAX output (the JAX quantized model against the JAX
    float model, relative L2), and each layer is held tightly in place as
    above.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from consolver_torch.kernels import quant as tq
from consolver_torch.models import layers as tl
from consolver_torch.models.convert import _canonical, load_jax_params, state_dict_from_jax
from consolver_torch.models.flux import FluxConfig as TFluxConfig
from consolver_torch.models.flux import FluxTransformer as TFlux
from consolver_torch.models.unet_2d import UNet2DCondition as TUNet
from consolver_torch.models.unet_2d import UNetConfig as TUNetConfig
from consolver_torch.models.vae import AutoencoderKL as TVae
from consolver_torch.models.vae import VaeConfig as TVaeConfig
from consolver_tpu.kernels import quant as jq
from consolver_tpu.models.flux import FluxConfig, FluxTransformer
from consolver_tpu.models.unet_2d import UNet2DCondition, UNetConfig
from consolver_tpu.models.vae import AutoencoderKL, VaeConfig
from tests.test_torch_pipeline import _inputs as _sd_inputs
from tests.test_torch_pipeline import _pipelines as _sd_pipelines
from tests.test_torch_pipeline import stacks  # noqa: F401  (fixture)

LAYER_TOL = dict(rtol=1e-6, atol=1e-6)
MATMUL_TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _perturb(params, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + scale * rng.standard_normal(x.shape)).astype(np.float32), params
    )


def _t(x):
    return torch.from_numpy(np.asarray(x))


# --------------------------------------------------------------- weights


@pytest.mark.parametrize("shape", [(64, 32), (3, 3, 16, 24), (1, 1, 16, 8)])
def test_quantize_weight_matches_jax(shape):
    """Per-output-channel int8 of a dense kernel [in, out] or a HWIO conv
    kernel: bit-equal to JAX, and within half a step of each channel."""
    w = _rand(np.random.default_rng(0), *shape)
    jw, js = jq.quantize_weight(jnp.asarray(w))
    tw, ts = tq.quantize_weight(_t(w))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tw.dtype == torch.int8 and ts.shape == (shape[-1],)
    deq = tw.float().numpy() * ts.numpy()
    assert (np.abs(deq - w) <= 0.5 * ts.numpy() + 1e-7).all()


@pytest.mark.parametrize("shape,groups", [((384, 48), 3), ((64, 16), 1), ((256, 24), 2)])
def test_quantize_weight_int4_matches_jax(shape, groups):
    """Group-wise int4: packed bytes and group scales bit-equal to JAX (64
    input rows fall back to one group), each element within half a step of
    its group's scale."""
    w = _rand(np.random.default_rng(1), *shape)
    jp, js = jq.quantize_weight_int4(jnp.asarray(w))
    tp, ts = tq.quantize_weight_int4(_t(w))
    assert tp.dtype == torch.uint8 and tp.shape == (shape[0] // 2, shape[1])
    assert ts.shape == (groups, shape[1])
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    deq = tq.dequantize_int4(tp, ts).numpy()
    np.testing.assert_array_equal(deq, np.asarray(jq.dequantize_int4(jp, js)))
    err = np.abs(deq - w).reshape(groups, shape[0] // groups, shape[1])
    assert (err <= 0.5 * ts.numpy()[:, None, :] + 1e-6).all()


def test_int4_pack_unpack_roundtrip():
    w4 = np.random.default_rng(0).integers(-8, 8, size=(256, 40)).astype(np.int8)
    packed = tq.pack_int4(_t(w4))
    assert packed.dtype == torch.uint8 and packed.shape == (128, 40)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jq.pack_int4(jnp.asarray(w4))))
    np.testing.assert_array_equal(tq.unpack_int4(packed).numpy(), w4)


def test_int4_rejects_odd_and_non_2d():
    with pytest.raises(ValueError, match="even"):
        tq.quantize_weight_int4(torch.ones(5, 4))
    with pytest.raises(ValueError, match="2-D"):
        tq.quantize_weight_int4(torch.ones(2, 4, 4))


# ------------------------------------------------------------ activations


@pytest.mark.parametrize("per_token,shape", [(True, (64, 48)), (True, (2, 5, 16)),
                                             (False, (3, 6, 6, 8))])
def test_quantized_activations_match_jitted_jax(per_token, shape):
    rng = np.random.default_rng(2)
    x = _rand(rng, *shape) * rng.uniform(0.01, 10.0, shape[:1] + (1,) * (len(shape) - 1))
    x = x.astype(np.float32)
    jx, js = jax.jit(jq._quantize_act, static_argnums=1)(jnp.asarray(x), per_token)
    tx, ts = tq._quantize_act(_t(x), per_token)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_int_mm_reference_is_exact():
    """The plain version's f64 products of int8 values are exact at the
    widest main-path contraction (a 3x3 conv over 2560 channels)."""
    rng = np.random.default_rng(3)
    a = rng.integers(-127, 128, (4, 9 * 2560)).astype(np.int8)
    b = rng.integers(-127, 128, (8, 9 * 2560)).astype(np.int8)
    want = a.astype(np.int64) @ b.astype(np.int64).T
    got = tq.int_mm(_t(a), _t(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# ----------------------------------------------------------------- layers


@pytest.mark.parametrize("bias", [True, False])
def test_int8_dense_matches_jax(bias):
    rng = np.random.default_rng(4)
    x = _rand(rng, 2, 7, 64)
    w = _rand(rng, 64, 32, scale=0.1)
    b = _rand(rng, 32, scale=0.1) if bias else None
    jw, js = jq.quantize_weight(jnp.asarray(w))
    want = jax.jit(jq.int8_dense)(jnp.asarray(x), jw, js, None if b is None else jnp.asarray(b))
    got = tq.int8_dense(_t(x), _t(np.asarray(jw).T.copy()), _t(js), None if b is None else _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    ref = x @ w + (0 if b is None else b)
    assert np.abs(got.numpy() - ref).max() < 0.05 * np.abs(ref).max()


CONV_CASES = {
    "same_3x3": dict(shape=(2, 8, 8, 16), k=3, strides=(1, 1), padding="SAME"),
    "int_pad_3x3": dict(shape=(2, 8, 8, 16), k=3, strides=(1, 1), padding=1),
    "downsample_valid_s2": dict(shape=(2, 9, 9, 16), k=3, strides=(2, 2), padding="VALID"),
    "same_s2": dict(shape=(1, 9, 7, 8), k=3, strides=(2, 2), padding="SAME"),
    "pointwise": dict(shape=(2, 6, 6, 40), k=1, strides=(1, 1), padding="SAME"),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_int8_conv_matches_jax(case):
    """NHWC int8 conv against the jitted JAX one WITH its 128-lane channel
    padding (the port pads nothing: zero channels add nothing) and without;
    the downsample case pads (0, 1) first, as ``Downsample2D`` does."""
    c = CONV_CASES[case]
    rng = np.random.default_rng(5)
    x = _rand(rng, *c["shape"])
    if case.startswith("downsample"):
        x = np.pad(x, ((0, 0), (0, 1), (0, 1), (0, 0)))
    w = _rand(rng, c["k"], c["k"], c["shape"][-1], 24, scale=0.1)
    b = _rand(rng, 24, scale=0.1)
    jw, js = jq.quantize_weight(jnp.asarray(w))
    kw = dict(strides=c["strides"], padding=c["padding"])
    got = tq.int8_conv(_t(x), _t(np.asarray(jw).transpose(3, 0, 1, 2).copy()), _t(js), _t(b), **kw)
    for channel_pad in (128, 0):
        want = jax.jit(lambda *a: jq.int8_conv(*a, channel_pad=channel_pad, **kw))(
            jnp.asarray(x), jw, js, jnp.asarray(b))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


def test_int8_conv_im2col_chunks_change_nothing(monkeypatch):
    """The im2col runs in sample chunks when it would be large; integer sums
    make the chunking exact."""
    rng = np.random.default_rng(6)
    x = _t(_rand(rng, 5, 6, 6, 8))
    w, s = tq.quantize_weight(_t(_rand(rng, 8, 3, 3, 8)), out_axis=0)
    whole = tq.int8_conv(x, w, s, padding=1)
    monkeypatch.setattr(tq, "IM2COL_BYTES", 1)
    np.testing.assert_array_equal(tq.int8_conv(x, w, s, padding=1).numpy(), whole.numpy())


def test_int4_dense_matches_jax():
    rng = np.random.default_rng(7)
    w = _rand(rng, 256, 24)
    b = _rand(rng, 24)
    x = _rand(rng, 4, 256)
    jp, js = jq.quantize_weight_int4(jnp.asarray(w))
    want = jax.jit(jq.int4_dense)(jnp.asarray(x), jp, js, jnp.asarray(b))
    got = tq.int4_dense(_t(x), _t(jp), _t(js), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MATMUL_TOL)
    ref = x @ w + b
    assert np.linalg.norm(got.numpy() - ref) / np.linalg.norm(ref) < 0.15


def test_int8_attention_matches_jax():
    rng = np.random.default_rng(8)
    q, k, v = (_rand(rng, 2, 64, 4, 40) for _ in range(3))
    want = jax.jit(jq.int8_attention)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = tq.int8_attention(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MATMUL_TOL)


def test_quantized_modules_match_functional():
    """The modules quantized from float layers by ``quantize_like`` give the
    functional results, and stay close to the float layers."""
    torch.manual_seed(0)
    linear, conv = torch.nn.Linear(16, 8), torch.nn.Conv2d(8, 16, 3, stride=2)
    x = torch.randn(4, 16)
    xc = torch.randn(2, 8, 7, 7)
    qlin = tq.quantize_like(tq.Int8Linear(16, 8), linear)
    qconv = tq.quantize_like(tq.Int8Conv2d(8, 16, 3, stride=2), conv)
    q4 = tq.quantize_like(tq.Int4Linear(16, 8), linear)
    with torch.no_grad():
        np.testing.assert_array_equal(
            qlin(x).numpy(), tq.int8_dense(x, qlin.kernel, qlin.kernel_scale, qlin.bias).numpy())
        np.testing.assert_array_equal(
            qconv(xc).numpy(),
            tq.int8_conv(xc.permute(0, 2, 3, 1), qconv.kernel, qconv.kernel_scale, qconv.bias,
                         strides=(2, 2), padding=0).permute(0, 3, 1, 2).numpy())
        np.testing.assert_array_equal(
            q4(x).numpy(), tq.int4_dense(x, q4.kernel_packed, q4.kernel_scale, q4.bias).numpy())
        for got, want in ((qlin(x), linear(x)), (qconv(xc), conv(xc)), (q4(x), linear(x))):
            assert got.shape == want.shape
            assert (got - want).abs().max() < 0.1 * want.abs().max()


def test_batch_composition_independence():
    """A sample's quantized output is a pure function of its own inputs,
    bit-equal solo and beside a large-magnitude batch-mate (the serving
    determinism contract: no scale reduces over the batch)."""
    gen = torch.Generator().manual_seed(11)
    x0 = torch.randn((1, 8, 8, 16), generator=gen)
    big = 50.0 * torch.randn((1, 8, 8, 16), generator=gen)
    kq, ks = tq.quantize_weight(torch.randn((16, 3, 3, 16), generator=gen), out_axis=0)
    solo = tq.int8_conv(x0, kq, ks)
    np.testing.assert_array_equal(solo.numpy(), tq.int8_conv(torch.cat([x0, big]), kq, ks)[:1].numpy())

    xd0 = torch.randn((1, 6, 16), generator=gen)
    xd_big = 50.0 * torch.randn((1, 6, 16), generator=gen)
    dq, ds = tq.quantize_weight(torch.randn((8, 16), generator=gen), out_axis=0)
    np.testing.assert_array_equal(tq.int8_dense(xd0, dq, ds).numpy(),
                                  tq.int8_dense(torch.cat([xd0, xd_big]), dq, ds)[:1].numpy())

    q, k, v = (torch.randn((1, 4, 2, 8), generator=gen) for _ in range(3))
    bigs = [50.0 * torch.randn((1, 4, 2, 8), generator=gen) for _ in range(3)]
    mixed = tq.int8_attention(*(torch.cat([a, b]) for a, b in zip((q, k, v), bigs)))[:1]
    np.testing.assert_array_equal(tq.int8_attention(q, k, v).numpy(), mixed.numpy())


def test_card_shape_rules_checked_at_quantize_time():
    """cuBLASLt's int8 GEMM takes K and N in multiples of 8: a layer outside
    that raises when it is quantized, not in the step loop."""
    with pytest.raises(ValueError, match="multiples of 8"):
        tq.quantize_like(tq.Int8Linear(12, 8), torch.nn.Linear(12, 8))
    with pytest.raises(ValueError, match="multiples of 8"):
        tq.quantize_like(tq.Int8Conv2d(8, 12, 3), torch.nn.Conv2d(8, 12, 3))


# ---------------------------------------------------------- whole models


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / (np.linalg.norm(np.asarray(b)) + 1e-8))


def _within_quant_noise(got, want, jax_float):
    """The port's quantized output is nearer the JAX quantized output than
    quantization moves the JAX output from the float one."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert _rel(got, want) < _rel(want, jax_float), (_rel(got, want), _rel(want, jax_float))


JAX_QUANT_LAYERS = (jq.Int8Dense, jq.Int8Conv, jq.Int4Dense)


def _jax_layer_calls(model, params, *args, method=None):
    """(path, input, output) of every quantized layer call inside the jitted
    JAX model."""
    names = []

    def run(params, *args):
        calls = []

        def record(next_fun, a, kw, context):
            out = next_fun(*a, **kw)
            if isinstance(context.module, JAX_QUANT_LAYERS) and context.method_name == "__call__":
                calls.append((".".join(context.module.path), a[0], out))
            return out

        with nn.intercept_methods(record):
            model.apply(params, *args, method=method)
        names[:] = [c[0] for c in calls]
        return [c[1] for c in calls], [c[2] for c in calls]

    ins, outs = jax.jit(run)(params, *args)
    return list(zip(names, ins, outs))


def _check_layers_in_place(tmodel, calls, tol):
    """Every quantized layer of the port model, fed its JAX input, gives the
    JAX output; every one of them was called."""
    layers = {_canonical(n): m for n, m in tmodel.named_modules()
              if isinstance(m, tq.QUANTIZED_LAYERS)}
    assert layers and set(layers) == {name for name, _, _ in calls}
    for name, x, want in calls:
        layer, x = layers[name], _t(np.array(x))
        with torch.no_grad():
            if isinstance(layer, tq.Int8Conv2d):
                got = layer(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            else:
                got = layer(x)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=name,
                                   atol=tol * float(np.abs(want).max()), rtol=0)


def _check_port_quantizes_like_jax(tmodel_q_cfg, tfloat, jq_tree, build):
    """The port's own ``quantize_like`` of its float model gives every
    quantized tensor of JAX ``quantize_params_like``, bit for bit, and
    copies the rest."""
    own = tq.quantize_like(build(tmodel_q_cfg, device="meta"), tfloat).state_dict()
    carried = state_dict_from_jax(jq_tree)
    loaded = load_jax_params(build(tmodel_q_cfg, device="cpu"), jq_tree).state_dict()
    assert set(own) == set(loaded)
    n_int = 0
    for key, value in own.items():
        assert value.dtype == loaded[key].dtype, key
        assert torch.equal(value, loaded[key]), key
        n_int += value.dtype in (torch.int8, torch.uint8)
    assert n_int > 0 and any(v.dtype in (np.int8, np.uint8) for v in map(np.asarray, carried.values()))
    return own


def _unet_trees(skip):
    cfg = UNetConfig.tiny()
    x = jax.random.normal(jax.random.key(0), (2, 8, 8, 4))
    t = jnp.asarray([10, 500], jnp.int32)
    ctx = jax.random.normal(jax.random.key(1), (2, 4, cfg.cross_attention_dim))
    unet = UNet2DCondition(cfg)
    params = _perturb(jax.jit(unet.init)(jax.random.key(2), x, t, ctx), 3)
    qcfg = dataclasses.replace(cfg, quant_int8=True, quant_skip_levels=skip)
    qunet = UNet2DCondition(qcfg)
    qparams = jq.quantize_params_like(jax.eval_shape(qunet.init, jax.random.key(2), x, t, ctx),
                                      params)
    return (unet, params), (qunet, qparams), (x, t, ctx)


@pytest.mark.parametrize("skip", [(), (0,)])
def test_quantized_unet_matches_jax(skip):
    """The tiny UNet, uniform int8 and the level-0-float hybrid: the JAX
    quantized tree carried across by ``convert.py`` gives JAX's output; the
    port quantizes its float UNet to the same tree; the output stays close
    to the float UNet's, the hybrid at least as close as uniform int8."""
    (unet, params), (qunet, qparams), (x, t, ctx) = _unet_trees(skip)
    tcfg = dataclasses.replace(TUNetConfig.tiny(), quant_int8=True, quant_skip_levels=skip)
    tfloat = load_jax_params(TUNet(TUNetConfig.tiny(), device="cpu"), params)
    _check_port_quantizes_like_jax(tcfg, tfloat, qparams, TUNet)
    tquant = load_jax_params(TUNet(tcfg, device="cpu"), qparams)
    targs = (_t(x), _t(t).long(), _t(ctx))
    with torch.no_grad():
        got = tquant(*targs).numpy()
        float_out = tfloat(*targs).numpy()
    want = jax.jit(qunet.apply)(qparams, x, t, ctx)
    _within_quant_noise(got, want, jax.jit(unet.apply)(params, x, t, ctx))
    _check_layers_in_place(tquant, _jax_layer_calls(qunet, qparams, x, t, ctx), 1e-6)
    assert _rel(got, float_out) < 0.10
    # level 0 float under the hybrid, every level int8 otherwise
    kinds = {name: type(m) for name, m in tquant.named_modules()}
    level0 = [n for n in kinds if n.startswith(("down_blocks.0.", "up_blocks.1."))]
    assert any(kinds[n] is tq.Int8Conv2d for n in kinds if n.startswith("down_blocks.1."))
    assert any(kinds[n] is tq.Int8Linear for n in kinds if n.startswith("mid_block."))
    assert all(kinds[n] not in tq.QUANTIZED_LAYERS for n in level0) == (skip == (0,))
    assert isinstance(tquant.conv_in, torch.nn.Conv2d)
    assert isinstance(tquant.down_blocks[1].resnets[0].time_emb_proj, torch.nn.Linear)


def test_hybrid_no_worse_than_uniform():
    """Mirror of the JAX hybrid test: keeping level 0 float is at least as
    close to the float UNet as uniform int8."""
    rels = []
    for skip in ((0,), ()):
        (_, params), (_, qparams), (x, t, ctx) = _unet_trees(skip)
        tcfg = dataclasses.replace(TUNetConfig.tiny(), quant_int8=True, quant_skip_levels=skip)
        tfloat = load_jax_params(TUNet(TUNetConfig.tiny(), device="cpu"), params)
        tquant = tq.quantize_like(TUNet(tcfg, device="meta"), tfloat)
        targs = (_t(x), _t(t).long(), _t(ctx))
        with torch.no_grad():
            rels.append(_rel(tquant(*targs), tfloat(*targs)))
    assert rels[0] <= rels[1] + 1e-6, rels


def test_quantized_vae_decoder_matches_jax():
    """int8 decoder (mid block and up blocks), float encoder: JAX's output,
    the port's own quantization of the float VAE equals JAX's tree."""
    cfg = VaeConfig.tiny()
    vae = AutoencoderKL(cfg)
    params = _perturb(jax.jit(vae.init)(jax.random.key(1), jnp.zeros((1, 16, 16, 3)),
                                        jax.random.key(2)), 4)
    qvae = AutoencoderKL(dataclasses.replace(cfg, quant_int8=True))
    qparams = jq.quantize_params_like(
        jax.eval_shape(qvae.init, jax.random.key(1), jnp.zeros((1, 16, 16, 3)), jax.random.key(2)),
        params)
    tcfg = dataclasses.replace(TVaeConfig.tiny(), quant_int8=True)
    tfloat = load_jax_params(TVae(TVaeConfig.tiny(), device="cpu"), params)
    own = _check_port_quantizes_like_jax(tcfg, tfloat, qparams, TVae)
    assert not any(k.startswith("encoder.") and v.dtype == torch.int8 for k, v in own.items())
    assert any(k.startswith("decoder.up_blocks.") and v.dtype == torch.int8 for k, v in own.items())
    tquant = load_jax_params(TVae(tcfg, device="cpu"), qparams)
    z = jax.random.normal(jax.random.key(0), (2, 8, 8, cfg.latent_channels))
    want = jax.jit(lambda p, z: qvae.apply(p, z, method=qvae.decode))(qparams, z)
    with torch.no_grad():
        got = tquant.decode(_t(z)).numpy()
        float_out = tfloat.decode(_t(z)).numpy()
    _within_quant_noise(got, want, jax.jit(lambda p, z: vae.apply(p, z, method=vae.decode))(params, z))
    calls = _jax_layer_calls(qvae, qparams, z, method=qvae.decode)
    _check_layers_in_place(tquant.decoder, [(n.removeprefix("decoder."), a, o) for n, a, o in calls],
                           1e-6)
    assert _rel(got, float_out) < 0.10


@pytest.mark.parametrize("mode,rel_to_float", [("quant_int8", 0.10), ("quant_int4", 0.20)])
def test_quantized_flux_matches_jax(mode, rel_to_float):
    """The tiny DiT with int8 or int4 stream-block projections: JAX's
    output, the port's own quantization equals JAX's tree (int4: packed
    uint8 kernels at half the rows), close to the float DiT."""
    cfg = FluxConfig.tiny()
    model = FluxTransformer(cfg)
    b, s_img, s_txt = 1, 8, 4
    keys = jax.random.split(jax.random.key(0), 3)
    args = (jax.random.normal(keys[0], (b, s_img, cfg.in_channels)),
            jax.random.normal(keys[1], (b, s_txt, cfg.joint_text_dim)),
            jax.random.normal(keys[2], (b, cfg.pooled_text_dim)),
            jnp.ones((b,)), jnp.ones((b,)), jnp.zeros((s_img, 3)), jnp.zeros((s_txt, 3)))
    params = jax.jit(model.init)(jax.random.key(3), *args)  # the JAX test's weights
    qmodel = FluxTransformer(dataclasses.replace(cfg, **{mode: True}))
    qparams = jq.quantize_params_like(jax.eval_shape(qmodel.init, jax.random.key(3), *args), params)
    tcfg = dataclasses.replace(TFluxConfig.tiny(), **{mode: True})
    tfloat = load_jax_params(TFlux(TFluxConfig.tiny(), device="cpu"), params)
    own = _check_port_quantizes_like_jax(tcfg, tfloat, qparams, TFlux)
    want_kind = torch.uint8 if mode == "quant_int4" else torch.int8
    assert any(v.dtype == want_kind for v in own.values())
    assert "x_embedder.weight" in own and "proj_out.weight" in own
    tquant = load_jax_params(TFlux(tcfg, device="cpu"), qparams)
    targs = tuple(map(_t, args))
    with torch.no_grad():
        got = tquant(*targs).numpy()
        float_out = tfloat(*targs).numpy()
    _within_quant_noise(got, jax.jit(qmodel.apply)(qparams, *args),
                        jax.jit(model.apply)(params, *args))
    _check_layers_in_place(tquant, _jax_layer_calls(qmodel, qparams, *args),
                           1e-5 if mode == "quant_int4" else 1e-6)
    assert _rel(got, float_out) < rel_to_float


def test_full_size_quantized_dit_bytes():
    """On the meta device: the 11.9 B-parameter DiT's bytes under int8 and
    int4 (the float embedders and final layers stay bf16)."""
    kontext = TFluxConfig.flux_kontext()
    sizes = {}
    for mode in ("quant_int8", "quant_int4"):
        sizes[mode] = tq.module_bytes(TFlux(dataclasses.replace(kontext, **{mode: True}),
                                            device="meta", dtype=torch.bfloat16))
    bf16 = tq.module_bytes(TFlux(kontext, device="meta", dtype=torch.bfloat16))
    assert 23e9 < bf16 < 25e9
    assert 11.5e9 < sizes["quant_int8"] < 12.5e9, sizes
    assert 5.9e9 < sizes["quant_int4"] < 6.6e9, sizes


def test_quantized_model_keeps_scales_f32_under_a_dtype():
    """Building a quantized model in bf16 casts its float layers only: the
    integer kernels, scales and biases keep their dtypes."""
    model = TUNet(dataclasses.replace(TUNetConfig.tiny(), quant_int8=True), device="cpu",
                  dtype=torch.bfloat16)
    layer = model.mid_block.resnets[0].conv1
    assert isinstance(layer, tq.Int8Conv2d)
    assert layer.kernel.dtype == torch.int8
    assert layer.kernel_scale.dtype == layer.bias.dtype == torch.float32
    assert model.mid_block.resnets[0].norm1.weight.dtype == torch.bfloat16
    assert model.conv_in.weight.dtype == torch.bfloat16


# ---------------------------------------------------- slot-invariant route


@pytest.mark.parametrize("stride,padding,size", [(1, 1, 8), (2, 0, 9), (1, 0, 6)])
def test_slot_invariant_conv_matches_conv(stride, padding, size):
    torch.manual_seed(0)
    conv = torch.nn.Conv2d(8, 16, 3, stride=stride, padding=padding)
    x = torch.randn(3, 8, size, size)
    with torch.no_grad():
        np.testing.assert_allclose(tl.slot_invariant_conv(conv, x).numpy(), conv(x).numpy(),
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- pipelines


SD_FNET = dict(order_dim=2, scaler_dim=0, num_actions=11)


def test_t2i_quantize_matches_jax(stacks):  # noqa: F811
    """``quantize()`` of the SD pipeline (hybrid): the same images as the
    JAX quantized pipeline, close to the float pipeline (mirror of the JAX
    test), shared pieces, an empty denoise cache, the float pipeline
    untouched."""
    jpipe, tpipe = _sd_pipelines(stacks, SD_FNET)
    ids, noise = _sd_inputs()
    float_before = {k: v.clone() for k, v in tpipe.unet.state_dict().items()}
    tpipe.denoise_fn(3, 3.0, deterministic_policy=True)  # a cached program
    qpipe = tpipe.quantize()
    assert qpipe is not tpipe and not qpipe.programs and tpipe.programs
    for name in ("text_encoder", "factor_net", "schedule", "tokenizer", "timestep_spacing",
                 "steps_offset", "device"):
        assert getattr(qpipe, name) is getattr(tpipe, name), name
    assert qpipe.unet.cfg.quant_int8 and qpipe.unet.cfg.quant_skip_levels == (0,)
    assert qpipe.vae.cfg.quant_int8 and not tpipe.unet.cfg.quant_int8
    assert all(torch.equal(v, tpipe.unet.state_dict()[k]) for k, v in float_before.items())
    assert isinstance(tpipe.unet.mid_block.resnets[0].conv1, torch.nn.Conv2d)

    kwargs = dict(num_inference_steps=3, deterministic_policy=True)
    jq_pipe = jpipe.quantize()
    j_img, _ = jq_pipe(jax.random.key(0), jnp.asarray(ids), jnp.asarray(noise), **kwargs)
    jf_img, _ = jpipe(jax.random.key(0), jnp.asarray(ids), jnp.asarray(noise), **kwargs)
    t_img, _ = qpipe(None, ids, noise, **kwargs)
    _within_quant_noise(t_img.numpy(), j_img, jf_img)
    f_img, _ = tpipe(None, ids, noise, **kwargs)
    assert float(((t_img - f_img) ** 2).mean()) < 1e-3
    u_img, _ = tpipe.quantize(skip_levels=())(None, ids, noise, **kwargs)
    assert u_img.shape == t_img.shape and not torch.equal(u_img, t_img)


def _edit_pipes():
    from tests.test_torch_edit import pipes

    return pipes.__wrapped__()


@pytest.mark.parametrize("bits", [8, 4])
def test_edit_quantize_matches_jax(bits):
    """``quantize(bits)`` of the FLUX-Kontext pipeline: the JAX quantized
    pipeline's latents, close to the float pipeline's, shared encoders and
    policy, an empty cache, the float pipeline untouched; int4 halves the
    DiT's quantized kernel bytes."""
    from tests.test_torch_edit import _inputs as edit_inputs

    jpipe, tpipe = _edit_pipes()
    qpipe = tpipe.quantize(bits)
    for name in ("t5", "clip", "factor_net", "fm_config", "vae_scaling_factor",
                 "vae_shift_factor", "device"):
        assert getattr(qpipe, name) is getattr(tpipe, name), name
    assert not qpipe.programs and qpipe.vae.cfg.quant_int8
    assert qpipe.transformer.cfg.quant_mode == ("int4" if bits == 4 else True)
    assert not tpipe.transformer.cfg.quant_int8 and not tpipe.transformer.cfg.quant_int4
    kwargs = dict(num_inference_steps=2, solver="euler", decode=False)
    args = edit_inputs()
    j_out, _ = jpipe.quantize(bits=bits)(jax.random.key(4), *map(jnp.asarray, args), **kwargs)
    jf_out, _ = jpipe(jax.random.key(4), *map(jnp.asarray, args), **kwargs)
    t_out, _ = qpipe(None, *args, **kwargs)
    _within_quant_noise(t_out.numpy(), j_out, jf_out)
    f_out, _ = tpipe(None, *args, **kwargs)
    assert _rel(t_out, f_out) < (0.25 if bits == 4 else 0.15)
    if bits == 4:
        b8 = sum(v.numel() for k, v in tpipe.quantize(8).transformer.state_dict().items()
                 if k.endswith(".kernel"))
        b4 = sum(v.numel() for k, v in qpipe.transformer.state_dict().items()
                 if k.endswith(".kernel_packed"))
        assert 0 < b4 <= b8 / 2


def test_edit_quantize_rejects_other_bits():
    _, tpipe = _edit_pipes()
    with pytest.raises(ValueError, match="bits"):
        tpipe.quantize(bits=3)


# ------------------------------------------------- serving and training


def _policy_pipeline():
    from tests.test_torch_serve import SD_POLICY, _sd_pipeline
    from consolver_torch.policy.factor_net import FactorNet

    torch.manual_seed(3)
    return _sd_pipeline(FactorNet(SD_POLICY, device="cpu"), seed=1)


def test_engine_over_a_quantized_pipeline():
    """An ``InferenceEngine`` serves the int8 pipeline: a deterministic
    request is bit-equal solo and at slot 2 of a full batch, and a hot
    reload applies (a new net, an empty cache, the int8 models kept)."""
    from consolver_torch.serve import GenerationRequest, InferenceEngine

    qpipe = _policy_pipeline().quantize()
    eng = InferenceEngine(qpipe, batch_size=4, latent_size=8, flush_ms=150.0)

    def req(i):
        return GenerationRequest(prompt=f"prompt {i}", seed=100 + i, num_inference_steps=3,
                                 deterministic=True)

    try:
        solo = eng.generate(req(0), timeout=300)
        futs = [eng.submit(req(i)) for i in (10, 11, 0, 13)]
        packed = [f.result(timeout=300) for f in futs]
        np.testing.assert_array_equal(solo, packed[2])
        gen = torch.Generator().manual_seed(5)
        state = {k: torch.randn(v.shape, generator=gen) * 0.3
                 for k, v in qpipe.factor_net.state_dict().items()}
        eng.update_factor_params(state)
        assert eng.pipeline is not qpipe and eng.pipeline.unet is qpipe.unet
        assert eng.pipeline.factor_net is not qpipe.factor_net
        after = eng.generate(req(0), timeout=300)
        assert after.shape == solo.shape and not np.array_equal(after, solo)
    finally:
        eng.shutdown()


def test_ppo_step_over_a_quantized_rollout():
    """The JAX ``quantize_rollout`` environment: float teacher latents, the
    rollout through the int8 pipeline, only the FactorNet trained."""
    from consolver_torch.rewards.registry import make_reward_fn
    from consolver_torch.rl import ppo as tppo
    from consolver_torch.rl import train as ttrain

    qpipe = _policy_pipeline().quantize()
    unet_before = {k: v.clone() for k, v in qpipe.unet.state_dict().items()}
    net_before = [p.detach().clone() for p in qpipe.factor_net.parameters()]
    config = ttrain.TrainConfig(min_inference_steps=2, max_inference_steps=4, seed=0,
                                output_dir="unused", ppo=tppo.PPOConfig(ppo_epochs=1,
                                                                        learning_rate=1e-2))
    trainer = ttrain.PPOTrainer(qpipe, make_reward_fn("image_psnr"), config)
    rng = np.random.default_rng(0)
    batch = {"noise": rng.standard_normal((4, 8, 8, 4)).astype(np.float32),
             "latent": rng.standard_normal((4, 8, 8, 4)).astype(np.float32),
             "prompt_ids": rng.integers(1, 50, (4, 4)).astype(np.int64)}
    metrics = trainer.train_step(batch)
    assert all(np.isfinite(metrics[k]) for k in ("loss", "reward", "grad_norm"))
    assert not all(torch.equal(a, b) for a, b in zip(net_before, qpipe.factor_net.parameters()))
    assert all(torch.equal(v, qpipe.unet.state_dict()[k]) for k, v in unet_before.items())


def test_deterministic_programs_take_the_slot_invariant_route(monkeypatch):
    """A deterministic program runs the UNet's 3x3 convolutions below the top
    level one sample at a time; a sampled program and a zoo solver keep the
    batched convolutions."""
    pipe = _policy_pipeline()
    calls = []
    real = tl.slot_invariant_conv
    monkeypatch.setattr(tl, "slot_invariant_conv",
                        lambda conv, x: calls.append(tuple(x.shape)) or real(conv, x))
    ids = torch.ones((2, 77), dtype=torch.long)
    noise = torch.randn((2, 8, 8, 4), generator=torch.Generator().manual_seed(0))
    pipe(torch.Generator().manual_seed(0), ids, noise, num_inference_steps=2, decode=False)
    pipe(None, ids, noise, num_inference_steps=2, decode=False, solver="ddim")
    assert calls == []
    pipe(None, ids, noise, num_inference_steps=2, decode=False, deterministic_policy=True)
    pipe(None, ids, noise, num_inference_steps=2, decode=False, deterministic_policy=True,
         padded_max_steps=3)
    assert calls and all(shape[0] == 4 for shape in calls)  # CFG rows
