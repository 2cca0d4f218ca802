"""The reward and eval backbones of consolver_torch (the resize helper,
DINOv2 / CLIP ViTs, Depth-Anything, SegFormer, InceptionV3, and the
rewards built on them) against the JAX package's, with the same weights.

Weights go both ways: the JAX modules' own ``init``, perturbed so that zero
biases and unit scales are exercised, carried into the port with
``load_jax_params``; and the port's own ``state_dict`` (transformers /
torchvision key names) carried into JAX by the JAX package's converters
(``convert_dinov2``, ``convert_depth_anything``, ...).  BatchNorm variances
are drawn positive.  Tolerances, f32 on the CPU: the resize helper 1e-6 on
images in [0, 1] (the weight matrices equal JAX's within an ulp; the
contraction order differs); tiny models and rewards 1e-4.  A SegFormer mask
must equal JAX's wherever JAX's top two logits differ by more than 1e-5.
Full-width parameter counts are taken on ``meta`` against JAX's
``eval_shape``.  A third oracle: tiny random transformers checkpoints load
into the port with ``load_state_dict`` and agree with transformers' outputs
at the JAX parity tests' tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consolver_torch.models import depth_anything as tda
from consolver_torch.models import inception as tinc
from consolver_torch.models import segformer as tseg
from consolver_torch.models import vit as tvit
from consolver_torch.models.convert import jax_path, load_jax_params
from consolver_torch.rewards import registry as treg
from consolver_torch.utils import resize as tresize
from consolver_tpu.models import depth_anything as jda
from consolver_tpu.models import inception as jinc
from consolver_tpu.models import segformer as jseg
from consolver_tpu.models import vit as jvit
from consolver_tpu.models.convert import assert_tree_matches
from consolver_tpu.rewards import registry as jreg

RESIZE_TOL = dict(rtol=0, atol=1e-6)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)

CLIP_TINY = dict(image_size=28, patch_size=14, hidden_size=32, num_layers=2, num_heads=2,
                 layerscale=False, quick_gelu=True, pre_norm_embed=True, patch_bias=False,
                 projection_dim=16, ln_eps=1e-5)


def _perturb(params, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + scale * rng.standard_normal(x.shape)).astype(np.float32), params
    )


def _positive_var(params):
    """BatchNorm variances |v| + 0.5 (a perturbed var near 1 stays positive,
    but make it sure)."""
    def fix(path, v):
        return np.abs(v) + 0.5 if path[-1].key in ("var", "bn_var") else v

    return jax.tree_util.tree_map_with_path(fix, params)


def _images(seed, *shape):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _port_weights(module, seed):
    """Perturb every parameter and BatchNorm statistic of a port module (the
    running variances kept positive)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            if t.is_floating_point():
                t.add_(0.05 * torch.randn(t.shape, generator=gen))
                if name.endswith("running_var"):
                    t.abs_().add_(0.5)
    return module


def _tiny_vit(kind):
    return jvit.ViTConfig.tiny() if kind == "dino" else jvit.ViTConfig(**CLIP_TINY)


def _port_config(cls, jcfg):
    fields = {f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__}
    if "backbone" in fields:
        fields["backbone"] = _port_config(tvit.ViTConfig, jcfg.backbone)
    return cls(**fields)


def _vit_pair(kind, seed=1):
    jcfg = _tiny_vit(kind)
    jmodel = jvit.ViT(jcfg)
    params = _perturb(jmodel.init(jax.random.key(0), jnp.zeros((1, 28, 28, 3))), seed)
    return jmodel, params, load_jax_params(tvit.ViT(_port_config(tvit.ViTConfig, jcfg),
                                                    device="cpu"), params)


@pytest.fixture(scope="module")
def depth_pair():
    jcfg = jda.DepthAnythingConfig.tiny()
    jmodel = jda.DepthAnything(jcfg)
    params = _perturb(jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((1, 28, 28, 3))), 2)
    tmodel = tda.DepthAnything(_port_config(tda.DepthAnythingConfig, jcfg), device="cpu")
    return jmodel, params, load_jax_params(tmodel, params)


@pytest.fixture(scope="module")
def segformer_pair():
    jmodel = jseg.Segformer(jseg.SegformerConfig.tiny())
    params = _positive_var(_perturb(jax.jit(jmodel.init)(jax.random.key(0),
                                                         jnp.zeros((1, 32, 32, 3))), 3))
    tmodel = tseg.Segformer(_port_config(tseg.SegformerConfig, jseg.SegformerConfig.tiny()),
                            device="cpu")
    return jmodel, params, load_jax_params(tmodel, params)


@pytest.fixture(scope="module")
def inception_pair():
    """The port's InceptionV3 (1000 classes; its seeded init, perturbed) and
    the JAX tree ``convert_inception`` makes of its state dict."""
    torch.manual_seed(4)
    tmodel = _port_weights(tinc.InceptionV3(num_classes=1000, device="cpu"), 5)
    params = jinc.convert_inception(tmodel.state_dict(), keep_fc=True)
    return jinc.InceptionV3(num_classes=1000), params, tmodel


# -- the resize helper ------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 34, 46, 3), (2, 9, 11, 3), (2, 7, 40, 3), (2, 17, 23, 3)],
                         ids=["up", "down", "mixed", "same"])
@pytest.mark.parametrize("method", ["linear", "cubic"])
@pytest.mark.parametrize("antialias", [True, False], ids=["aa", "no_aa"])
def test_resize_matches_jax(shape, method, antialias):
    x = _images(0, 2, 17, 23, 3)
    want = np.asarray(jax.image.resize(x, shape, method, antialias=antialias))
    got = tresize.resize(torch.from_numpy(x), shape, method, antialias).numpy()
    np.testing.assert_allclose(got, want, **RESIZE_TOL)
    if shape == x.shape:
        np.testing.assert_array_equal(got, x)


def test_weight_matrices_match_jax():
    """Each axis's weights equal ``compute_weight_mat``'s within a float32
    ulp (a column sum in another order)."""
    from jax._src.image import scale as jscale

    kernels = {"linear": jscale._fill_triangle_kernel, "cubic": jscale._fill_keys_cubic_kernel}
    for n_in, n_out in [(512, 518), (1024, 224), (17, 9)]:
        for method, kernel in kernels.items():
            want = np.asarray(jscale.compute_weight_mat(n_in, n_out, n_out / n_in, 0.0, kernel,
                                                        True))
            got = tresize.weight_matrix(n_in, n_out, float(np.float32(n_in / n_out)), 0.0,
                                        method, True)
            np.testing.assert_allclose(got, want, rtol=0, atol=1.2e-7)


def test_bicubic_is_not_torch_interpolate():
    """The trap the helper exists for: torch's bicubic (a = -0.75) is
    another function than JAX's Keys cubic (a = -0.5)."""
    x = _images(1, 1, 16, 16, 3)
    want = np.asarray(jax.image.resize(x, (1, 24, 24, 3), "cubic"))
    torch_bicubic = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), size=(24, 24), mode="bicubic",
        align_corners=False).permute(0, 2, 3, 1).numpy()
    assert np.abs(torch_bicubic - want).max() > 1e-3
    np.testing.assert_allclose(tresize.resize(torch.from_numpy(x), (1, 24, 24, 3), "cubic").numpy(),
                               want, **RESIZE_TOL)


@pytest.mark.parametrize("size", [(34, 46), (5, 6), (37, 19), (17, 23)])
def test_resize_align_corners_matches_jax(size):
    x = _images(2, 2, 17, 23, 3)
    want = np.asarray(jda.resize_align_corners(jnp.asarray(x), size))
    got = tresize.resize_align_corners(torch.from_numpy(x), size).numpy()
    np.testing.assert_allclose(got, want, **RESIZE_TOL)
    nchw = tresize.resize_align_corners(torch.from_numpy(x).permute(0, 3, 1, 2), size, axes=(2, 3))
    np.testing.assert_allclose(nchw.permute(0, 2, 3, 1).numpy(), want, **RESIZE_TOL)


# -- ViT (DINOv2, CLIP) -------------------------------------------------------


@pytest.mark.parametrize("kind", ["dino", "clip"])
def test_vit_hidden_and_features_match_jax(kind):
    jmodel, params, tmodel = _vit_pair(kind)
    x = _normal(3, 2, 28, 28, 3)
    for features in (False, True):
        want = np.asarray(jmodel.apply(params, x, return_features=features))
        got = tmodel(torch.from_numpy(x), return_features=features).detach().numpy()
        np.testing.assert_allclose(got, want, **MODEL_TOL)


@pytest.mark.parametrize("kind", ["dino", "clip"])
def test_vit_state_dict_feeds_the_jax_converter(kind):
    """The port's keys are the transformers checkpoint's: the JAX converter
    reads its state dict into the JAX model's tree, and both models agree."""
    jmodel, params, tmodel = _vit_pair(kind)
    convert = jvit.convert_dinov2 if kind == "dino" else jvit.convert_clip_vision
    tree = convert(tmodel.state_dict())
    assert_tree_matches(tree["params"], params["params"])
    x = _normal(4, 2, 28, 28, 3)
    np.testing.assert_array_equal(np.asarray(jmodel.apply(tree, x)), np.asarray(jmodel.apply(params, x)))
    if kind == "clip":  # the [D] class token and [N, D] position table
        sd = tmodel.state_dict()
        assert sd["vision_model.embeddings.class_embedding"].shape == (32,)
        assert sd["vision_model.embeddings.position_embedding.weight"].shape == (5, 32)


@pytest.mark.parametrize("kind", ["dino", "clip"])
def test_vit_interpolates_positions_off_grid(kind):
    jmodel, params, tmodel = _vit_pair(kind)
    x = _normal(5, 1, 42, 42, 3)  # a 3x3 grid on a 2x2 table
    np.testing.assert_allclose(tmodel(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jmodel.apply(params, x)), **MODEL_TOL)


def test_vit_taps_are_the_final_norm_of_each_block():
    jmodel, params, tmodel = _vit_pair("dino")
    jtapped = jda.ViTTapped(jmodel.cfg, (1, 2))
    x = _normal(6, 2, 28, 28, 3)
    want = jtapped.apply(params, x)
    got = tmodel.taps(torch.from_numpy(x), (1, 2))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **MODEL_TOL)


@pytest.mark.parametrize("kind", ["dino", "clip"])
def test_preprocess_and_encoder_match_jax(kind):
    jmodel, params, tmodel = _vit_pair(kind)
    img = _images(7, 2, 40, 52, 3)
    np.testing.assert_allclose(
        tvit.preprocess(torch.from_numpy(img), 28, resize_to=32).numpy(),
        np.asarray(jvit.preprocess(jnp.asarray(img), 28, resize_to=32)), **RESIZE_TOL)
    want = np.asarray(jvit.make_encoder(jmodel, params, kind)(img))
    got = tvit.make_encoder(tmodel, kind)(torch.from_numpy(img)).detach().numpy()
    np.testing.assert_allclose(got, want, **MODEL_TOL)


# -- Depth-Anything -----------------------------------------------------------


def test_depth_anything_matches_jax(depth_pair):
    jmodel, params, tmodel = depth_pair
    x = _normal(8, 2, 28, 28, 3)
    want = np.asarray(jmodel.apply(params, x))
    got = tmodel(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (2, 28, 28) and np.ptp(want) > 0.1
    np.testing.assert_allclose(got, want, **MODEL_TOL)


def test_depth_anything_state_dict_feeds_the_jax_converter(depth_pair):
    """Including the ConvTranspose kernels ([in, out, k, k] in the port,
    [k, k, in, out] in JAX) and the strided 3x3 of factor 0.5."""
    jmodel, params, tmodel = depth_pair
    sd = tmodel.state_dict()
    assert sd["neck.reassemble_stage.layers.0.resize.weight"].shape == (8, 8, 4, 4)
    assert sd["neck.reassemble_stage.layers.3.resize.weight"].shape == (8, 8, 3, 3)
    assert "neck.fusion_stage.layers.0.residual_layer1.convolution1.weight" not in sd
    tree = jda.convert_depth_anything(sd)
    assert_tree_matches(tree["params"], params["params"])
    np.testing.assert_array_equal(tree["params"]["reassemble_0_resize"]["kernel"],
                                  np.asarray(params["params"]["reassemble_0_resize"]["kernel"]))


def test_block_upsample_is_conv_transpose():
    """The JAX einsum block expansion equals nn.ConvTranspose2d (kernel =
    stride) on the kernel that load_jax_params carries."""
    layer = jda._BlockUpsample(3, 2)
    x = _normal(9, 1, 4, 5, 6)
    params = _perturb(layer.init(jax.random.key(1), x), 1)
    conv = torch.nn.ConvTranspose2d(6, 3, 2, stride=2)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.asarray(params["params"]["kernel"]).transpose(2, 3, 0, 1)))
        conv.bias.copy_(torch.from_numpy(np.asarray(params["params"]["bias"])))
    got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(layer.apply(params, x)), **MODEL_TOL)


def test_depth_fn_matches_jax(depth_pair):
    jmodel, params, tmodel = depth_pair
    img = _images(10, 2, 40, 36, 3)
    want = np.asarray(jda.make_depth_fn(jmodel, params)(img))
    got = tda.make_depth_fn(tmodel)(torch.from_numpy(img)).detach().numpy()
    assert got.shape == (2, 40, 36)
    np.testing.assert_allclose(got, want, **MODEL_TOL)


# -- SegFormer ----------------------------------------------------------------


def test_segformer_logits_match_jax(segformer_pair):
    jmodel, params, tmodel = segformer_pair
    x = _normal(11, 2, 32, 32, 3)
    want = np.asarray(jmodel.apply(params, x))
    got = tmodel(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (2, 8, 8, 5) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **MODEL_TOL)


def test_segformer_state_dict_feeds_the_jax_converter(segformer_pair):
    """The depthwise [C, 1, 3, 3] kernel, the sequence-reduction conv and the
    BatchNorm statistics (buffers in the port) included."""
    jmodel, params, tmodel = segformer_pair
    sd = tmodel.state_dict()
    assert sd["segformer.encoder.block.0.0.mlp.dwconv.dwconv.weight"].shape == (16, 1, 3, 3)
    assert "decode_head.batch_norm.running_var" in dict(tmodel.named_buffers())
    tree = jseg.convert_segformer(sd)
    assert_tree_matches(tree["params"], params["params"])
    x = _normal(12, 1, 32, 32, 3)
    np.testing.assert_array_equal(np.asarray(jmodel.apply(tree, x)), np.asarray(jmodel.apply(params, x)))


def test_segment_fn_matches_jax_where_the_argmax_is_clear(segformer_pair):
    jmodel, params, tmodel = segformer_pair
    img = _images(13, 2, 48, 40, 3)

    def logits_and_masks(images):
        logits = jmodel.apply(params, jvit.preprocess(images, 512, resize_to=None))
        return logits, jseg.make_segment_fn(jmodel, params)(images)

    logits, want = (np.asarray(a) for a in jax.jit(logits_and_masks)(img))
    top2 = np.sort(logits, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 1e-5
    got = tseg.make_segment_fn(tmodel)(torch.from_numpy(img)).numpy()
    assert got.shape == (2, 128, 128) and clear.mean() > 0.99
    np.testing.assert_array_equal(got[clear], want[clear])


# -- InceptionV3 --------------------------------------------------------------


def test_inception_matches_jax(inception_pair):
    """The 1000 logits and, from the same weights without ``fc``, the 2048
    pooled features (75 x 75, the smallest input the stack takes)."""
    jmodel, params, tmodel = inception_pair
    x = _normal(14, 2, 75, 75, 3)
    np.testing.assert_allclose(tmodel(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jax.jit(jmodel.apply)(params, x)), **MODEL_TOL)
    pool = tinc.InceptionV3(num_classes=0, device="cpu")
    pool.load_state_dict({k: v for k, v in tmodel.state_dict().items() if not k.startswith("fc.")})
    pool_tree = jinc.convert_inception(pool.state_dict())
    got = pool(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (2, 2048)
    np.testing.assert_allclose(got, np.asarray(jax.jit(jinc.InceptionV3().apply)(pool_tree, x)),
                               **MODEL_TOL)


def test_inception_loads_the_jax_tree(inception_pair):
    """load_jax_params takes the converted tree back (the bn_* leaves into
    weight / bias / running statistics) bit-equal."""
    _, params, tmodel = inception_pair
    back = load_jax_params(tinc.InceptionV3(num_classes=1000, device="cpu"), params)
    for name, value in tmodel.state_dict().items():
        assert torch.equal(back.state_dict()[name], value), name
    assert jax_path("Mixed_5b.branch1x1.bn.running_var", 1, tinc.RENAMES) == (
        "Mixed_5b", "branch1x1", "bn_var")


# -- rewards ------------------------------------------------------------------


def _reward_pair(kind, depth_pair, segformer_pair, inception_pair):
    if kind == "depth":
        jm, p, tm = depth_pair
        return (jreg.RewardModel(depth=jda.make_depth_fn(jm, p)),
                treg.RewardModel(depth=tda.make_depth_fn(tm)))
    if kind == "segmentation":
        jm, p, tm = segformer_pair
        return (jreg.RewardModel(segment=jseg.make_segment_fn(jm, p)),
                treg.RewardModel(segment=tseg.make_segment_fn(tm)))
    if kind == "inception":
        jm, p, tm = inception_pair
        return (jreg.RewardModel(encode=jinc.make_inception_encoder(jm, p)),
                treg.RewardModel(encode=tinc.make_inception_encoder(tm)))
    jm, p, tm = _vit_pair(kind)
    return (jreg.RewardModel(encode=jvit.make_encoder(jm, p, kind)),
            treg.RewardModel(encode=tvit.make_encoder(tm, kind)))


@pytest.mark.parametrize("kind", ["depth", "segmentation", "dino", "clip", "inception"])
def test_reward_matches_jax(kind, depth_pair, segformer_pair, inception_pair):
    """Three pairs: equal images, noise against noise, and noise against a
    smooth ramp (random InceptionV3 logits hardly tell noise from noise)."""
    jmodel, tmodel = _reward_pair(kind, depth_pair, segformer_pair, inception_pair)
    size = 80 if kind == "inception" else 40
    pred, target = _images(15, 3, size, size, 3), _images(16, 3, size, size, 3)
    target[0] = pred[0]
    target[2] = np.linspace(0, 1, size, dtype=np.float32)[:, None, None]
    want = np.asarray(jax.jit(jreg.make_reward_fn(kind, jmodel))(pred, target))
    with torch.no_grad():
        got = treg.make_reward_fn(kind, tmodel)(torch.from_numpy(pred),
                                                 torch.from_numpy(target)).numpy()
    assert got.shape == (3,) and np.ptp(want) > 1e-3
    np.testing.assert_allclose(got, want, **MODEL_TOL)


# -- full width -----------------------------------------------------------------


def _count(tree):
    return sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(tree))


def _port_count(module):
    """Parameters plus BatchNorm statistics (JAX keeps those as params)."""
    return (sum(p.numel() for p in module.parameters())
            + sum(b.numel() for name, b in module.named_buffers()
                  if not name.endswith("num_batches_tracked")))


@pytest.mark.parametrize("name", ["dinov2_base", "clip_vit_l14", "depth_anything_v2_s",
                                  "segformer_b4", "inception_v3"])
def test_full_width_parameter_counts_match_jax(name):
    if name in ("dinov2_base", "clip_vit_l14"):
        jcfg = getattr(jvit.ViTConfig, name)()
        jmodel, tmodel, side = jvit.ViT(jcfg), tvit.ViT(_port_config(tvit.ViTConfig, jcfg),
                                                        device="meta"), 224
    elif name == "depth_anything_v2_s":
        jcfg = jda.DepthAnythingConfig.small_v2()
        jmodel = jda.DepthAnything(jcfg)
        tmodel, side = tda.DepthAnything(_port_config(tda.DepthAnythingConfig, jcfg),
                                         device="meta"), 518
    elif name == "segformer_b4":
        jmodel = jseg.Segformer(jseg.SegformerConfig.b4_ade())
        tmodel, side = tseg.Segformer(tseg.SegformerConfig.b4_ade(), device="meta"), 64
    else:
        jmodel, tmodel, side = jinc.InceptionV3(), tinc.InceptionV3(device="meta"), 299
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, side, side, 3)))
    assert _port_count(tmodel) == _count(shapes)


@pytest.mark.parametrize("kind", ["dino", "clip", "inception"])
def test_build_encoder_for_builds_the_production_backbone(kind):
    encode = treg.build_encoder_for(kind, device="meta")
    model = encode.model
    if kind == "inception":
        assert isinstance(model, tinc.InceptionV3) and model.num_classes == 1000
        want = _count(jax.eval_shape(jinc.InceptionV3(num_classes=1000).init, jax.random.key(0),
                                     jnp.zeros((1, 299, 299, 3))))
    else:
        cfg = jvit.ViTConfig.dinov2_base() if kind == "dino" else jvit.ViTConfig.clip_vit_l14()
        assert model.cfg == _port_config(tvit.ViTConfig, cfg)
        want = _count(jax.eval_shape(jvit.ViT(cfg).init, jax.random.key(0),
                                     jnp.zeros((1, 224, 224, 3))))
    assert _port_count(model) == want
    with pytest.raises(ValueError, match="no feature encoder"):
        treg.build_encoder_for("depth", device="meta")


def test_build_encoder_for_loads_a_jax_tree_at_full_width():
    """DINOv2-base from a JAX tree (the JAX converter's, of a seeded port
    model) gives JAX's ``build_encoder_for`` features."""
    torch.manual_seed(17)
    source = tvit.ViT(tvit.ViTConfig.dinov2_base(), device="cpu")
    tree = jvit.convert_dinov2(source.state_dict())
    img = _images(18, 2, 64, 80, 3)
    want = np.asarray(jreg.build_encoder_for("dino", tree)(img))
    with torch.no_grad():
        got = treg.build_encoder_for("dino", tree, device="cpu")(torch.from_numpy(img)).numpy()
    assert got.shape == (2, 768)
    np.testing.assert_allclose(got, want, **MODEL_TOL)


# -- transformers as a third oracle ------------------------------------------------


def _hf_model(name):
    """A tiny random transformers model of each backbone (the JAX package's
    parity configurations) and the port's twin."""
    import transformers as hf

    torch.manual_seed(0)
    if name == "dinov2":
        model = hf.Dinov2Model(hf.Dinov2Config(
            hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=128,
            image_size=28, patch_size=14, layerscale_value=1.0))
        return model, tvit.ViT(tvit.ViTConfig.tiny(), device="cpu"), 28
    if name == "clip":
        model = hf.CLIPVisionModelWithProjection(hf.CLIPVisionConfig(
            hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
            image_size=28, patch_size=14, projection_dim=16, hidden_act="quick_gelu"))
        return model, tvit.ViT(tvit.ViTConfig(**{**CLIP_TINY, "mlp_ratio": 2.0}), device="cpu"), 28
    if name == "depth_anything":
        backbone = hf.Dinov2Config(
            image_size=28, patch_size=14, hidden_size=32, num_hidden_layers=4,
            num_attention_heads=2, intermediate_size=128, layerscale_value=1.0,
            out_indices=[1, 2, 3, 4], apply_layernorm=True, reshape_hidden_states=False)
        model = hf.DepthAnythingForDepthEstimation(hf.DepthAnythingConfig(
            backbone_config=backbone, patch_size=14, reassemble_hidden_size=32,
            reassemble_factors=[4, 2, 1, 0.5], neck_hidden_sizes=[8, 8, 8, 8],
            fusion_hidden_size=8, head_hidden_size=8))
        return model, tda.DepthAnything(tda.DepthAnythingConfig.tiny(), device="cpu"), 28
    model = hf.SegformerForSemanticSegmentation(hf.SegformerConfig(
        num_encoder_blocks=2, hidden_sizes=[8, 16], depths=[1, 1], num_attention_heads=[1, 2],
        patch_sizes=[7, 3], strides=[4, 2], sr_ratios=[2, 1], mlp_ratios=[2, 2],
        decoder_hidden_size=16, num_labels=5, reshape_last_stage=True))
    return model, tseg.Segformer(tseg.SegformerConfig.tiny(), device="cpu"), 32


@pytest.mark.parametrize("name", ["dinov2", "clip", "depth_anything", "segformer"])
def test_transformers_checkpoints_load_as_they_are(name):
    """A transformers state dict loads into the port by ``load_state_dict``
    (strict), less the keys the JAX converters skip too (``mask_token``,
    ``position_ids``) and the first fusion layer's unused ``residual_layer1``,
    and the outputs agree with transformers' at the JAX parity tests'
    tolerance (DINOv2's MLP: tanh GELU here, exact there)."""
    pytest.importorskip("transformers")
    hf_model, port, side = _hf_model(name)
    hf_model.eval()
    skip = ("mask_token", "position_ids", "fusion_stage.layers.0.residual_layer1")
    port.load_state_dict({k: v for k, v in hf_model.state_dict().items()
                          if not any(s in k for s in skip)}, strict=True)
    x = np.random.default_rng(19).random((2, 3, side, side)).astype(np.float32)
    with torch.no_grad():
        out = hf_model(torch.from_numpy(x))
        mine = port(torch.from_numpy(x).permute(0, 2, 3, 1))
        if name == "clip":
            want, mine = out.image_embeds, port.features(torch.from_numpy(x).permute(0, 2, 3, 1))
        elif name == "dinov2":
            want = out.last_hidden_state
        elif name == "depth_anything":
            want = out.predicted_depth
        else:
            want, mine = out.logits, mine.permute(0, 3, 1, 2)
    np.testing.assert_allclose(mine.numpy(), want.numpy(), rtol=5e-3, atol=5e-4)
