"""consolver_torch.models.checkpoint: the port's own safetensors reader and
writer, hub checkpoints of every kind the JAX converter takes, and the
port's component layout (float and quantized), against the ``safetensors``
package and the JAX package's converters.

Oracles:

* the ``safetensors`` package reads the writer's files, and
  writes files the reader reads, bit for bit, for every dtype;
* for each of the 11 kinds, a tiny port module's weights written under the
  hub's key names (diffusers / transformers / torchvision / the reference
  FactorNet's ``mlp.0/2/4``) load through :func:`load_hub` into a module on
  ``meta`` with a state dict bit-equal to ``load_jax_params`` of the JAX
  converter's tree of the same file (``convert_unet``, ``convert_t5``,
  ``convert_depth_anything``, ..., ``FactorNet.load_torch_state_dict``),
  and for the text encoders and the policy the same output as the JAX
  module on that tree (f32, 1e-5); every other kind's forward is held to
  JAX after ``load_jax_params`` by its own test file, and bit-equal weights
  give the same forward;
* a quantized UNet / VAE (int8) and FLUX DiT (int4) saved as components
  and rebuilt on ``meta`` from the sidecar reload bit-equal to
  ``quantize_like`` in memory.
"""

import dataclasses
import json
import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consolver_torch.kernels import quant as tq
from consolver_torch.models import checkpoint as ck
from consolver_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
from consolver_torch.models.convert import load_jax_params
from consolver_torch.models.depth_anything import DepthAnything, DepthAnythingConfig
from consolver_torch.models.flux import FluxConfig, FluxTransformer
from consolver_torch.models.inception import InceptionV3
from consolver_torch.models.segformer import Segformer, SegformerConfig
from consolver_torch.models.t5 import T5Config, T5Encoder
from consolver_torch.models.unet_2d import UNet2DCondition, UNetConfig
from consolver_torch.models.vae import AutoencoderKL, VaeConfig
from consolver_torch.models.vit import ViT, ViTConfig
from consolver_torch.policy.factor_net import FactorNet, FactorNetConfig
from consolver_tpu.models import clip_text as jclip
from consolver_tpu.models import convert as jconv
from consolver_tpu.models import depth_anything as jda
from consolver_tpu.models import inception as jinc
from consolver_tpu.models import segformer as jseg
from consolver_tpu.models import t5 as jt5
from consolver_tpu.models import vit as jvit
from consolver_tpu.policy import factor_net as jfn

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
DTYPES = [torch.bfloat16, torch.float16, torch.float32, torch.float64, torch.int8, torch.uint8,
          torch.int16, torch.int32, torch.int64, torch.bool]
CLIP_VISION_TINY = dict(image_size=28, patch_size=14, hidden_size=32, num_layers=2, num_heads=2,
                        layerscale=False, quick_gelu=True, pre_norm_embed=True, patch_bias=False,
                        projection_dim=16, ln_eps=1e-5)
FNET = FactorNetConfig(num_actions=21, order_dim=4, scaler_dim=0, hidden_dim=32, family="sd")


def _tensor(dtype, shape, seed):
    gen = torch.Generator().manual_seed(seed)
    if dtype == torch.bool:
        return torch.rand(shape, generator=gen) > 0.5
    if dtype.is_floating_point:
        return torch.randn(shape, generator=gen).to(dtype)
    info = torch.iinfo(dtype)
    return torch.randint(max(info.min, -1000), min(info.max, 1000), shape, generator=gen,
                         dtype=torch.int64).to(dtype)


def _mixed(seed=0):
    return {f"t.{i}.{str(d).split('.')[-1]}": _tensor(d, (3, 5) if i % 2 else (7,), seed + i)
            for i, d in enumerate(DTYPES)} | {"scalar": torch.tensor(2.5),
                                               "empty": torch.zeros((0, 4))}


def _assert_same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert torch.equal(a[k], b[k]), k


# ------------------------------------------------------------ safetensors


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d).split(".")[-1])
def test_writer_is_read_by_the_package_bit_for_bit(tmp_path, dtype):
    from safetensors.torch import load_file

    tensors = {"a": _tensor(dtype, (4, 6), 1), "b.c": _tensor(dtype, (5,), 2)}
    ck.save_file(tensors, str(tmp_path / "x.safetensors"), metadata={"format": "pt"})
    _assert_same(load_file(str(tmp_path / "x.safetensors")), tensors)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d).split(".")[-1])
def test_reader_reads_the_package_bit_for_bit(tmp_path, dtype):
    from safetensors.torch import save_file

    tensors = {"a": _tensor(dtype, (4, 6), 3), "b.c": _tensor(dtype, (5,), 4)}
    save_file(tensors, str(tmp_path / "x.safetensors"), metadata={"k": "v"})
    f = ck.SafetensorsFile(str(tmp_path / "x.safetensors"))
    assert f.metadata == {"k": "v"}
    _assert_same({k: f.get(k) for k in f.keys()}, tensors)


def test_mixed_file_both_ways_and_header_alignment(tmp_path):
    from safetensors.torch import load_file, save_file

    tensors = _mixed()
    ck.save_file(tensors, str(tmp_path / "mine.safetensors"))
    _assert_same(load_file(str(tmp_path / "mine.safetensors")), tensors)
    with open(tmp_path / "mine.safetensors", "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
    assert n % 8 == 0
    save_file(tensors, str(tmp_path / "theirs.safetensors"))
    _assert_same(ck.load_file(str(tmp_path / "theirs.safetensors")), tensors)


def test_shards_index_and_torch_files(tmp_path):
    tensors = {f"w{i}": _tensor(torch.float32, (64, 64), i) for i in range(5)}
    files = ck.save_sharded(tensors, str(tmp_path / "sharded"), max_shard_bytes=40_000)
    assert len(files) == 3 and os.path.basename(files[0]) == "model-00001-of-00003.safetensors"
    with open(tmp_path / "sharded" / ck.INDEX_FILE) as f:
        index = json.load(f)
    assert set(index["weight_map"]) == set(tensors)
    _assert_same(ck.read_state_dict(str(tmp_path / "sharded")), tensors)
    (tmp_path / "bin").mkdir()
    torch.save(tensors, tmp_path / "bin" / "pytorch_model.bin")
    _assert_same(ck.read_state_dict(str(tmp_path / "bin")), tensors)
    with pytest.raises(FileNotFoundError):
        ck.read_state_dict(str(tmp_path / "nothing"))


def _raw_file(path, header, data=b""):
    raw = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)) + raw + data)


@pytest.mark.parametrize("case", ["truncated", "header_past_file", "overlap", "gap", "size"])
def test_bad_files_raise(tmp_path, case):
    path = str(tmp_path / "bad.safetensors")
    f32 = {"dtype": "F32", "shape": [2]}
    if case == "truncated":
        ck.save_file({"a": torch.ones(4)}, path)
        with open(path, "rb") as f:
            raw = f.read()
        with open(path, "wb") as f:
            f.write(raw[:-3])
    elif case == "header_past_file":
        with open(path, "wb") as f:
            f.write(struct.pack("<Q", 1 << 20) + b"{}")
    elif case == "overlap":
        _raw_file(path, {"a": {**f32, "data_offsets": [0, 8]},
                         "b": {**f32, "data_offsets": [4, 12]}}, bytes(12))
    elif case == "gap":
        _raw_file(path, {"a": {**f32, "data_offsets": [0, 8]},
                         "b": {**f32, "data_offsets": [12, 20]}}, bytes(20))
    else:
        _raw_file(path, {"a": {**f32, "data_offsets": [0, 12]}}, bytes(12))
    with pytest.raises(ValueError):
        ck.SafetensorsFile(path)


# ------------------------------------------------------------- hub kinds


def _filled(module, seed, std=0.05):
    """Random weights from a seed (BatchNorm variances kept positive)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            if t.is_floating_point():
                t.copy_(std * torch.randn(t.shape, generator=gen))
                if name.endswith("running_var"):
                    t.abs_().add_(0.5)
    return module


def _jax_factor_net_tree(state):
    return jfn.FactorNet(jfn.FactorNetConfig(**dataclasses.asdict(FNET))).load_torch_state_dict(
        state)


# kind -> (a tiny port module, the JAX converter of the hub state dict)
KIND_CASES = {
    "unet": (lambda d: UNet2DCondition(UNetConfig.tiny(), device=d), jconv.convert_unet),
    "vae": (lambda d: AutoencoderKL(VaeConfig.tiny(), device=d), jconv.convert_vae),
    "clip_text": (lambda d: ClipTextEncoder(ClipTextConfig.tiny(), device=d),
                  jconv.convert_clip_text),
    "clip_vision": (lambda d: ViT(ViTConfig(**CLIP_VISION_TINY), device=d),
                    jvit.convert_clip_vision),
    "dinov2": (lambda d: ViT(ViTConfig.tiny(), device=d), jvit.convert_dinov2),
    "t5": (lambda d: T5Encoder(T5Config.tiny(), device=d), jt5.convert_t5),
    "flux": (lambda d: FluxTransformer(FluxConfig.tiny(), device=d), jconv.convert_flux),
    "factor_net": (lambda d: FactorNet(FNET, device="cpu" if d == "meta" else d),
                   _jax_factor_net_tree),
    "depth_anything": (lambda d: DepthAnything(DepthAnythingConfig.tiny(), device=d),
                       jda.convert_depth_anything),
    "segformer": (lambda d: Segformer(SegformerConfig.tiny(), device=d), jseg.convert_segformer),
    "inception": (lambda d: InceptionV3(1000, device=d),
                  lambda s: jinc.convert_inception(s, keep_fc=True)),
}


def _hub_dir(tmp_path, kind, seed=0, shards=False):
    """A tiny port module's weights, written as a hub checkpoint of ``kind``
    (the hub's key names, f32 safetensors); returns (dir, hub state)."""
    make, _ = KIND_CASES[kind]
    hub = ck.hub_state_dict(_filled(make("cpu"), seed), kind)
    hub = {k: v for k, v in hub.items() if not k.endswith("num_batches_tracked")}
    src = str(tmp_path / "hub" / kind)
    ck.save_sharded(hub, src, max_shard_bytes=(sum(v.numel() * 4 for v in hub.values()) // 2
                                               if shards else None))
    return src, hub


@pytest.mark.parametrize("kind", sorted(KIND_CASES))
def test_hub_checkpoint_loads_as_load_jax_params_of_the_jax_converter(tmp_path, kind):
    make, convert = KIND_CASES[kind]
    src, hub = _hub_dir(tmp_path, kind, shards=kind == "unet")
    tree = convert({k: v.numpy() for k, v in ck.read_state_dict(src).items()})
    want = load_jax_params(make("cpu"), tree).state_dict()
    got = ck.load_hub(make("meta"), kind, src, device="cpu").state_dict()
    _assert_same(got, want)


def test_text_encoders_and_policy_match_the_jax_modules(tmp_path):
    ids = np.random.default_rng(0).integers(0, 64, (2, 7))
    for kind, jmodel, args in (
        ("clip_text", jclip.ClipTextEncoder(jclip.ClipTextConfig.tiny()), (ids,)),
        ("t5", jt5.T5Encoder(jt5.T5Config.tiny()), (ids,)),
    ):
        make, convert = KIND_CASES[kind]
        src, hub = _hub_dir(tmp_path, kind)
        tree = convert({k: v.numpy() for k, v in hub.items()})
        port = ck.load_hub(make("meta"), kind, src, device="cpu")
        with torch.no_grad():
            mine = port(torch.from_numpy(ids)).numpy()
        np.testing.assert_allclose(mine, np.asarray(jmodel.apply(tree, *args)), **FWD_TOL)
    src, hub = _hub_dir(tmp_path, "factor_net")
    port = ck.load_hub(KIND_CASES["factor_net"][0]("cpu"), "factor_net", src)
    jnet = jfn.FactorNet(jfn.FactorNetConfig(**dataclasses.asdict(FNET)))
    conds_x = np.random.default_rng(1).uniform(0, 999, (3, 2)).astype(np.float32)
    want = jnet.log_probs(_jax_factor_net_tree(hub), {"x": jnp.asarray(conds_x)})
    with torch.no_grad():
        mine = port.log_probs({"x": torch.from_numpy(conds_x)}).numpy()
    np.testing.assert_allclose(mine, np.asarray(want), **FWD_TOL)


def test_old_vae_attention_names_and_skip_patterns(tmp_path):
    src, hub = _hub_dir(tmp_path, "vae")
    old = {}
    for k, v in hub.items():
        for new, legacy in ((".to_q.", ".query."), (".to_k.", ".key."), (".to_v.", ".value."),
                            (".to_out.0.", ".proj_attn.")):
            k = k.replace(new, legacy)
        old[k] = v
    assert old != hub
    ck.save_file(old, str(tmp_path / "old.safetensors"))
    make = KIND_CASES["vae"][0]
    got = ck.load_hub(make("meta"), "vae", str(tmp_path / "old.safetensors"), device="cpu")
    want = ck.load_hub(make("meta"), "vae", src, device="cpu")
    _assert_same(got.state_dict(), want.state_dict())

    src, hub = _hub_dir(tmp_path, "clip_text")
    extra = {**hub, "text_model.embeddings.position_ids": torch.arange(8)[None],
             "logit_scale": torch.tensor(1.0), "text_projection.weight": torch.ones(4, 4)}
    ck.save_file(extra, str(tmp_path / "clip_extra.safetensors"))
    make = KIND_CASES["clip_text"][0]
    _assert_same(ck.load_hub(make("meta"), "clip_text", str(tmp_path / "clip_extra.safetensors"),
                             device="cpu").state_dict(),
                 ck.load_hub(make("meta"), "clip_text", src, device="cpu").state_dict())


def test_extra_or_missing_keys_raise_and_name_them(tmp_path):
    src, hub = _hub_dir(tmp_path, "unet")
    make = KIND_CASES["unet"][0]
    ck.save_file({**hub, "down_blocks.0.bogus.weight": torch.ones(3)},
                 str(tmp_path / "extra.safetensors"))
    with pytest.raises(KeyError, match="bogus"):
        ck.load_hub(make("meta"), "unet", str(tmp_path / "extra.safetensors"), device="cpu")
    ck.save_file({k: v for k, v in hub.items() if k != "conv_in.weight"},
                 str(tmp_path / "missing.safetensors"))
    with pytest.raises(KeyError, match="conv_in.weight"):
        ck.load_hub(make("meta"), "unet", str(tmp_path / "missing.safetensors"), device="cpu")


def test_loader_casts_to_the_model_dtype_and_keeps_int_tensors(tmp_path):
    src, hub = _hub_dir(tmp_path, "unet")
    unet = ck.load_hub(UNet2DCondition(UNetConfig.tiny(), device="meta", dtype=torch.bfloat16),
                       "unet", src, device="cpu")
    for k, v in unet.state_dict().items():
        assert v.dtype == torch.bfloat16 and torch.equal(v, hub[k].to(torch.bfloat16)), k
    assert ck.cast_floating({"i": torch.ones(2, dtype=torch.int8)}, torch.bfloat16)["i"].dtype \
        == torch.int8


def test_factor_net_dims_are_checked(tmp_path):
    src, _ = _hub_dir(tmp_path, "factor_net")
    wrong = FactorNet(dataclasses.replace(FNET, num_actions=11), device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        ck.load_hub(wrong, "factor_net", src)


# ---------------------------------------------------- components and sidecars


def test_component_round_trip_and_jax_sidecar(tmp_path):
    from scripts.convert_checkpoints import model_config

    for kind, preset in (("unet", "tiny"), ("vae", "tiny"), ("clip_text", "tiny")):
        jcfg = model_config(kind, preset)
        path = str(tmp_path / kind)
        with open(ck.config_path(path), "w") as f:
            json.dump(dataclasses.asdict(jcfg), f)  # the JAX converter's sidecar
        cls, _ = ck.kind_spec(kind)
        assert [f.name for f in dataclasses.fields(cls)] == \
            [f.name for f in dataclasses.fields(type(jcfg))]
        assert ck.load_model_config(path, cls, None) == getattr(cls, preset)()
    for cls, cfg in ((DepthAnythingConfig, DepthAnythingConfig.tiny()),
                     (FluxConfig, FluxConfig.tiny())):
        ck.write_config(str(tmp_path / "c"), cfg)
        assert ck.load_model_config(str(tmp_path / "c"), cls, None) == cfg
    unet = _filled(UNet2DCondition(UNetConfig.tiny(), device="cpu"), 3)
    ck.save_component(unet, str(tmp_path / "unet"), UNetConfig.tiny())
    back = ck.load_component(UNet2DCondition(UNetConfig.tiny(), device="meta"),
                             str(tmp_path / "unet"), device="cpu")
    _assert_same(back.state_dict(), unet.state_dict())


@pytest.mark.parametrize("case", ["unet_int8_hybrid", "vae_int8", "flux_int4"])
def test_quantized_components_reload_bit_equal(tmp_path, case):
    if case == "flux_int4":
        cfg, cls = FluxConfig.tiny(), FluxTransformer
        qcfg = dataclasses.replace(cfg, quant_int4=True)
    elif case == "vae_int8":
        cfg, cls = VaeConfig.tiny(), AutoencoderKL
        qcfg = dataclasses.replace(cfg, quant_int8=True)
    else:
        cfg, cls = UNetConfig.tiny(), UNet2DCondition
        qcfg = dataclasses.replace(cfg, quant_int8=True, quant_skip_levels=(0,))
    float_model = _filled(cls(cfg, device="cpu"), 5)
    quant = tq.quantize_like(cls(qcfg, device="meta"), float_model)
    path = str(tmp_path / case)
    ck.save_component(quant, path, qcfg)
    loaded_cfg = ck.load_model_config(path, type(cfg), cfg)
    assert loaded_cfg == qcfg and ck.is_quantized(loaded_cfg)
    back = ck.load_component(cls(loaded_cfg, device="meta"), path, device="cpu", verbatim=True)
    _assert_same(back.state_dict(), quant.state_dict())
    assert any(v.dtype in (torch.int8, torch.uint8) for v in back.state_dict().values())
