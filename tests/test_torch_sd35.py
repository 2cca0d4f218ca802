"""Stable Diffusion 3.5 Large in the port (``models/mmdit.py``, the CLIP
towers' SD3 options, ``pipelines/sd3.py``, ``SD3InferenceEngine``, ``serve
--family sd35`` and the two checkpoint kinds) against the plain f32
reference ``perfbench/reference/sd35.py``, on tiny widths and seeded weights
that the program and the reference share, on the CPU.

The weights are drawn with numpy at 0.2 * N(0, 1) (norm scales 1 + 0.2 *
N(0, 1)), not the benchmark's 0.02: at tiny widths 0.02 leaves the image
stream nearly blind to the text stream, the last block's modulation and the
guidance (a swapped scale and shift moves the MMDiT's output by 7e-7), which
no tolerance could tell from rounding; at 0.2 each moves it by 0.4 to 12.

The tiny cut of the benchmark's configuration lives here (``tiny_cfg``):
``perfbench/tests/tiny.py`` cuts every configuration other than SD-1.5 as
FLUX's.
"""

import base64
import copy
import dataclasses
import json
import math
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from consolver_torch.cli import serve as cli_serve
from consolver_torch.core import schedules
from consolver_torch.kernels.quant import Int8Linear
from consolver_torch.models import checkpoint as ck
from consolver_torch.models.clip_text import ClipTextConfig, ClipTextEncoder, ClipTextProjConfig
from consolver_torch.models.flux import DoubleStreamBlock, FluxConfig, rope_freqs
from consolver_torch.models.mmdit import MMDiTConfig, SD3Transformer, sincos_pos_embed
from consolver_torch.pipelines import fm
from consolver_torch.pipelines.sd3 import SD3Pipeline, sd3_fm_config
from consolver_torch.serve import GenerationRequest, SD3InferenceEngine, make_replicas
from consolver_torch.serve.engine import seed_noise
from consolver_torch.utils.png import decode_png
from perfbench import run
from perfbench.lib import flops, flops_sd3
from perfbench.reference import sd35 as ref

ROOT = Path(__file__).resolve().parent.parent
CELL = "sd35-large-preview-serial"
STD = 0.2
# f32 on both sides, in another order of operations (joint attention over
# [text | image] against [image | text], LayerNorm and RMS formulas, the
# position table in f64 then f32): measured 7.6e-6 on MMDiT outputs of mean
# magnitude 3; 1e-4 leaves room and is 4000x below the smallest planted fault
TOL = dict(rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------- helpers
def _fill(module, seed, std=STD):
    """Every parameter std * N(0, 1) from numpy (1-D weights: 1 + ...)."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            v = rng.standard_normal(tuple(p.shape)).astype(np.float32) * std
            if p.ndim == 1 and name.endswith("weight"):
                v += 1.0
            p.copy_(torch.from_numpy(v))
    return module


class _Weights:
    """The reference's weight getter over a module's own parameters."""

    def __init__(self, module):
        self.t = {k: v.detach().float().clone() for k, v in module.named_parameters()}

    def __call__(self, name):
        return self.t[name]

    def has(self, name):
        return name in self.t


def tiny_cfg():
    """The benchmark's configuration at tiny widths: an 8x8 latent (4x4
    patches, the centre of an 8x8 position table), T5 at its served 256
    tokens (a 333-token context)."""
    cfg = copy.deepcopy(run.load_json(run.BENCH_DIR / "configs" / "sd35-large-preview.json"))
    cfg["transformer"].update(hidden_size=48, num_heads=2, num_layers=2, joint_attention_dim=32,
                              pooled_projection_dim=24, pos_embed_max_size=8, sample_size=8)
    cfg["clip_l"].update(vocab_size=1000, hidden_size=8, num_layers=2, num_heads=2,
                         intermediate_size=16, projection_dim=8)
    cfg["clip_g"].update(vocab_size=1000, hidden_size=16, num_layers=2, num_heads=2,
                         intermediate_size=32, projection_dim=16)
    cfg["t5"].update(vocab_size=512, d_model=32, d_kv=8, d_ff=64, num_layers=1, num_heads=4)
    cfg["vae"].update(block_out_channels=[8, 16], layers_per_block=1, norm_num_groups=4)
    cfg["pipeline"].update(resolution=16)
    return cfg


def _config_module():
    return run.load_module(run.BENCH_DIR / "configs" / "sd35-large-preview.py")


def _pipeline(cfg, seed=0):
    """The port's pipeline at ``cfg`` with numpy-drawn weights, and the
    reference's getters over the same weights."""
    from consolver_torch.models.t5 import T5Encoder
    from consolver_torch.models.vae import AutoencoderKL
    from consolver_torch.policy.factor_net import FactorNet

    mcfg, lcfg, gcfg, t5cfg, vcfg, fcfg = _config_module()._program_configs(cfg)
    models = {"transformer": SD3Transformer(mcfg, device="cpu"),
              "clip_l": ClipTextEncoder(lcfg, device="cpu"),
              "clip_g": ClipTextEncoder(gcfg, device="cpu"),
              "t5": T5Encoder(t5cfg, device="cpu"), "vae": AutoencoderKL(vcfg, device="cpu"),
              "factor_net": FactorNet(fcfg, device="cpu")}
    for i, m in enumerate(models.values()):
        _fill(m, seed + i)
    p = cfg["pipeline"]
    pipe = SD3Pipeline(models["transformer"], models["clip_l"], models["clip_g"], models["t5"],
                       models["vae"], factor_net=models["factor_net"],
                       vae_scaling_factor=vcfg.scaling_factor,
                       vae_shift_factor=p["vae_shift_factor"], t5_max_length=p["t5_max_length"],
                       device="cpu")
    return pipe, {tag: _Weights(m) for tag, m in models.items()}


def _uint8(images):
    return torch.round(images.clamp(0, 1) * 255).to(torch.uint8).numpy()


# ------------------------------------------------------------------ MMDiT
@pytest.mark.parametrize("hw", [(8, 8), (12, 8), (8, 16)], ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_mmdit_matches_reference(hw):
    """The forward, with the context_pre_only last block and the position
    table's centre crop (4x4 to 6x4 and 4x8 patches of an 8x8 table, so the
    rows and columns of the crop and of proj_out's unpatching are told
    apart)."""
    cfg = MMDiTConfig.tiny()
    m = _fill(SD3Transformer(cfg, device="cpu"), 3)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, *hw, 16, generator=g)
    ctx, pooled = torch.randn(2, 7, 32, generator=g), torch.randn(2, 24, generator=g)
    t = torch.tensor([900.0, 300.0])
    with torch.no_grad():
        got = m(x, ctx, pooled, t)
        want = ref.mmdit(_Weights(m), dataclasses.asdict(cfg), x, ctx, pooled, t)
    assert got.shape == x.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, want, **TOL)


def test_context_pre_only_block():
    """The last block: a 2-way (scale, shift) text modulation, q/k/v only,
    no text output; it still reads the text (its keys and values)."""
    m = _fill(SD3Transformer(MMDiTConfig.tiny(), device="cpu"), 4)
    first, last = m.transformer_blocks[0], m.transformer_blocks[-1]
    h = m.cfg.hidden_size
    assert first.norm1_context_linear.out_features == 6 * h and hasattr(first, "ff_context_net_2")
    assert last.norm1_context_linear.out_features == 2 * h
    for name in ("attn_to_add_out", "ff_context_net_0_proj", "ff_context_net_2"):
        assert not hasattr(last, name)
    img, txt, vec = torch.randn(1, 16, h), torch.randn(1, 5, h), torch.randn(1, h)
    with torch.no_grad():
        out, none = last(img, txt, vec, None, None)
        moved = last(img, torch.randn(1, 5, h), vec, None, None)[0]
    assert none is None and out.shape == img.shape
    assert (moved - out).abs().max() > 1e-2


def test_position_table_recipe():
    """diffusers' 2-D sin-cos table: columns' code then rows', each [sin |
    cos] at pos = index / (grid / base); the crop is the table's centre."""
    dim, m, base = 32, 12, 4
    table = sincos_pos_embed(dim, m, base)
    r, c, j = 7, 3, 5  # row, column, frequency
    w = 10000 ** (-j / (dim / 4))
    cell = table[r * m + c]
    assert cell[j] == pytest.approx(math.sin(c / (m / base) * w), abs=1e-12)
    assert cell[dim // 4 + j] == pytest.approx(math.cos(c / (m / base) * w), abs=1e-12)
    assert cell[dim // 2 + j] == pytest.approx(math.sin(r / (m / base) * w), abs=1e-12)
    cfg = dataclasses.replace(MMDiTConfig.tiny(), hidden_size=dim, pos_embed_max_size=m,
                              sample_size=2 * base)
    model = SD3Transformer(cfg, device="cpu")
    crop = model.cropped_pos_embed(6, 4)
    want = ref.pos_table(dataclasses.asdict(cfg), 6, 4, "cpu")
    torch.testing.assert_close(crop, want, rtol=0, atol=1e-6)
    # at the published table (192 x 192 at base 64) a 1024^2 image's 64x64
    # patches take rows and columns 64..127, at positions 64/3 .. 127/3
    cfg = dataclasses.replace(MMDiTConfig.sd35_large(), hidden_size=8, num_heads=2,
                              num_layers=1)
    model = SD3Transformer(cfg, device="cpu")
    crop = model.cropped_pos_embed(64, 64)
    table = model.pos_embed.reshape(192, 192, 8)
    torch.testing.assert_close(crop[0], table[64, 64], rtol=0, atol=0)
    torch.testing.assert_close(crop[-1], table[127, 127], rtol=0, atol=0)
    assert crop[1, 0].item() == pytest.approx(math.sin(65 / 3), abs=1e-6)
    torch.testing.assert_close(crop, ref.pos_table(dataclasses.asdict(cfg), 64, 64, "cpu"),
                               rtol=0, atol=1e-6)


# ---------------------------------------------------------------- towers
@pytest.mark.parametrize("tower", ["clip_l", "clip_g"])
def test_clip_tower_matches_reference(tower):
    """CLIP-L (quick-GELU) and bigG (exact GELU): the penultimate state and
    the projected pooled state."""
    cfg = tiny_cfg()[tower]
    enc = _fill(ClipTextEncoder(ClipTextProjConfig(**cfg), device="cpu"), 5)
    ids = torch.randint(3, 1000, (2, 77), generator=torch.Generator().manual_seed(1))
    ids[:, 0], ids[0, 12:] = 1, 0
    with torch.no_grad():
        hidden, pooled = enc(ids, return_pooled=True, penultimate=True)
        want_hidden, want_pooled = ref.clip_tower(_Weights(enc), cfg, ids)
        last = enc(ids)
    assert hidden.shape == (2, 77, cfg["hidden_size"])
    assert pooled.shape == (2, cfg["projection_dim"])
    torch.testing.assert_close(hidden.float(), want_hidden, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(pooled, want_pooled, rtol=1e-5, atol=1e-5)
    assert (last - hidden).abs().max() > 1e-2  # the penultimate state is not the last


def test_bigg_preset():
    c = ClipTextProjConfig.openclip_bigg()
    assert (c.hidden_size, c.num_layers, c.num_heads, c.intermediate_size, c.hidden_act,
            c.projection_dim) == (1280, 32, 20, 5120, "gelu", 1280)
    assert ClipTextProjConfig.sd3_clip_l().projection_dim == 768
    # SD-1.5's config keeps the JAX package's fields (its sidecar)
    assert [f.name for f in dataclasses.fields(ClipTextConfig)][-1] == "max_position_embeddings"
    assert (ClipTextConfig.hidden_act, ClipTextConfig.projection_dim) == ("quick_gelu", 0)


def test_context_assembly():
    """333 tokens: the two CLIP towers' 77 penultimate states side by side
    (8 + 16 channels), zero-padded to T5's width, then T5's 256 states; the
    pooled vector is the two projections side by side."""
    cfg = tiny_cfg()
    pipe, weights = _pipeline(cfg)
    texts = ["a red fox sitting in tall grass at sunrise", ""]
    with torch.no_grad():
        context, pooled = pipe.encode_prompt(pipe.tokenize(texts))
        want_context, want_pooled = ref.encode(weights, cfg, texts, "cpu")
    assert context.shape == (2, 333, 32) and pooled.shape == (2, 24)
    assert torch.count_nonzero(context[:, :77, 24:]) == 0
    torch.testing.assert_close(context, want_context, **TOL)
    torch.testing.assert_close(pooled, want_pooled, **TOL)


# ---------------------------------------------------------------- ladder
def test_shift3_ladder_closed_form():
    """FlowMatchEulerDiscreteScheduler(shift=3.0): linspace of t from 1000 to
    1000 sigma_min, sigma_min = 3 s / (1 + 2 s) at s = 1/1000, shifted again,
    then 0."""
    sigmas, timesteps = schedules.fm_sigmas(sd3_fm_config(), 8)
    ref_sig, ref_ts = ref.sd3_ladder({"num_train_timesteps": 1000, "shift": 3.0}, 8)
    s_min = 3 * 0.001 / (1 + 2 * 0.001)
    s = np.linspace(1000, 1000 * s_min, 8) / 1000
    closed = np.append(3 * s / (1 + 2 * s), 0.0)
    # f32 ladders against the f64 closed form; the reference's training
    # table is f32, the program's f64 (1e-7 apart)
    np.testing.assert_allclose(sigmas, closed, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ref_sig, closed, rtol=0, atol=1e-6)
    np.testing.assert_allclose(timesteps, ref_ts, rtol=0, atol=1e-4)
    assert sigmas[0] == 1.0 and sigmas[-1] == 0.0 and len(sigmas) == 9


# --------------------------------------------------------------- preview
def test_fmppo_preview_with_cfg_matches_reference():
    """An 8-step fmppo preview with CFG 3.5 and sampled actions: the final
    latents and the decoded image.  Planted faults (no guidance, another
    prompt) move the latents by far more than the tolerance."""
    cfg = tiny_cfg()
    pipe, weights = _pipeline(cfg, seed=10)
    text, seed = "a cozy cabin in a snowy pine forest at dusk", 1234567
    noise = seed_noise([seed], (8, 8, 16))

    def latents(prompt, guidance):
        gen = torch.Generator().manual_seed(seed)
        out, _ = pipe(gen, pipe.tokenize([prompt]), noise, num_inference_steps=8,
                      guidance_scale=guidance, decode=False, record=False)
        return out

    got = latents(text, 3.5)
    with torch.no_grad():
        negative = ref.encode(weights, cfg, [""], "cpu")
        want = ref.preview_latents(weights, cfg, text, seed, ([seed], 0), negative, "cpu")
    torch.testing.assert_close(got, want, **TOL)
    assert (latents(text, 1.0) - want).abs().max() > 0.1
    assert (latents("a red fox", 3.5) - want).abs().max() > 0.1
    with torch.no_grad():
        image = _uint8(pipe.decode_latents(got))
        want_image = ref.decode(weights, cfg, want)
    # f32 on both sides; rounding to uint8 may flip a level
    assert np.abs(image.astype(int) - want_image.astype(int)).max() <= 1


def test_padded_program_serves_fewer_steps():
    """``padded_max_steps``: an 8-step preview from the 10-step program; the
    pad steps pass the latents through, and the policy's draws for the real
    steps come first, so the latents equal the 8-step program's."""
    cfg = tiny_cfg()
    pipe, _ = _pipeline(cfg, seed=15)
    noise, ids = seed_noise([5], (8, 8, 16)), pipe.tokenize(["a steaming cup of coffee"])
    want, _ = pipe(torch.Generator().manual_seed(5), ids, noise, decode=False, record=False)
    got, traj = pipe(torch.Generator().manual_seed(5), ids, noise, decode=False,
                     padded_max_steps=10)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert traj.valid.sum().item() == 7  # steps 1-7 of 8 real; step 0 dropped


@pytest.mark.parametrize("solver", fm.FM_SOLVERS)
def test_fm_baselines_run_through_sd3(solver):
    """The training-free FM solvers serve through the pipeline; euler is
    held to x += (sigma_next - sigma) v over the reference's MMDiT."""
    cfg = tiny_cfg()
    pipe, weights = _pipeline(cfg, seed=20)
    noise = seed_noise([7], (8, 8, 16))
    out, traj = pipe(None, pipe.tokenize(["a lighthouse"]), noise, num_inference_steps=4,
                     guidance_scale=3.5, solver=solver, decode=False)
    assert traj is None and out.shape == noise.shape and torch.isfinite(out).all()
    if solver != "euler":
        return
    sig, ts = ref.sd3_ladder(cfg["flow_match"], 4)
    with torch.no_grad():
        neg = ref.encode(weights, cfg, [""], "cpu")
        pos = ref.encode(weights, cfg, ["a lighthouse"], "cpu")
        context, pooled = torch.cat([neg[0], pos[0]]), torch.cat([neg[1], pos[1]])
        x = noise.clone()
        for i in range(4):
            v_u, v_c = ref.mmdit(weights["transformer"], cfg["transformer"], torch.cat([x, x]),
                                 context, pooled, torch.full((2,), float(ts[i]))).chunk(2)
            x = x + float(sig[i + 1] - sig[i]) * (v_u + 3.5 * (v_c - v_u))
    torch.testing.assert_close(out, x, **TOL)


def test_quantized_copy_is_int8_and_close():
    """``quantize()``: the blocks' projections and the VAE decoder on int8
    layers (the control of the benchmark's check); the float pipeline is
    left as it was."""
    cfg = tiny_cfg()
    pipe, _ = _pipeline(cfg, seed=30)
    q = pipe.quantize()
    assert isinstance(q.transformer.transformer_blocks[0].attn_to_q, Int8Linear)
    assert isinstance(pipe.transformer.transformer_blocks[0].attn_to_q, torch.nn.Linear)
    assert q.clip_l is pipe.clip_l and not q.programs
    noise = seed_noise([3], (8, 8, 16))
    ids = pipe.tokenize(["a vase of sunflowers"])
    a, _ = pipe(torch.Generator().manual_seed(3), ids, noise, decode=False, record=False)
    b, _ = q(torch.Generator().manual_seed(3), ids, noise, decode=False, record=False)
    err = (a - b).abs().max()
    assert 0 < err < 0.1 * a.abs().max()


# --------------------------------------------------------------- serving
def _bench_system(cfg, seed=5):
    return _config_module().build(cfg, seed, torch.device("cpu"))


def test_engine_spans_one_mmdit_call_per_step():
    """``stats()["spans"]``: the three towers inside ``pipeline.text``, and
    one ``model.mmdit`` (2 rows under CFG) for each ``pipeline.step``."""
    cfg = tiny_cfg()
    system = _bench_system(cfg)
    try:
        for i in range(2):
            req = GenerationRequest(prompt=f"prompt {i}", seed=i + 1, num_inference_steps=8,
                                    guidance_scale=3.5, solver="fmppo")
            image = system.engine.generate(req, timeout=120)
            assert image.shape == (16, 16, 3) and image.dtype == np.uint8
        spans = system.engine.stats()["spans"]
    finally:
        system.free()
    for name in ("text.clip_l", "text.clip_g", "text.t5", "pipeline.text", "pipeline.decode"):
        assert spans[name]["count"] == 2, name
    assert spans["pipeline.step"]["count"] == 16
    assert spans["model.mmdit"]["count"] == spans["pipeline.step"]["count"]
    assert spans["pipeline.text"]["total_ms"] >= spans["text.t5"]["total_ms"]


def test_reference_draws_the_served_weights():
    """The check's weights are the program's, bit for bit: every model drawn
    again from the seed, T5's at T5's own initialisation scales (q about
    (d_model d_kv)^-1/2, the embedding 1) as the build scales them."""
    cfg = tiny_cfg()
    system = _bench_system(cfg, seed=2**31 + 5)
    try:
        weights = _config_module().weights_for(cfg, 2**31 + 5, system.layouts, "cpu")
        pipe = system.pipeline
        for tag, model in (("t5", pipe.t5), ("transformer", pipe.transformer),
                           ("clip_g", pipe.clip_g)):
            for name, param in model.named_parameters():
                assert torch.equal(weights[tag](name), param.float()), (tag, name)
        t5 = dict(pipe.t5.named_parameters())
        q_std = (cfg["t5"]["d_model"] * cfg["t5"]["d_kv"]) ** -0.5
        assert t5["block.0.attention.q.weight"].std().item() == pytest.approx(q_std, rel=0.3)
        assert t5["shared.weight"].std().item() == pytest.approx(1.0, rel=0.1)
    finally:
        system.free()


def test_cell_end_to_end_through_run_cell():
    """The cell's own traffic and harness (HTTP server, load generator,
    window, readers, check against the reference) on the tiny cut, with the
    benchmark's own weights."""
    cfg = tiny_cfg()
    wl = copy.deepcopy(run.load_json(run.BENCH_DIR / "workloads" / f"{CELL}.json"))
    wl["traffic"].update(check_within=3, grace_s=120.0)
    # a tiny f32 stack on the CPU reads about 0.13 levels mean and no
    # channel 8 levels off
    cfg["check"]["limits"] = {"img_mae_max": 0.5, "px_off8_pct_max": 0.1}
    bench = run.load_json(ROOT / "BENCHMARK.json")
    out = run.run_cell(CELL, wl, cfg, bench, 2**31 + 77, 2.0, False, torch.device("cpu"))
    assert out["correct"], out["compared"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"setup_s", "preview_p95_s"}
    assert math.isfinite(out["metrics"]["preview_p95_s"]["value"])


def test_traced_cell_reads_the_shared_serving_metrics():
    """A traced run of the tiny cut reports the serving and step metrics the
    cell shares with the SD-1.5 preview cells (their readers read the
    engine's rings and counters and the program's spans, which
    ``SD3InferenceEngine`` keeps as ``InferenceEngine`` does) and
    ``pipeline.text_ms.sd35``; on the CPU no device operation runs, so the
    trace's readers read nothing."""
    cfg = tiny_cfg()
    wl = copy.deepcopy(run.load_json(run.BENCH_DIR / "workloads" / f"{CELL}.json"))
    wl["traffic"].update(check_within=3, grace_s=120.0)
    wl["trace"] = {"start_s": 0.5, "seconds": 1.0, "margin_s": 0.2}
    cfg["check"]["limits"] = {"img_mae_max": 0.5, "px_off8_pct_max": 0.1}
    bench = run.load_json(ROOT / "BENCHMARK.json")
    out = run.run_cell(CELL, wl, cfg, bench, 2**31 + 78, 2.0, True, torch.device("cpu"))
    assert out["correct"], out["compared"]
    assert set(out["metrics"]) == {
        "serve.queue_wait_ms.preview", "serve.occupancy.preview", "pipeline.dispatch_ms.preview",
        "pipeline.step_host_ms.preview", "pipeline.step_blocked_ms.preview",
        "serve.codec_ms.preview", "pipeline.text_ms.sd35"}
    assert out["device"]["busy_s"] == 0


def test_benchmark_entries():
    """The configuration, the cell on one chip, the cell among
    ``preview_p95_s``'s, four per-layer metrics of its own with readers, and
    the cell among the serving and step metrics whose readers it shares."""
    bench = run.load_json(ROOT / "BENCHMARK.json")
    (config,) = [c for c in bench["configs"] if c["name"] == "sd35-large-preview"]
    assert config["reduced"] == [] and config["source"].endswith("stable-diffusion-3.5-large")
    (cell,) = [w for w in bench["workloads"] if w["name"] == CELL]
    assert cell["chips"] == 1 and cell["config"] == "sd35-large-preview"
    (p95,) = [m for m in bench["end_to_end"] if m["name"] == "preview_p95_s"]
    assert CELL in p95["workloads"]
    mine = [m for m in bench["per_layer"] if m.get("workloads") == [CELL]]
    assert {m["name"] for m in mine} == {
        "model.denoiser_share.sd35", "flash_fwd_roofline.sd35", "mfu.sd35",
        "pipeline.text_ms.sd35"}
    shared = [m for m in bench["per_layer"] if CELL in m.get("workloads", ()) and m not in mine]
    assert {m["name"] for m in shared} == {
        "serve.queue_wait_ms.preview", "serve.occupancy.preview", "pipeline.dispatch_ms.preview",
        "device.idle_share.preview", "pipeline.step_host_ms.preview",
        "pipeline.step_blocked_ms.preview", "serve.codec_ms.preview"}
    for m in mine + shared:
        assert m["moves"] == "preview_p95_s"
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()


def test_replicas_serve_like_one_engine():
    cfg = tiny_cfg()
    pipe, _ = _pipeline(cfg, seed=40)
    req = GenerationRequest(prompt="a hummingbird", seed=9, guidance_scale=3.5, solver="fmppo")
    with SD3InferenceEngine(pipe, latent_size=8) as one:
        want = one.generate(req, timeout=120)
    with make_replicas(pipe, SD3InferenceEngine, 2, ["cpu", "cpu"], latent_size=8) as group:
        got = [group.generate(req, timeout=120) for _ in range(2)]
    for image in got:
        np.testing.assert_array_equal(image, want)


def test_engine_refuses_a_mesh():
    pipe, _ = _pipeline(tiny_cfg(), seed=41)
    with pytest.raises(ValueError, match="one card"):
        SD3InferenceEngine(pipe, latent_size=8, mesh=object())


# -------------------------------------------------------------------- CLI
def _args(*argv):
    return cli_serve._parser().parse_args([*argv, "--device", "cpu"])


def test_cli_family_sd35_serves_generate():
    server, engines, descs = cli_serve.build_server(
        _args("--family", "sd35", "--port", "0", "--prewarm"))
    import threading

    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        host, port = server.server_address[:2]
        body = json.dumps({"prompt": "a bowl of ramen", "seed": 4, "num_inference_steps": 8,
                           "guidance_scale": 3.5, "solver": "fmppo"}).encode()
        req = urllib.request.Request(f"http://{host}:{port}/v1/generate", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.load(r)
        image = decode_png(base64.b64decode(out["image_png_b64"]))
        assert image.shape == (16, 16, 3)
        assert isinstance(engines[0], SD3InferenceEngine) and descs[0].startswith("sd35")
        assert engines[0].stats()["prewarmed"] == 1
    finally:
        server.shutdown()
        for e in engines:
            e.shutdown()
        server.server_close()


@pytest.mark.parametrize("flags,match", [
    (("--shard",), "sd35 serves on one card"),
    (("--tp", "2"), "sd35 serves on one card"),
    (("--quantize",), "not wired for --family sd35"),
    (("--prewarm", "--prewarm-refine"), "sd35 has none"),
], ids=["shard", "tp", "quantize", "prewarm-refine"])
def test_cli_family_sd35_refusals(flags, match):
    with pytest.raises(SystemExit, match=match):
        cli_serve.build_server(_args("--family", "sd35", "--port", "0", *flags))


def test_engines_supply_their_family_defaults():
    """A request's omitted fields take its engine's family's defaults:
    SD3's are fmppo at the model card's guidance 3.5, SD-1.5's are
    ``GenerationRequest``'s own; only SD-1.5 has a refine signature."""
    from consolver_torch.serve import InferenceEngine

    req = SD3InferenceEngine.request(prompt="p", seed=3)
    assert (req.solver, req.guidance_scale, req.num_inference_steps) == ("fmppo", 3.5, 8)
    assert SD3InferenceEngine.request(prompt="p", solver="euler").solver == "euler"
    with pytest.raises(ValueError, match="no refine signature"):
        SD3InferenceEngine.request(prompt="p", refine=True)
    assert InferenceEngine.request(prompt="p") == GenerationRequest(prompt="p")
    assert (InferenceEngine.request(prompt="p", refine=True)
            == GenerationRequest(prompt="p", **InferenceEngine.REFINE_DEFAULTS))


def _post_json(host, port, path, body):
    req = urllib.request.Request(f"http://{host}:{port}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as err:
        return err.code, json.load(err)


def test_cli_family_sd35_bare_prompt_and_refine():
    """``serve --family sd35``: a body with the prompt alone is served with
    the family's defaults, the same image as the fields spelt out;
    ``/v1/refine`` is refused 400, not sent to a solver the engine lacks."""
    import threading

    server, engines, _ = cli_serve.build_server(_args("--family", "sd35", "--port", "0"))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        host, port = server.server_address[:2]
        code, bare = _post_json(host, port, "/v1/generate", {"prompt": "tea", "seed": 2})
        assert code == 200, bare
        code, full = _post_json(host, port, "/v1/generate", {
            "prompt": "tea", "seed": 2, "num_inference_steps": 8, "guidance_scale": 3.5,
            "solver": "fmppo"})
        assert code == 200 and full["image_png_b64"] == bare["image_png_b64"]
        code, out = _post_json(host, port, "/v1/refine", {"prompt": "tea", "seed": 2})
        assert code == 400 and "no refine signature" in out["error"]
        assert engines[0].stats()["errors"] == 0
    finally:
        server.shutdown()
        for e in engines:
            e.shutdown()
        server.server_close()


def test_cli_family_help_names_sd35():
    help_text = cli_serve._parser().format_help()
    assert "sd35" in help_text and "not sd35" in help_text


# ------------------------------------------------------------ checkpoints
def _hub_dir(tmp_path, state, name):
    d = tmp_path / name
    ck.save_sharded(state, str(d), max_shard_bytes=20_000)
    return str(d)


def test_hub_sd3_transformer(tmp_path):
    """diffusers' names: the patch convolution ``[out, in, 2, 2]`` and the
    ``[1, N, D]`` position table load into the port's linear and buffer."""
    src = _fill(SD3Transformer(MMDiTConfig.tiny(), device="cpu"), 50)
    hub = ck.hub_state_dict(src, "sd3_transformer")
    hub["pos_embed.proj.weight"] = hub["pos_embed.proj.weight"].reshape(48, 16, 2, 2)
    hub["pos_embed.pos_embed"] = hub["pos_embed.pos_embed"][None]
    assert "transformer_blocks.1.attn.to_add_out.weight" not in hub
    assert "transformer_blocks.0.attn.to_add_out.weight" in hub
    dst = ck.load_hub(SD3Transformer(MMDiTConfig.tiny(), device="meta"), "sd3_transformer",
                      _hub_dir(tmp_path, hub, "ok"), device="cpu")
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k
    extra = dict(hub, **{"transformer_blocks.1.attn.to_add_out.weight": torch.zeros(48, 48)})
    with pytest.raises(KeyError, match="no parameter"):
        ck.load_hub(SD3Transformer(MMDiTConfig.tiny(), device="meta"), "sd3_transformer",
                    _hub_dir(tmp_path, extra, "extra"), device="cpu")
    missing = {k: v for k, v in hub.items() if k != "pos_embed.pos_embed"}
    with pytest.raises(KeyError, match="no hub key"):
        ck.load_hub(SD3Transformer(MMDiTConfig.tiny(), device="meta"), "sd3_transformer",
                    _hub_dir(tmp_path, missing, "missing"), device="cpu")


@pytest.mark.parametrize("tower", ["clip_l", "clip_g"])
def test_hub_clip_text_proj(tmp_path, tower):
    """transformers' CLIPTextModelWithProjection names, ``text_projection``
    read (the clip_text kind skips it), ``position_ids`` skipped."""
    cfg = ClipTextProjConfig(**tiny_cfg()[tower])
    src = _fill(ClipTextEncoder(cfg, device="cpu"), 51)
    hub = ck.hub_state_dict(src, "clip_text_proj")
    hub["text_model.embeddings.position_ids"] = torch.arange(77)[None]
    dst = ck.load_hub(ClipTextEncoder(cfg, device="meta"), "clip_text_proj",
                      _hub_dir(tmp_path, hub, "ok"), device="cpu")
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k
    extra = dict(hub, **{"visual_projection.weight": torch.zeros(4, 4)})
    with pytest.raises(KeyError, match="no parameter"):
        ck.load_hub(ClipTextEncoder(cfg, device="meta"), "clip_text_proj",
                    _hub_dir(tmp_path, extra, "extra"), device="cpu")
    missing = {k: v for k, v in hub.items() if k != "text_projection.weight"}
    with pytest.raises(KeyError, match="no hub key"):
        ck.load_hub(ClipTextEncoder(cfg, device="meta"), "clip_text_proj",
                    _hub_dir(tmp_path, missing, "missing"), device="cpu")


# ------------------------------------------------------- operation counts
def _counted(fn):
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        fn()
    return fc.get_total_flops()


def test_operation_counts_match_flop_counter():
    """The benchmark's MMDiT and projected-CLIP counts against
    ``FlopCounterMode`` over the reference."""
    cfg = tiny_cfg()
    m = _fill(SD3Transformer(MMDiTConfig(**cfg["transformer"]), device="cpu"), 60)
    x, ctx, pooled = torch.randn(2, 8, 8, 16), torch.randn(2, 20, 32), torch.randn(2, 24)
    n = _counted(lambda: ref.mmdit(_Weights(m), cfg["transformer"], x, ctx, pooled,
                                   torch.ones(2)))
    assert n == pytest.approx(flops_sd3.mmdit(cfg["transformer"], 2, 16, 20).flops, rel=1e-9)
    enc = _fill(ClipTextEncoder(ClipTextProjConfig(**cfg["clip_g"]), device="cpu"), 61)
    ids = torch.randint(3, 1000, (2, 77))
    assert _counted(lambda: ref.clip_tower(_Weights(enc), cfg["clip_g"], ids)) == pytest.approx(
        flops_sd3.clip_text_proj(cfg["clip_g"], 2).flops, rel=1e-9)


def test_full_width_operation_counts():
    """At the published widths: about 31 TFLOP an MMDiT row-forward at 4096
    patches and 333 context tokens, a quarter of it the 38 joint attentions
    at [4429, 4429, 64]."""
    cfg = run.load_json(run.BENCH_DIR / "configs" / "sd35-large-preview.json")
    c = flops_sd3.mmdit(cfg["transformer"], 2, 4096, 333)
    assert c.attn == [(2, 38, 4429, 4429, 64)] * 38
    attn = sum(flops.attention_flops(*a) for a in c.attn)
    assert c.flops / 2 == pytest.approx(31.3e12, rel=0.03)
    assert 0.2 < attn / c.flops < 0.3


# ------------------------------------------- the paths SD3 shares, unchanged
PARENT = np.load(ROOT / "tests" / "data" / "sd35_parent_outputs.npz")
# recorded on the CPU from the tree before SD3 (f32); 1e-6 absorbs another
# SIMD width's order of summation in LayerNorm and matmul reductions
PARENT_TOL = dict(rtol=1e-6, atol=1e-6)


def _parent_fill(module, seed):
    return _fill(module, seed, std=0.1)


def test_flux_double_stream_block_unchanged():
    """FLUX's block with RoPE, as before the SD3 options."""
    block = _parent_fill(DoubleStreamBlock(FluxConfig.tiny()), 1234)
    rng = np.random.RandomState(7)
    img = torch.from_numpy(rng.standard_normal((2, 12, 48)).astype(np.float32))
    txt = torch.from_numpy(rng.standard_normal((2, 5, 48)).astype(np.float32))
    vec = torch.from_numpy(rng.standard_normal((2, 48)).astype(np.float32))
    ids = torch.from_numpy(rng.randint(0, 6, (17, 3)).astype(np.float32))
    cos, sin = rope_freqs(ids, (8, 8, 8))
    with torch.no_grad():
        img_out, txt_out = block(img, txt, vec, cos, sin)
    torch.testing.assert_close(img_out, torch.from_numpy(PARENT["flux_img"]), **PARENT_TOL)
    torch.testing.assert_close(txt_out, torch.from_numpy(PARENT["flux_txt"]), **PARENT_TOL)


def test_sd15_clip_unchanged():
    """SD-1.5's last-state path and FLUX's pooled path, as before."""
    enc = _parent_fill(ClipTextEncoder(ClipTextConfig.tiny(), device="cpu"), 99)
    rng = np.random.RandomState(11)
    ids = rng.randint(3, 1000, (2, 77)).astype(np.int64)
    ids[:, 0], ids[0, 9:], ids[0, 8] = 1, 0, 2
    ids = torch.from_numpy(ids)
    with torch.no_grad():
        last = enc(ids)
        last2, pooled = enc(ids, return_pooled=True)
    torch.testing.assert_close(last, torch.from_numpy(PARENT["clip_last"]), **PARENT_TOL)
    torch.testing.assert_close(last2, last, rtol=0, atol=0)
    torch.testing.assert_close(pooled, torch.from_numpy(PARENT["clip_pooled"]), **PARENT_TOL)
