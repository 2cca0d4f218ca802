"""The benchmark's operation counts against an independent count:
``torch.utils.flop_counter.FlopCounterMode`` over the plain reference at
small shapes (every matrix product and convolution, 2 per multiply-add)."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.lib import flops
from perfbench.lib.weights import WeightSource, fill_, layout_of
from perfbench.reference import common, flux, sd15
from perfbench import run
from perfbench.tests import tiny


def _source(module, tag):
    fill_(module, 7, tag)
    return WeightSource(7, tag, layout_of(module), "cpu")


def _counted(fn):
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("shape", [(2, 3, 50, 77, 16), (1, 1, 64, 64, 8)])
def test_attention_count(shape):
    b, h, sq, sk, d = shape
    q, k, v = torch.randn(b, sq, h, d), torch.randn(b, sk, h, d), torch.randn(b, sk, h, d)
    assert _counted(lambda: common.attention(q, k, v)) == flops.attention_flops(*shape)


def test_attention_bound():
    op_s, by = flops.attention_bound_s((1, 24, 8320, 8320, 128))
    assert by == "operations" and op_s == pytest.approx(4 * 24 * 8320**2 * 128 / 989e12)
    assert flops.attention_bound_s((16, 8, 4096, 77, 40))[1] == "bytes"


def _sd_models(cfg):
    from consolver_torch.models.clip_text import ClipTextEncoder
    from consolver_torch.models.unet_2d import UNet2DCondition
    from consolver_torch.models.vae import AutoencoderKL

    mod = run.load_module(run.BENCH_DIR / "configs" / "sd15-preview.py")
    ucfg, vcfg, tcfg, _ = mod._program_configs(cfg)
    return (_source(UNet2DCondition(ucfg, device="cpu"), "unet"),
            _source(ClipTextEncoder(tcfg, device="cpu"), "text"),
            _source(AutoencoderKL(vcfg, device="cpu"), "vae"))


def test_sd_counts():
    cfg = tiny.cell("sd15-preview-poisson")[1]
    wu, wt, wv = _sd_models(cfg)
    rows, latent = 3, 8
    x = torch.randn(rows, cfg["unet"]["in_channels"], latent, latent)
    ctx = torch.randn(rows, 77, cfg["unet"]["cross_attention_dim"])
    t = torch.full((rows,), 500)
    assert _counted(lambda: sd15.unet(wu, cfg["unet"], x, t, ctx)) == pytest.approx(
        flops.unet(cfg["unet"], rows, latent).flops, rel=1e-9)
    ids = torch.randint(0, 100, (2, 77))
    assert _counted(lambda: sd15.clip_text(wt, cfg["text_encoder"], ids)) == pytest.approx(
        flops.clip_text(cfg["text_encoder"], 2).flops, rel=1e-9)
    z = torch.randn(2, cfg["vae"]["latent_channels"], latent, latent)
    assert _counted(lambda: sd15.vae_decode(wv, cfg["vae"], z)) == pytest.approx(
        flops.vae_decode(cfg["vae"], 2, latent).flops, rel=1e-9)
    img = torch.randn(2, 3, 16, 16)
    assert _counted(lambda: sd15.vae_encode_mean(wv, cfg["vae"], img)) == pytest.approx(
        flops.vae_encode(cfg["vae"], 2, 16).flops, rel=1e-9)


def test_sd15_full_width_numbers():
    """At the cell's widths: about 0.8 TFLOP per UNet row-forward."""
    cfg = run.load_json(run.BENCH_DIR / "configs" / "sd15-preview.json")
    assert flops.unet(cfg["unet"], 1, 64).flops == pytest.approx(0.80e12, rel=0.03)
    # 32 attention calls a forward: 16 transformer blocks, self and cross
    assert len(flops.unet(cfg["unet"], 1, 64).attn) == 32


def test_flux_counts():
    from consolver_torch.models.flux import FluxConfig, FluxTransformer
    from consolver_torch.models.t5 import T5Config, T5Encoder

    cfg = tiny.cell("flux-kontext-edit-serial")[1]
    t = dict(cfg["transformer"], axes_dims=tuple(cfg["transformer"]["axes_dims"]))
    wd = _source(FluxTransformer(FluxConfig(**t), device="cpu"), "dit")
    w5 = _source(T5Encoder(T5Config(**cfg["t5"]), device="cpu"), "t5")
    img_tokens, txt_tokens = 32, 16
    img = torch.randn(1, img_tokens, t["in_channels"])
    txt = torch.randn(1, txt_tokens, t["joint_text_dim"])
    pooled = torch.randn(1, t["pooled_text_dim"])
    ids = torch.zeros(img_tokens, 3)
    args = (img, txt, pooled, torch.ones(1), torch.ones(1), ids, torch.zeros(txt_tokens, 3))
    assert _counted(lambda: flux.dit(wd, t, *args)) == pytest.approx(
        flops.dit(t, 1, img_tokens, txt_tokens).flops, rel=1e-9)
    t5_ids = torch.randint(0, 100, (1, txt_tokens))
    assert _counted(lambda: flux.t5_encode(w5, cfg["t5"], t5_ids)) == pytest.approx(
        flops.t5(cfg["t5"], 1, txt_tokens).flops, rel=1e-9)


def test_flux_full_width_numbers():
    """At the cell's widths: 1.56e14 operations a DiT forward at 8192 image
    and 128 text tokens.  Not 2 x 11.9e9 x 8320: the modulation projections
    (3.2e9 parameters) see one row, the text stream's (2.2e9) 128 tokens."""
    cfg = run.load_json(run.BENCH_DIR / "configs" / "flux-kontext-edit.json")
    c = flops.dit(cfg["transformer"], 1, 8192, 128)
    assert c.flops == pytest.approx(1.559e14, rel=0.002)
    assert c.attn == [(1, 24, 8320, 8320, 128)] * 57
