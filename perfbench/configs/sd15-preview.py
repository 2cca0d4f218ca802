"""SD-1.5 preview serving, as the README deploys it: the port's
``InferenceEngine`` behind ``serve/http.make_server`` on 127.0.0.1, port 0.

``build`` makes the UNet, CLIP text encoder and VAE on ``meta`` in bf16,
fills them on the card from the seed (``perfbench/lib/weights.py``) with the
FactorNet, and starts the server.  ``check`` works the sampled previews out
again with the plain reference (``perfbench/reference/sd15.py``) after the
program is freed, and compares the served images with them.
"""

from __future__ import annotations

import sys
from typing import Dict, List

from perfbench.lib import flops
from perfbench.lib.serving import Served, image_numbers, split_compared
from perfbench.lib.weights import WeightSource, fill_


class System(Served):
    """The SD-1.5 preview server as the harness sees it."""

    def modules(self) -> Dict[str, object]:
        p = self.pipeline
        return {"pb.unet": p.unet, "pb.text": p.text_encoder, "pb.vae_decode": p.vae.decoder}

    def request(self, text: str, seed: int, source=None) -> tuple:
        pipe = self.cfg["pipeline"]
        return "/v1/generate", {
            "prompt": text, "seed": int(seed), "num_inference_steps": pipe["num_inference_steps"],
            "guidance_scale": pipe["guidance_scale"], "solver": pipe["solver"],
            "deterministic": pipe["deterministic"]}

    def counts(self, span: str, rows: int) -> flops.Count:
        cfg, latent = self.cfg, self.cfg["pipeline"]["resolution"] // 8
        if span == "pb.unet":
            return flops.unet(cfg["unet"], rows, latent)
        if span == "pb.text":
            return flops.clip_text(cfg["text_encoder"], rows)
        return flops.vae_decode(cfg["vae"], rows, latent)


def _program_configs(cfg):
    from consolver_torch.models.clip_text import ClipTextConfig
    from consolver_torch.models.unet_2d import UNetConfig
    from consolver_torch.models.vae import VaeConfig
    from consolver_torch.policy.factor_net import FactorNetConfig

    u = dict(cfg["unet"])
    u["block_out_channels"] = tuple(u["block_out_channels"])
    u["cross_attn_blocks"] = tuple(u["cross_attn_blocks"])
    v = dict(cfg["vae"])
    v["block_out_channels"] = tuple(v["block_out_channels"])
    f = {k: cfg["factor_net"][k] for k in ("num_actions", "hidden_dim", "order_dim",
                                           "scaler_dim", "family")}
    return UNetConfig(**u), VaeConfig(**v), ClipTextConfig(**cfg["text_encoder"]), FactorNetConfig(**f)


def build(cfg: dict, seed: int, device, variant: str = None) -> System:
    """The deployment with seeded weights, its server listening.  ``variant``
    ``int8`` serves the program's W8A8 int8 pipeline (``quantize()``, UNet
    level 0 float): the control."""
    import torch

    from consolver_torch.core.schedules import DiffusionSchedule
    from consolver_torch.data.tokenizer import HashTokenizer
    from consolver_torch.models.clip_text import ClipTextEncoder
    from consolver_torch.models.unet_2d import UNet2DCondition
    from consolver_torch.models.vae import AutoencoderKL
    from consolver_torch.pipelines.t2i import TextToImagePipeline
    from consolver_torch.policy.factor_net import FactorNet
    from consolver_torch.serve.engine import InferenceEngine
    from consolver_torch.serve.http import make_server

    dtype = getattr(torch, cfg["dtype"])
    ucfg, vcfg, tcfg, fcfg = _program_configs(cfg)
    models = {
        "unet": UNet2DCondition(ucfg, device="meta", dtype=dtype),
        "text_encoder": ClipTextEncoder(tcfg, device="meta", dtype=dtype),
        "vae": AutoencoderKL(vcfg, device="meta", dtype=dtype),
    }
    layouts = {}
    for tag, m in models.items():
        models[tag] = m.to_empty(device=device)
        layouts[tag] = fill_(models[tag], seed, tag)
    policy = FactorNet(fcfg, device=device)
    layouts["factor_net"] = fill_(policy, seed, "factor_net")
    sched = cfg["schedule"]
    schedule = DiffusionSchedule.create(sched["num_train_timesteps"], sched["beta_start"],
                                        sched["beta_end"], "scaled_linear")
    pipe = TextToImagePipeline(models["unet"], models["text_encoder"], models["vae"], schedule,
                               factor_net=policy, timestep_spacing=sched["timestep_spacing"],
                               tokenizer=HashTokenizer(vocab_size=tcfg.vocab_size), device=device)
    if variant == "int8":
        pipe = pipe.quantize()
    elif variant is not None:
        raise ValueError(f"unknown variant {variant!r}")
    serving = cfg["serving"]
    engine = InferenceEngine(pipe, batch_size=max(serving["batch_sizes"]),
                             batch_sizes=tuple(serving["batch_sizes"]),
                             latent_size=cfg["pipeline"]["resolution"] // 8,
                             flush_ms=serving["flush_ms"], adaptive_flush=serving["adaptive_flush"])
    server = make_server(engine, host="127.0.0.1", port=0)
    return System(cfg, pipe, engine, server, layouts)


def check(cfg: dict, seed: int, layouts: dict, sample: List[dict], device) -> Dict[str, tuple]:
    """Compare each sampled served image with the reference's.  ``sample``
    items: ``text``, ``seed``, ``batch`` (padded seed list, slot) and the
    served ``image``.  Returns name -> (value, limit)."""
    import torch

    from perfbench.reference import common, sd15

    common.exact_f32()
    weights = {tag: WeightSource(seed, tag, layout, device) for tag, layout in layouts.items()}
    with torch.no_grad():
        ref = sd15.previews(weights, cfg, [s["text"] for s in sample], [s["seed"] for s in sample],
                            [s["batch"] for s in sample], device)
    numbers = image_numbers([s["image"] for s in sample], ref)
    return split_compared(numbers, cfg["check"]["limits"], sys.stderr)
