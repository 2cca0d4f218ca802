"""Stable Diffusion 3.5 Large previews as ``serve --family sd35`` deploys
them: the port's ``SD3InferenceEngine`` (batch 1, T5 max length 256, 1024²)
behind ``serve/http.make_server`` on 127.0.0.1, port 0.

``build`` makes the MMDiT, CLIP-L, bigG, T5-XXL and the 16-channel VAE on
``meta`` in bf16, fills them on the card from the seed with the FM
FactorNet (T5's weights at T5's own initialisation scales,
:func:`t5_scale`), and starts the server.  ``check`` works the sampled previews out
again with the plain reference (``perfbench/reference/sd35.py``) after the
program is freed, and compares the served images with them.
"""

from __future__ import annotations

import sys
from typing import Dict, List

from perfbench.lib import flops, flops_sd3
from perfbench.lib.serving import Served, image_numbers, split_compared
from perfbench.lib.weights import STD, WeightSource, fill_

CLIP_TOKENS = 77

# T5's own initialisation (transformers' T5PreTrainedModel._init_weights,
# factor 1), by the name's end: the standard deviation from the T5 config
T5_INIT = (
    ("attention.q.weight", lambda c: (c["d_model"] * c["d_kv"]) ** -0.5),
    ("attention.k.weight", lambda c: c["d_model"] ** -0.5),
    ("attention.v.weight", lambda c: c["d_model"] ** -0.5),
    ("attention.o.weight", lambda c: (c["num_heads"] * c["d_kv"]) ** -0.5),
    ("wi_0.weight", lambda c: c["d_model"] ** -0.5),
    ("wi_1.weight", lambda c: c["d_model"] ** -0.5),
    ("wo.weight", lambda c: c["d_ff"] ** -0.5),
    ("relative_attention_bias.weight", lambda c: c["d_model"] ** -0.5),
    ("shared.weight", lambda c: 1.0),
)


def t5_scale(name: str, t5: dict) -> float:
    """The factor that takes a T5 weight drawn at ``STD * N(0, 1)`` to T5's
    own initialisation scale; 1 for the norm scales (``1 + STD * N``).  At
    a uniform 0.02 the unscaled attention's logits are about 13x sharper
    than T5's initialisation gives, and bf16 rounding then moves the 24
    layers' output 65 % from f32's, which the image comparison cannot see
    past."""
    for suffix, std in T5_INIT:
        if name.endswith(suffix):
            return std(t5) / STD
    return 1.0


class _ScaledWeights:
    """A :class:`WeightSource` whose tensors are scaled in the served dtype,
    as :func:`build` scales the program's."""

    def __init__(self, source: WeightSource, scale):
        self.source, self.scale = source, scale

    def __call__(self, name: str):
        f = self.scale(name)
        return (self.source.get(name) * f).float() if f != 1.0 else self.source(name)

    def has(self, name: str) -> bool:
        return self.source.has(name)


def weights_for(cfg: dict, seed: int, layouts: dict, device) -> Dict[str, object]:
    """The reference's weight getters: every model's weights drawn again
    from the seed, T5's scaled as :func:`build` scales them."""
    weights = {tag: WeightSource(seed, tag, layout, device) for tag, layout in layouts.items()}
    weights["t5"] = _ScaledWeights(weights["t5"], lambda name: t5_scale(name, cfg["t5"]))
    return weights


class System(Served):
    """The SD3.5 Large preview server as the harness sees it."""

    def modules(self) -> Dict[str, object]:
        p = self.pipeline
        return {"pb.mmdit": p.transformer, "pb.t5": p.t5, "pb.clip": p.clip_l,
                "pb.clip_g": p.clip_g, "pb.vae_decode": p.vae.decoder}

    def request(self, text: str, seed: int, source=None) -> tuple:
        pipe = self.cfg["pipeline"]
        return "/v1/generate", {
            "prompt": text, "seed": int(seed), "num_inference_steps": pipe["num_inference_steps"],
            "guidance_scale": pipe["guidance_scale"], "solver": pipe["solver"],
            "deterministic": pipe["deterministic"]}

    def counts(self, span: str, rows: int) -> flops.Count:
        cfg = self.cfg
        lat = cfg["pipeline"]["resolution"] // 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
        text = cfg["pipeline"]["t5_max_length"]
        if span == "pb.mmdit":
            patch = cfg["transformer"]["patch_size"]
            return flops_sd3.mmdit(cfg["transformer"], rows, (lat // patch) ** 2,
                                   CLIP_TOKENS + text)
        if span == "pb.t5":
            return flops.t5(cfg["t5"], rows, text)
        if span == "pb.clip":
            return flops_sd3.clip_text_proj(cfg["clip_l"], rows)
        if span == "pb.clip_g":
            return flops_sd3.clip_text_proj(cfg["clip_g"], rows)
        return flops.vae_decode(cfg["vae"], rows, lat)


def _program_configs(cfg):
    from consolver_torch.models.clip_text import ClipTextProjConfig
    from consolver_torch.models.mmdit import MMDiTConfig
    from consolver_torch.models.t5 import T5Config
    from consolver_torch.models.vae import VaeConfig
    from consolver_torch.policy.factor_net import FactorNetConfig

    v = dict(cfg["vae"])
    v["block_out_channels"] = tuple(v["block_out_channels"])
    f = {k: cfg["factor_net"][k] for k in ("num_actions", "hidden_dim", "order_dim",
                                           "scaler_dim", "family")}
    return (MMDiTConfig(**cfg["transformer"]), ClipTextProjConfig(**cfg["clip_l"]),
            ClipTextProjConfig(**cfg["clip_g"]), T5Config(**cfg["t5"]), VaeConfig(**v),
            FactorNetConfig(**f))


def build(cfg: dict, seed: int, device, variant: str = None) -> System:
    """The deployment with seeded weights, its server listening.  ``variant``
    ``int8`` serves the program's W8A8 int8 pipeline (``quantize()``: the
    MMDiT blocks' projections and the VAE decoder): the control."""
    import torch

    from consolver_torch.core.schedules import FlowMatchConfig
    from consolver_torch.models.clip_text import ClipTextEncoder
    from consolver_torch.models.mmdit import SD3Transformer
    from consolver_torch.models.t5 import T5Encoder
    from consolver_torch.models.vae import AutoencoderKL
    from consolver_torch.pipelines.sd3 import SD3Pipeline
    from consolver_torch.policy.factor_net import FactorNet
    from consolver_torch.serve.engine import SD3InferenceEngine
    from consolver_torch.serve.http import make_server

    dtype = getattr(torch, cfg["dtype"])
    mcfg, lcfg, gcfg, t5cfg, vcfg, fcfg = _program_configs(cfg)
    models = {
        "transformer": SD3Transformer(mcfg, device="meta", dtype=dtype),
        "clip_l": ClipTextEncoder(lcfg, device="meta", dtype=dtype),
        "clip_g": ClipTextEncoder(gcfg, device="meta", dtype=dtype),
        "t5": T5Encoder(t5cfg, device="meta", dtype=dtype),
        "vae": AutoencoderKL(vcfg, device="meta", dtype=dtype),
    }
    layouts = {}
    for tag, m in models.items():
        models[tag] = m.to_empty(device=device)
        layouts[tag] = fill_(models[tag], seed, tag)
    models["transformer"].init_pos_embed_()  # a buffer: computed, not drawn
    with torch.no_grad():
        for name, param in models["t5"].named_parameters():
            f = t5_scale(name, cfg["t5"])
            if f != 1.0:
                param.mul_(f)
    policy = FactorNet(fcfg, device=device)
    layouts["factor_net"] = fill_(policy, seed, "factor_net")
    fm, p = cfg["flow_match"], cfg["pipeline"]
    pipe = SD3Pipeline(models["transformer"], models["clip_l"], models["clip_g"], models["t5"],
                       models["vae"],
                       fm_config=FlowMatchConfig(num_train_timesteps=fm["num_train_timesteps"],
                                                 shift=fm["shift"]),
                       factor_net=policy, vae_scaling_factor=vcfg.scaling_factor,
                       vae_shift_factor=p["vae_shift_factor"], t5_max_length=p["t5_max_length"],
                       device=device)
    if variant == "int8":
        pipe = pipe.quantize()
    elif variant is not None:
        raise ValueError(f"unknown variant {variant!r}")
    serving = cfg["serving"]
    lat = p["resolution"] // 2 ** (len(vcfg.block_out_channels) - 1)
    engine = SD3InferenceEngine(pipe, batch_size=max(serving["batch_sizes"]),
                                batch_sizes=tuple(serving["batch_sizes"]),
                                latent_size=lat, flush_ms=serving["flush_ms"],
                                adaptive_flush=serving["adaptive_flush"])
    server = make_server(engine, host="127.0.0.1", port=0)
    return System(cfg, pipe, engine, server, layouts)


def check(cfg: dict, seed: int, layouts: dict, sample: List[dict], device) -> Dict[str, tuple]:
    """Compare each sampled served preview with the reference's.  ``sample``
    items: ``text``, ``seed``, ``batch`` (padded seed list, slot) and the
    served ``image``.  Returns name -> (value, limit)."""
    import torch

    from perfbench.reference import common, sd35

    common.exact_f32()
    weights = weights_for(cfg, seed, layouts, device)
    with torch.no_grad():
        ref = sd35.previews(weights, cfg, [s["text"] for s in sample], [s["seed"] for s in sample],
                            [s["batch"] for s in sample], device)
    numbers = image_numbers([s["image"] for s in sample], ref)
    return split_compared(numbers, cfg["check"]["limits"], sys.stderr)
