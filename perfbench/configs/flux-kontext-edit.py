"""FLUX.1-Kontext edit serving with the serve CLI's defaults: the port's
``EditInferenceEngine`` (batch 1, T5 max length 128, 1024^2) behind
``serve/http.make_server`` on 127.0.0.1, port 0.

``build`` makes the DiT, T5-XXL, CLIP-L and the 16-channel VAE on ``meta``
in bf16, fills them on the card from the seed with the FM FactorNet, and
starts the server.  ``check`` works the sampled edits out again with the
plain reference (``perfbench/reference/flux.py``) after the program is
freed, and compares the served images with them.
"""

from __future__ import annotations

import sys
from typing import Dict, List

from perfbench.lib import flops
from perfbench.lib.serving import Served, image_numbers, split_compared
from perfbench.lib.weights import WeightSource, fill_


class System(Served):
    """The FLUX-Kontext edit server as the harness sees it."""

    def modules(self) -> Dict[str, object]:
        p = self.pipeline
        return {"pb.dit": p.transformer, "pb.t5": p.t5, "pb.clip": p.clip,
                "pb.vae_encode": p.vae.encoder, "pb.vae_decode": p.vae.decoder}

    def request(self, text: str, seed: int, source=None) -> tuple:
        pipe = self.cfg["pipeline"]
        return "/v1/edit", {
            "instruction": text, "image_png_b64": source, "seed": int(seed),
            "num_inference_steps": pipe["num_inference_steps"],
            "guidance_scale": pipe["guidance_scale"], "solver": pipe["solver"],
            "deterministic": pipe["deterministic"]}

    def counts(self, span: str, rows: int) -> flops.Count:
        cfg, res = self.cfg, self.cfg["pipeline"]["resolution"]
        lat = res // 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
        text = cfg["pipeline"]["t5_max_length"]
        if span == "pb.dit":  # the target's tokens and the reference's, then the text
            return flops.dit(cfg["transformer"], rows, 2 * (lat // 2) ** 2, text)
        if span == "pb.t5":
            return flops.t5(cfg["t5"], rows, text)
        if span == "pb.clip":
            return flops.clip_text(cfg["clip"], rows)
        if span == "pb.vae_encode":
            return flops.vae_encode(cfg["vae"], rows, res)
        return flops.vae_decode(cfg["vae"], rows, lat)


def build(cfg: dict, seed: int, device, variant: str = None) -> System:
    """The deployment with seeded weights, its server listening.  ``variant``
    ``int8`` serves the program's W8A8 int8 pipeline (``quantize(8)``): the
    control."""
    import torch

    from consolver_torch.data.tokenizer import HashTokenizer
    from consolver_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
    from consolver_torch.models.flux import FluxConfig, FluxTransformer
    from consolver_torch.models.t5 import T5Config, T5Encoder
    from consolver_torch.models.vae import AutoencoderKL, VaeConfig
    from consolver_torch.pipelines.edit import FluxKontextPipeline
    from consolver_torch.policy.factor_net import FactorNet, FactorNetConfig
    from consolver_torch.serve.engine import EditInferenceEngine
    from consolver_torch.serve.http import make_server

    dtype = getattr(torch, cfg["dtype"])
    t = dict(cfg["transformer"])
    t["axes_dims"] = tuple(t["axes_dims"])
    v = dict(cfg["vae"])
    v["block_out_channels"] = tuple(v["block_out_channels"])
    f = {k: cfg["factor_net"][k] for k in ("num_actions", "hidden_dim", "order_dim",
                                           "scaler_dim", "family")}
    models = {
        "transformer": FluxTransformer(FluxConfig(**t), device="meta", dtype=dtype),
        "t5": T5Encoder(T5Config(**cfg["t5"]), device="meta", dtype=dtype),
        "clip": ClipTextEncoder(ClipTextConfig(**cfg["clip"]), device="meta", dtype=dtype),
        "vae": AutoencoderKL(VaeConfig(**v), device="meta", dtype=dtype),
    }
    layouts = {}
    for tag, m in models.items():
        models[tag] = m.to_empty(device=device)
        layouts[tag] = fill_(models[tag], seed, tag)
    policy = FactorNet(FactorNetConfig(**f), device=device)
    layouts["factor_net"] = fill_(policy, seed, "factor_net")
    pipe = FluxKontextPipeline(models["transformer"], models["t5"], models["clip"], models["vae"],
                               factor_net=policy, vae_scaling_factor=v["scaling_factor"],
                               vae_shift_factor=cfg["pipeline"]["vae_shift_factor"], device=device)
    if variant == "int8":
        pipe = pipe.quantize(bits=8)
    elif variant is not None:
        raise ValueError(f"unknown variant {variant!r}")
    serving, p = cfg["serving"], cfg["pipeline"]
    engine = EditInferenceEngine(
        pipe, resolution=p["resolution"], batch_size=max(serving["batch_sizes"]),
        batch_sizes=tuple(serving["batch_sizes"]),
        t5_tokenizer=HashTokenizer(vocab_size=cfg["t5"]["vocab_size"], max_length=p["t5_max_length"]),
        clip_tokenizer=HashTokenizer(vocab_size=cfg["clip"]["vocab_size"], max_length=77),
        t5_max_length=p["t5_max_length"], clip_max_length=77, flush_ms=serving["flush_ms"],
        adaptive_flush=serving["adaptive_flush"])
    server = make_server(edit_engine=engine, host="127.0.0.1", port=0)
    return System(cfg, pipe, engine, server, layouts)


def check(cfg: dict, seed: int, layouts: dict, sample: List[dict], device) -> Dict[str, tuple]:
    """Compare each sampled served edit with the reference's.  ``sample``
    items: ``text``, ``seed``, ``source`` (the uint8 image sent), ``batch``
    and the served ``image``.  Returns name -> (value, limit)."""
    import torch

    from perfbench.reference import common, flux

    common.exact_f32()
    weights = {tag: WeightSource(seed, tag, layout, device) for tag, layout in layouts.items()}
    with torch.no_grad():
        ref = flux.edits(weights, cfg, [s["text"] for s in sample], [s["source"] for s in sample],
                         [s["seed"] for s in sample], [s["batch"] for s in sample], device)
    numbers = image_numbers([s["image"] for s in sample], ref)
    return split_compared(numbers, cfg["check"]["limits"], sys.stderr)
