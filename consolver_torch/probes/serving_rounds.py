"""Probe: rounds of sampled and deterministic SD-1.5 batches through the
serving engine, at full width on the card.

    python -m consolver_torch.probes.serving_rounds [--rounds 5]

Builds the SD-1.5 UNet, CLIP text encoder and VAE in bf16 (random-normal
x0.02 weights from ``--seed``), a FactorNet and an ``InferenceEngine`` (batch
8, 8 steps, CFG 3, 512^2), prewarms both programs, then times ``--rounds``
rounds of 8 requests submitted together (one batch each): sampled requests,
then deterministic ones (mode actions, the slot-invariant program).  Prints
one JSON line with the card's name, each round's seconds and the img/s of
each kind.  It uses only the engine's public API, so the same file run from
two checkouts in turns compares them on one card.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from consolver_torch.core.schedules import DiffusionSchedule
from consolver_torch.data.tokenizer import HashTokenizer
from consolver_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
from consolver_torch.models.unet_2d import UNet2DCondition, UNetConfig
from consolver_torch.models.vae import AutoencoderKL, VaeConfig
from consolver_torch.pipelines.t2i import TextToImagePipeline
from consolver_torch.policy.factor_net import FactorNet, FactorNetConfig
from consolver_torch.serve import GenerationRequest, InferenceEngine

BATCH, STEPS, CFG = 8, 8, 3.0


def _pipeline(seed: int) -> TextToImagePipeline:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    models = [cls(cfg, device="meta", dtype=torch.bfloat16).to_empty(device="cuda")
              for cls, cfg in ((UNet2DCondition, UNetConfig.sd15()),
                               (ClipTextEncoder, ClipTextConfig.sd15()),
                               (AutoencoderKL, VaeConfig.sd15()))]
    with torch.no_grad():
        for model in models:
            for p in model.parameters():
                p.normal_(0.0, 0.02, generator=gen)
    policy = FactorNet(FactorNetConfig(order_dim=4, scaler_dim=0, num_actions=11, family="sd"),
                       device="cuda")
    return TextToImagePipeline(*models, DiffusionSchedule.sd15(), factor_net=policy,
                               tokenizer=HashTokenizer(), device="cuda")


def run(rounds: int, seed: int) -> dict:
    torch.manual_seed(seed)
    engine = InferenceEngine(_pipeline(seed), batch_size=BATCH, latent_size=64, flush_ms=250.0)

    def request(i, deterministic):
        return GenerationRequest(f"prompt {i}", seed=1000 + i, num_inference_steps=STEPS,
                                 guidance_scale=CFG, deterministic=deterministic)

    out = {"device": torch.cuda.get_device_name(0), "batch": BATCH, "steps": STEPS}
    try:
        engine.prewarm(request(0, False), request(0, True), timeout=600)
        for kind, deterministic in (("sampled", False), ("deterministic", True)):
            round_s = []
            for r in range(rounds):
                t0 = time.perf_counter()
                futures = [engine.submit(request(r * BATCH + i, deterministic))
                           for i in range(BATCH)]
                for f in futures:
                    f.result(timeout=600)
                round_s.append(time.perf_counter() - t0)
            out[kind] = {"round_s": round_s, "img_per_s": BATCH * rounds / sum(round_s)}
        out["batches"] = engine.stats()["batches"]
    finally:
        engine.shutdown()
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=5)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(json.dumps(run(args.rounds, args.seed)), flush=True)


if __name__ == "__main__":
    main()
