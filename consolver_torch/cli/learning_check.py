"""End-to-end learning check of the SD PPO loop on a miniature objective:
``python -m consolver_torch.cli.learning_check [--quantize] [--device cpu]``.

Port of ``scripts/learning_check.py``.  The teacher is a 40-step DDIM of a
tiny random UNet over 8 prompts; the FactorNet must learn coefficients that
bring 3-step previews closer to the teacher's latents than its zero-init
(DDIM-like) policy does.  Each of 240 PPO steps rolls out one prompt's
batch of 16, scores it with ``image_psnr`` and updates the policy
(``PPOConfig(ppo_epochs=1, lr=3e-3, entropy_coef=0.003,
advantage_scale=10)``); teacher and student condition the CFG branch on
the tokenized empty prompt.  The check prints "LEARNING" when the mean
reward of the last 60 steps beats that of the first 60 by more than 0.05.
``--quantize`` rolls the student out through the int8 path
(``TextToImagePipeline.quantize()``) against the float teacher.

The tiny stack is the JAX script's configs (``UNetConfig.tiny()``,
``ClipTextConfig.tiny()``, ``VaeConfig.tiny()``), drawn from a seed from the
JAX package's default initialisers (:func:`flax_default_init_`, numpy
draws, the same on every PyTorch version and device), as is the policy:
PyTorch's own defaults are sqrt(3) smaller per layer, and on this stack
they leave every prompt's reward the same, so that PPO has nothing to learn
from.
:func:`run` also takes the three models from outside (for example
converted JAX parameters).
"""

from __future__ import annotations

import argparse
import tempfile
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from consolver_torch.configs.config import add_device_flag
from consolver_torch.device import resolve_device

PROMPTS = 8
BATCH = 16
TEACHER_STEPS = 40
GUIDANCE = 3.0
STEPS = 240
WINDOW = 60
MARGIN = 0.05
LATENT = 8
TEXT_LEN = 4


def _trunc_normal(rng: np.random.Generator, shape, std: float) -> torch.Tensor:
    """``std`` times a standard normal truncated to [-2, 2] (the JAX
    initialisers' truncation), drawn by rejection from ``rng``."""
    z = rng.standard_normal(shape)
    bad = np.abs(z) > 2
    while bad.any():
        z[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(z) > 2
    return torch.from_numpy((std * z).astype(np.float32))


def flax_default_init_(module: torch.nn.Module, rng: np.random.Generator) -> torch.nn.Module:
    """The JAX package's default initialisers, drawn from ``rng`` (numpy, so
    that every PyTorch version and device gets the same weights): linear and
    conv weights truncated-normal LeCun (std ``1 / sqrt(fan_in)``),
    embeddings normal with std ``1 / sqrt(dim)``, biases 0, norm scales 1."""
    with torch.no_grad():
        for m in module.modules():
            w = getattr(m, "weight", None)
            if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d)):
                fan_in = w[0].numel()
                # 0.8796: the std of a standard normal truncated to [-2, 2]
                w.copy_(_trunc_normal(rng, w.shape, (1.0 / fan_in) ** 0.5 / 0.87962566103423978))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, torch.nn.Embedding):
                w.copy_(torch.from_numpy(
                    (rng.standard_normal(w.shape) / w.shape[1] ** 0.5).astype(np.float32)))
            elif isinstance(m, (torch.nn.LayerNorm, torch.nn.GroupNorm)):
                if w is not None:
                    w.fill_(1.0)
                if m.bias is not None:
                    m.bias.zero_()
    return module


def flax_policy(config, seed: int, device):
    """A FactorNet drawn as the JAX package draws it (:func:`flax_default_init_`;
    the SD family's head stays zero)."""
    from consolver_torch.policy.factor_net import FactorNet

    net = flax_default_init_(FactorNet(config, device="cpu"), np.random.default_rng(seed))
    if config.zero_init_head:
        with torch.no_grad():
            net.head.weight.zero_()
            net.head.bias.zero_()
    return net.to(device)


def tiny_stack(device, seed: int = 0):
    """(UNet, CLIP text encoder, VAE) at the tiny configs, initialised on
    the CPU from ``seed`` and moved to ``device``."""
    from consolver_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
    from consolver_torch.models.unet_2d import UNet2DCondition, UNetConfig
    from consolver_torch.models.vae import AutoencoderKL, VaeConfig

    rng = np.random.default_rng(seed)
    models = (UNet2DCondition(UNetConfig.tiny(), device="cpu"),
              ClipTextEncoder(ClipTextConfig.tiny(), device="cpu"),
              AutoencoderKL(VaeConfig.tiny(), device="cpu"))
    return tuple(flax_default_init_(m, rng).to(device) for m in models)


def teacher(models, device, rng: np.random.Generator):
    """(noises, prompt ids, 40-step DDIM teacher latents) of the 8 prompts,
    drawn from ``rng`` as the JAX script draws them (which runs them one
    at a time)."""
    from consolver_torch.core.schedules import DiffusionSchedule
    from consolver_torch.data.tokenizer import HashTokenizer, uncond_input_ids
    from consolver_torch.pipelines.t2i import make_denoise_fn

    unet, text, _ = models
    noises = rng.standard_normal((PROMPTS, LATENT, LATENT, 4)).astype(np.float32)
    prompt_ids = rng.integers(1, 900, (PROMPTS, TEXT_LEN)).astype(np.int64)
    denoise = make_denoise_fn(unet, DiffusionSchedule.sd15(), None, TEACHER_STEPS, GUIDANCE,
                              record_trajectory=False)
    unc_ids = uncond_input_ids(HashTokenizer(max_length=TEXT_LEN), 1, TEXT_LEN,
                               vocab_size=text.cfg.vocab_size)
    with torch.no_grad():  # one batch of the 8 prompts: the rows are independent
        uncond = text(torch.as_tensor(np.tile(unc_ids, (PROMPTS, 1)), device=device))
        ctx = text(torch.as_tensor(prompt_ids, device=device))
        latents, _ = denoise(None, torch.as_tensor(noises, device=device), ctx, uncond)
    return noises, prompt_ids, latents.float().cpu().numpy()


def verdict(rewards: Sequence[float], window: int = WINDOW, log=print
            ) -> Tuple[float, float, float]:
    """(mean of the first ``window`` rewards, of the last, their difference),
    printed with the JAX script's verdict line."""
    first, last = float(np.mean(rewards[:window])), float(np.mean(rewards[-window:]))
    log(f"FIRST{window}={first:.4f} LAST{window}={last:.4f} delta={last - first:+.4f}")
    log("LEARNING" if last > first + MARGIN else "NO-CLEAR-LEARNING")
    return first, last, last - first


def run(models=None, quantize: bool = False, steps: int = STEPS, device=None, log=print
        ) -> Tuple[float, float, float, List[float]]:
    """The check; returns ``(first, last, delta, rewards)``."""
    from consolver_torch.core.schedules import DiffusionSchedule
    from consolver_torch.pipelines.t2i import TextToImagePipeline
    from consolver_torch.policy.factor_net import FactorNetConfig
    from consolver_torch.rewards.registry import make_reward_fn
    from consolver_torch.rl.ppo import PPOConfig
    from consolver_torch.rl.train import PPOTrainer, TrainConfig

    device = resolve_device(device)
    models = tiny_stack(device) if models is None else models
    rng = np.random.default_rng(0)
    noises, prompt_ids, teach = teacher(models, device, rng)
    log("teacher built")
    fcfg = FactorNetConfig(order_dim=3, scaler_dim=0, num_actions=11, family="sd")
    unet, text, vae = models
    pipe = TextToImagePipeline(unet, text, vae, DiffusionSchedule.sd15(),
                               factor_net=flax_policy(fcfg, 1, device), device=device)
    if quantize:
        log("int8 rollout environment (pipeline .quantize())")
        pipe = pipe.quantize()
    rewards: List[float] = []
    with tempfile.TemporaryDirectory(prefix="learning_check_") as out:
        config = TrainConfig(
            max_train_steps=10_000, guidance_scale=GUIDANCE, min_inference_steps=3,
            max_inference_steps=4, seed=0, output_dir=out, checkpointing_steps=10_000,
            ppo=PPOConfig(ppo_epochs=1, learning_rate=3e-3, entropy_coef=0.003,
                          advantage_scale=10.0))
        trainer = PPOTrainer(pipe, make_reward_fn("image_psnr"), config)
        for step in range(steps):
            idx = rng.integers(0, PROMPTS)
            batch = {"noise": np.tile(noises[idx:idx + 1], (BATCH, 1, 1, 1)),
                     "latent": np.tile(teach[idx:idx + 1], (BATCH, 1, 1, 1)),
                     "prompt_ids": np.tile(prompt_ids[idx:idx + 1], (BATCH, 1))}
            rewards.append(trainer.train_step(batch)["reward"])
            if step % 40 == 39:
                log(f"step {step + 1}: mean reward last40 = {np.mean(rewards[-40:]):.4f}")
    return (*verdict(rewards, min(WINDOW, len(rewards)), log), rewards)


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(prog="python -m consolver_torch.cli.learning_check")
    ap.add_argument("--quantize", action="store_true",
                    help="roll the student out through the int8 serving path")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    return run(quantize=args.quantize, device=args.device,
               log=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main()
