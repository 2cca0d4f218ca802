"""End-to-end learning check of the FLUX edit PPO loop:
``python -m consolver_torch.cli.learning_check_edit [--device cpu]``.

Port of ``scripts/learning_check_edit.py``, the FM twin of
``cli/learning_check.py``.  The teacher is a 20-step Euler edit of a tiny
random FLUX-Kontext stack for 6 (reference, instruction) pairs; 300 PPO
steps on the first pair's batch of 8 (a fixed prompt, so that rewards
compare across steps) run the whole edit loop: the baseline Euler rollout,
baseline-clipped advantages and ``ppo_epochs=4`` (``lr=1e-3``,
``entropy_coef=0.01``).  The FM policy's production temperature 0.01 makes
a random-init policy near one-hot (no exploration on a toy), so the check
softens it to ``temperature_override=1.0``, as the JAX script does.  It
prints "LEARNING" when the mean reward of the last 80 steps beats that of
the first 80 by more than 0.05.

The tiny stack is the JAX test stack's configs (``FluxConfig.tiny()``, a
one-layer T5 and CLIP, a two-level VAE), drawn from a seed from the JAX
package's default initialisers (``learning_check.flax_default_init_``),
as is its FM policy (no zero head in that family); :func:`run` also takes
the pipeline's four models from outside.
"""

from __future__ import annotations

import argparse
import tempfile
from typing import List, Optional, Sequence, Tuple

import numpy as np

from consolver_torch.cli.learning_check import flax_default_init_, flax_policy, verdict
from consolver_torch.configs.config import add_device_flag
from consolver_torch.device import resolve_device

PAIRS = 6
BATCH = 8
TEACHER_STEPS = 20
GUIDANCE = 2.5
STEPS = 300
WINDOW = 80
RES = 16
LATENT = 8
TEXT_LEN = 4


def tiny_stack(device, seed: int = 0):
    """(FLUX transformer, T5, CLIP text, VAE) at the JAX test stack's tiny
    configs, initialised on the CPU from ``seed`` and moved to ``device``."""
    from consolver_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
    from consolver_torch.models.flux import FluxConfig, FluxTransformer
    from consolver_torch.models.t5 import T5Config, T5Encoder
    from consolver_torch.models.vae import AutoencoderKL, VaeConfig

    fcfg = FluxConfig.tiny()
    rng = np.random.default_rng(seed)
    models = (
        FluxTransformer(fcfg, device="cpu"),
        T5Encoder(T5Config(vocab_size=64, d_model=fcfg.joint_text_dim, d_kv=8, d_ff=64,
                           num_layers=1, num_heads=4), device="cpu"),
        ClipTextEncoder(ClipTextConfig(vocab_size=64, hidden_size=fcfg.pooled_text_dim,
                                       num_layers=1, num_heads=2, intermediate_size=32),
                        device="cpu"),
        AutoencoderKL(VaeConfig(block_out_channels=(8, 16), layers_per_block=1,
                                norm_num_groups=4, latent_channels=4), device="cpu"))
    return tuple(flax_default_init_(m, rng).to(device) for m in models)


def policy_config():
    from consolver_torch.policy.factor_net import FactorNetConfig

    return FactorNetConfig(order_dim=2, scaler_dim=0, mu_dim=0, num_actions=11, family="fm",
                           temperature_override=1.0)


def teacher(pipe, rng: np.random.Generator):
    """(references, noises, T5 ids, CLIP ids, 20-step Euler teacher latents)
    of the 6 pairs, drawn from ``rng`` as the JAX script draws them; one
    batch (the JAX script runs them one at a time; the rows are independent)."""
    refs = rng.uniform(-1, 1, (PAIRS, RES, RES, 3)).astype(np.float32)
    noises = rng.standard_normal((PAIRS, LATENT, LATENT, 4)).astype(np.float32)
    t5_ids = rng.integers(1, 60, (PAIRS, TEXT_LEN)).astype(np.int64)
    clip_ids = rng.integers(1, 60, (PAIRS, TEXT_LEN)).astype(np.int64)
    latents, _ = pipe(None, t5_ids, clip_ids, refs, noises, num_inference_steps=TEACHER_STEPS,
                      guidance_scale=GUIDANCE, solver="euler", decode=False)
    return refs, noises, t5_ids, clip_ids, latents.float().cpu().numpy()


def run(models=None, steps: int = STEPS, device=None, log=print
        ) -> Tuple[float, float, float, List[float]]:
    """The check; returns ``(first, last, delta, rewards)``."""
    from consolver_torch.pipelines.edit import FluxKontextPipeline
    from consolver_torch.rewards.registry import make_reward_fn
    from consolver_torch.rl.ppo import PPOConfig
    from consolver_torch.rl.train import TrainConfig
    from consolver_torch.rl.train_edit import EditPPOTrainer

    device = resolve_device(device)
    transformer, t5, clip, vae = tiny_stack(device) if models is None else models
    pipe = FluxKontextPipeline(transformer, t5, clip, vae,
                               factor_net=flax_policy(policy_config(), 7, device), device=device)
    rng = np.random.default_rng(0)
    refs, noises, t5_ids, clip_ids, teach = teacher(pipe, rng)
    log("teacher built")
    rewards: List[float] = []
    with tempfile.TemporaryDirectory(prefix="learning_check_edit_") as out:
        config = TrainConfig(
            max_train_steps=10_000, guidance_scale=GUIDANCE, min_inference_steps=3,
            max_inference_steps=4, seed=0, output_dir=out, checkpointing_steps=10_000,
            ppo=PPOConfig(ppo_epochs=4, learning_rate=1e-3, entropy_coef=0.01))
        trainer = EditPPOTrainer(pipe, make_reward_fn("image_psnr"), config)
        idx = 0  # a fixed prompt: rewards compare across steps
        batch = {"noise": np.tile(noises[idx:idx + 1], (BATCH, 1, 1, 1)),
                 "latent": np.tile(teach[idx:idx + 1], (BATCH, 1, 1, 1)),
                 "ref_image": np.tile(refs[idx:idx + 1], (BATCH, 1, 1, 1)),
                 "t5_ids": np.tile(t5_ids[idx:idx + 1], (BATCH, 1)),
                 "clip_ids": np.tile(clip_ids[idx:idx + 1], (BATCH, 1))}
        for step in range(steps):
            m = trainer.train_step(batch)
            rewards.append(m["reward"])
            if step % 40 == 39:
                log(f"step {step + 1}: mean reward last40 = {np.mean(rewards[-40:]):.4f} "
                    f"(baseline {m['baseline_reward']:.2f})")
    return (*verdict(rewards, min(WINDOW, len(rewards)), log), rewards)


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(prog="python -m consolver_torch.cli.learning_check_edit")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    return run(device=args.device, log=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main()
