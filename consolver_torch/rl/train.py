"""The PPO trainer: rollout -> decode -> reward -> advantage -> update.

Port of ``consolver_tpu/rl/train.py`` (SD family).  Every host draw is keyed
by ``(seed, global_step)``, not drawn from a running stream, so a resumed
run replays an uninterrupted one: the inference-step count
(``f"{seed}-{step}"``), the group picks (``f"{seed}-group-{step}"``) and
the seed of the rollout's ``torch.Generator`` (``f"{seed}-rollout-{step}"``).

With ``mesh=`` (:mod:`consolver_torch.dist.mesh`) the trainer is one
data-parallel rank: every rank forms the same global group batch, keeps its
data shard, draws the global batch's policy samples and keeps its rows
(:class:`~consolver_torch.policy.factor_net.ShardedGenerator`), so that at
``num_groups`` fixed it computes what the one-process trainer computes.
Rewards are all_gathered for the group advantages; the update sums the
gradients of the global masked mean over the data group.  The policy is
broadcast from rank 0 at the start; the frozen models are the caller's (every
rank builds or loads the same weights).

The rollout, the prompt encode and the decodes run under
``torch.no_grad()``: the frozen models keep ``requires_grad``, and a
recorded UNet graph per step would fill the card.  The trainer calls
``denoise_fn`` directly, not ``TextToImagePipeline.__call__``, whose
``inference_mode`` tensors cannot be saved for the FactorNet's backward.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable, Dict, Optional

import numpy as np
import torch

from consolver_torch.data.group import repeat_random_sample_groups
from consolver_torch.dist import mesh as meshlib
from consolver_torch.pipelines.t2i import TextToImagePipeline, padded_ladder
from consolver_torch.policy.factor_net import ShardedGenerator
from consolver_torch.rl import ppo
from consolver_torch.rl.checkpointing import CheckpointMixin
from consolver_torch.rl.ppo import PPOConfig


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    max_train_steps: int = 3001
    guidance_scale: float = 3.0
    min_inference_steps: int = 2
    max_inference_steps: int = 16  # exclusive, like random.choice(range(2, 16))
    seed: int = 0
    output_dir: str = "runs/ppo"
    checkpointing_steps: int = 500
    checkpoints_total_limit: Optional[int] = None
    log_every: int = 10
    # one padded rollout program (``padded_denoise_fn``) for every step count
    padded_rollout: bool = False
    # GRPO groups per batch (the reference forms one per rank); None = 1
    num_groups: Optional[int] = None
    # micro-batch of the VAE decodes; None = one whole-batch decode
    decode_chunk: Optional[int] = None
    ppo: PPOConfig = dataclasses.field(default_factory=PPOConfig)


class PPOStepMixin:
    """What the SD and FLUX trainers' steps share: the host draws keyed by
    ``(seed, global_step)``, the data-parallel plumbing and the PPO epochs.
    Needs ``self.config``, ``self.global_step``, ``self.device`` and
    ``self.factor_net``; :meth:`_setup` makes ``self.optimizer`` and
    ``self._update``."""

    def _setup(self, mesh) -> None:
        self.mesh = mesh
        self.num_groups = meshlib.resolve_num_groups(self.config.num_groups, mesh)
        self.optimizer = ppo.make_optimizer(self.factor_net, self.config.ppo)
        self.grad_sync = None
        if mesh is not None:
            meshlib.replicate(mesh, self.factor_net)  # every rank starts from rank 0's policy
            self.grad_sync = meshlib.make_grad_sync(mesh)
        self._update = ppo.make_update_fn(self.factor_net, self.optimizer, self.config.ppo,
                                          grad_sync=self.grad_sync)

    def _shard(self, batch):
        """This rank's data shard of a host batch (the batch without a mesh)."""
        return batch if self.mesh is None else meshlib.shard_batch(self.mesh, batch)

    def _gathered(self, t: torch.Tensor) -> torch.Tensor:
        """The global batch of a per-shard tensor."""
        return t if self.mesh is None else meshlib.gather_batch(self.mesh, t)

    def _local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global-batch tensor."""
        return t if self.mesh is None else t[meshlib.shard_slice(self.mesh, t.shape[0])]

    def _rollout_generator(self, rows: int):
        """The policy's generator of this step; on a mesh, its draws for the
        global batch of ``rows`` cut to this shard."""
        gen = self._generator("rollout")
        if self.mesh is None:
            return gen
        return ShardedGenerator(gen, meshlib.shard_slice(self.mesh, rows).start, rows)

    def _group_rng(self) -> random.Random:
        return random.Random(f"{self.config.seed}-group-{self.global_step}")

    def _num_inference_for_step(self, step: int) -> int:
        rng = random.Random(f"{self.config.seed}-{step}")
        return rng.randrange(self.config.min_inference_steps, self.config.max_inference_steps)

    def _generator(self, stream: str) -> torch.Generator:
        """A generator for one stream of this step, seeded from ``(seed, step)``."""
        seed = random.Random(f"{self.config.seed}-{stream}-{self.global_step}").getrandbits(63)
        return torch.Generator(self.device).manual_seed(seed)

    def _run_updates(self, traj, advantages) -> Dict[str, float]:
        conds, actions, old_probs, adv, valid = ppo.flatten_trajectory(traj, advantages)
        metrics = {}
        for _ in range(self.config.ppo.ppo_epochs):
            metrics = self._update(conds, actions, old_probs, adv, valid)
        return {k: float(v) for k, v in metrics.items()}


class PPOTrainer(PPOStepMixin, CheckpointMixin):
    """PPO trainer over a :class:`TextToImagePipeline` whose solver is the
    learnable one (a FactorNet attached), on the pipeline's device; one
    process, or one data-parallel rank of ``mesh``."""

    def __init__(
        self,
        pipeline: TextToImagePipeline,
        reward_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
        config: TrainConfig,
        mesh=None,
    ):
        if pipeline.factor_net is None:
            raise ValueError("PPOTrainer needs a pipeline with a factor_net")
        self.pipe = pipeline
        self.reward_fn = reward_fn
        self.config = config
        self.device = pipeline.device
        self.factor_net = pipeline.factor_net
        self.global_step = 0
        self._setup(mesh)

    def _decode_and_reward(self, pred_latents, target_latents):
        """(the global batch's rewards, this shard's advantages)."""
        chunk = self.config.decode_chunk
        pred = self.pipe.decode_latents(pred_latents, chunk=chunk)
        target = self.pipe.decode_latents(target_latents, chunk=chunk)
        rewards = self._gathered(self.reward_fn(pred, target).reshape(-1))
        adv = ppo.group_advantages(rewards, self.config.ppo.advantage_scale,
                                   num_groups=self.num_groups)
        return rewards, self._local(adv)

    def train_step(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        """One PPO step on a host batch with keys ``noise`` ``[B, h, w, c]``,
        ``latent`` (the teacher's final latent) ``[B, h, w, c]``,
        ``prompt_ids`` ``[B, S]`` and optionally ``uncond_ids``."""
        cfg = self.config
        batch = repeat_random_sample_groups(batch, self._group_rng(), self.num_groups)
        rows = len(batch["noise"])
        batch = self._shard(batch)
        num_inference = self._num_inference_for_step(self.global_step)
        pipe = self.pipe

        def on_device(name):
            return torch.as_tensor(batch[name], device=self.device)

        with torch.no_grad():
            prompt_ids = on_device("prompt_ids")
            uncond_ids = (on_device("uncond_ids") if "uncond_ids" in batch
                          else pipe.uncond_ids_for(prompt_ids))
            context, uncond_context = pipe._encode(prompt_ids, uncond_ids)
            generator = self._rollout_generator(rows)
            if cfg.padded_rollout:
                max_steps = cfg.max_inference_steps - 1  # exclusive upper bound
                denoise = pipe.padded_denoise_fn(max_steps, cfg.guidance_scale)
                ladder = padded_ladder(pipe.schedule, num_inference, max_steps,
                                       pipe.timestep_spacing, pipe.steps_offset)
                latents, traj = denoise(generator, on_device("noise"), context, uncond_context,
                                        *ladder)
            else:
                denoise = pipe.denoise_fn(num_inference, cfg.guidance_scale)
                latents, traj = denoise(generator, on_device("noise"), context, uncond_context)
            rewards, advantages = self._decode_and_reward(latents, on_device("latent"))

        out = self._run_updates(traj, advantages)
        self.global_step += 1
        out["reward"] = float(rewards.mean())
        out["num_inference"] = num_inference
        return out
