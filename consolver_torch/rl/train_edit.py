"""FLUX-Kontext editing PPO trainer.

Port of ``consolver_tpu/rl/train_edit.py``.  Deltas from the SD trainer:

  * an extra BASELINE rollout with the naive Euler FM solver on one sample
    per group, whose reward clips that group's mean from below in the
    advantage (``baseline_clipped_advantages``, no scale);
  * the baseline and the policy rollouts draw from two generators, both
    keyed by ``(seed, global_step)``;
  * the rollouts go through :meth:`FluxKontextPipeline.rollout` under
    ``torch.no_grad()`` (its ``__call__`` is the serving entry, in
    ``inference_mode``, whose tensors the FactorNet's backward cannot save);
  * ``dump_samples_to`` writes each step's first policy images as PNGs named
    by their advantage (rank 0 only).

``mesh=`` makes it one data-parallel rank, as :class:`PPOTrainer`; on a 2-D
mesh the frozen DiT also splits over the model group by
:data:`~consolver_torch.dist.tp.FLUX_TP_RULES`.  The ``[G]``-row baseline
batch shards over the data ranks when ``num_groups`` divides by them, and
runs whole on every rank otherwise.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from consolver_torch.data.group import repeat_random_sample_groups
from consolver_torch.dist.tp import FLUX_TP_RULES, shard_module_by_rules
from consolver_torch.eval.gen_sweep import save_png
from consolver_torch.pipelines.edit import FluxKontextPipeline
from consolver_torch.rl import ppo
from consolver_torch.rl.checkpointing import CheckpointMixin
from consolver_torch.rl.train import PPOStepMixin, TrainConfig


class EditPPOTrainer(PPOStepMixin, CheckpointMixin):
    def __init__(
        self,
        pipeline: FluxKontextPipeline,
        reward_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
        config: TrainConfig,
        mesh=None,
        dump_samples_to: Optional[str] = None,
    ):
        if pipeline.factor_net is None:
            raise ValueError("EditPPOTrainer needs a pipeline with a factor_net")
        self.dump_samples_to = dump_samples_to
        self.pipe = pipeline
        self.reward_fn = reward_fn
        self.config = config
        self.device = pipeline.device
        self.global_step = 0
        self.tp_report = None
        if mesh is not None and mesh.tp > 1:
            self.tp_report = shard_module_by_rules(mesh, pipeline.transformer, FLUX_TP_RULES)
        self._setup(mesh)

    @property
    def factor_net(self):
        return self.pipe.factor_net

    def train_step(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        """Host batch keys: ``noise`` ``[B, h, w, 16]`` latent noise,
        ``latent`` (the teacher's final latents) ``[B, h, w, 16]``,
        ``ref_image`` ``[B, H, W, 3]`` in [-1, 1], ``t5_ids`` ``[B, S]``,
        ``clip_ids`` ``[B, S]``."""
        cfg = self.config
        batch = repeat_random_sample_groups(batch, self._group_rng(), self.num_groups)
        num_inference = self._num_inference_for_step(self.global_step)
        keys = ("t5_ids", "clip_ids", "ref_image", "noise", "latent")
        rows = len(batch["noise"])
        # Row g * gs is every row of group g: the strided slice is one
        # sample per group for the Euler baseline.
        gs = rows // self.num_groups
        base_batch = {k: v[::gs] for k, v in batch.items()}
        # the baseline shards with the groups when they divide over the data ranks
        base_local = self.mesh is None or self.num_groups % self.mesh.dp == 0
        if base_local:
            base_batch = self._shard(base_batch)

        def on_device(host):
            return [torch.as_tensor(host[k], device=self.device) for k in keys]

        t5_ids, clip_ids, ref_image, noise, target = on_device(self._shard(batch))
        base_in = on_device(base_batch)
        base_gen, policy_gen = self._generator("baseline"), self._rollout_generator(rows)
        padded = (cfg.max_inference_steps - 1) if cfg.padded_rollout else None
        steps = dict(num_inference_steps=num_inference, guidance_scale=cfg.guidance_scale,
                     decode=False, padded_max_steps=padded)
        with torch.no_grad():
            base_latents, _ = self.pipe.rollout(base_gen, *base_in[:4], solver="euler",
                                                record=False, **steps)
            latents, traj = self.pipe.rollout(
                policy_gen, t5_ids, clip_ids, ref_image, noise, solver="fmppo", **steps)
            chunk = cfg.decode_chunk
            pred_img = self.pipe.decode_latents(latents, chunk=chunk)
            target_img = self.pipe.decode_latents(target, chunk=chunk)
            base_img = self.pipe.decode_latents(base_latents)
            base_target = (target_img[::gs] if base_local
                           else self.pipe.decode_latents(base_in[4]))
            rewards = self._gathered(self.reward_fn(pred_img, target_img).reshape(-1))
            base_reward = self.reward_fn(base_img, base_target).reshape(-1)
            if base_local:
                base_reward = self._gathered(base_reward)
            advantages = ppo.baseline_clipped_advantages(rewards, base_reward,
                                                         num_groups=self.num_groups)

        out = self._run_updates(traj, self._local(advantages))
        if self.dump_samples_to and (self.mesh is None or self.mesh.is_primary):
            self._dump_samples(pred_img, self._local(advantages))
        self.global_step += 1
        out.update(reward=float(rewards.mean()), baseline_reward=float(base_reward.mean()),
                   num_inference=num_inference)
        return out

    def _dump_samples(self, images, advantages, limit: int = 4):
        """The step's first policy images as PNGs named by their advantage."""
        out_dir = os.path.join(self.dump_samples_to, f"step_{self.global_step}")
        os.makedirs(out_dir, exist_ok=True)
        for i, (img, a) in enumerate(zip(images[:limit], advantages[:limit].tolist())):
            save_png(os.path.join(out_dir, f"sample_{i}_adv_{a:.3f}.png"), img)
