"""Trainer checkpointing with the reference's "latest" semantics:
``checkpoint-{step}`` directories, total-limit pruning by step number, and a
resume that restores the policy, the optimizer (with its accumulation
buffer) and ``global_step``.

Port of ``consolver_tpu/rl/checkpointing.py`` with ``torch.save`` /
``torch.load`` in place of orbax.  On a data-parallel mesh (``self.mesh``)
only rank 0 writes, and every rank waits at a barrier after the periodic
saves so that none reads a checkpoint before it exists; every rank resumes
the same file.  The failure / interrupt save skips the barrier: the other
ranks may never reach it.
"""

from __future__ import annotations

import os
import shutil
import warnings

import torch

from consolver_torch.dist.mesh import assert_params_synced
from consolver_torch.policy.io import TRAINER_STATE_FILE as STATE_FILE
from consolver_torch.policy.io import save_factor_net


class CheckpointMixin:
    """Requires ``self.config`` (output_dir, checkpoints_total_limit,
    checkpointing_steps, max_train_steps, log_every), ``self.factor_net``,
    ``self.optimizer`` (:class:`~consolver_torch.rl.ppo.PolicyOptimizer`),
    ``self.global_step``, ``self.mesh`` (None for one process) and
    ``train_step``."""

    mesh = None

    def fit(self, batches, log_fn=None):
        """The training loop: ``train_step`` over the host batches, with the
        periodic checkpoints and, every 10th log interval, ``param_sum``.

        A resumed run first skips the batches the interrupted run consumed
        (one per step), so it replays the uninterrupted run.  On a failure or
        an interrupt the current state is checkpointed before re-raising, so
        ``resume_from_checkpoint('latest')`` restarts from the failed step."""
        batches = iter(batches)
        for _ in range(self.global_step):
            next(batches, None)
        try:
            for batch in batches:
                if self.global_step >= self.config.max_train_steps:
                    break
                metrics = self.train_step(batch)
                if self.global_step % self.config.checkpointing_steps == 0:
                    self.save_checkpoint()
                if log_fn and self.global_step % self.config.log_every == 0:
                    if self.global_step % (self.config.log_every * 10) == 0:
                        metrics["param_sum"] = self.param_sum()
                    log_fn(self.global_step, metrics)
        except KeyboardInterrupt:
            self.save_checkpoint(barrier=False)
            raise
        except Exception:
            try:
                self.save_checkpoint(barrier=False)
            except (OSError, RuntimeError) as save_error:  # report the step's own error
                warnings.warn(f"the failure checkpoint was not written: {save_error}")
            raise
        return self.factor_net

    def param_sum(self) -> float:
        """The sum of the policy's parameters (the reference's DDP param-sum
        print); on a mesh it also checks that every rank holds the same sum
        (:func:`~consolver_torch.dist.mesh.assert_params_synced`)."""
        return assert_params_synced(self.factor_net, self.mesh)

    def save_checkpoint(self, barrier: bool = True) -> str:
        """Write ``checkpoint-{global_step}`` (rank 0 only on a mesh, then a
        barrier unless ``barrier`` is False); returns its path."""
        path = os.path.abspath(
            os.path.join(self.config.output_dir, f"checkpoint-{self.global_step}")
        )
        if self.mesh is None or self.mesh.is_primary:
            os.makedirs(path, exist_ok=True)
            payload = {
                "policy": self.factor_net.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "global_step": self.global_step,
            }
            tmp = os.path.join(path, STATE_FILE + ".tmp")
            torch.save(payload, tmp)
            os.replace(tmp, os.path.join(path, STATE_FILE))
            self._enforce_total_limit()
        if self.mesh is not None and barrier:
            self.mesh.barrier()
        return path

    def _enforce_total_limit(self):
        limit = getattr(self.config, "checkpoints_total_limit", None)
        if not limit:
            return
        for d in self._checkpoint_dirs()[:-limit]:
            shutil.rmtree(os.path.join(self.config.output_dir, d), ignore_errors=True)

    def _checkpoint_dirs(self):
        if not os.path.isdir(self.config.output_dir):
            return []
        dirs = [d for d in os.listdir(self.config.output_dir) if d.startswith("checkpoint-")]
        return sorted(dirs, key=lambda d: int(d.split("-")[1]))

    def resume_from_checkpoint(self, which: str = "latest") -> bool:
        """Restore ``which`` ("latest" or a checkpoint directory); False when
        "latest" finds none."""
        if which == "latest":
            dirs = self._checkpoint_dirs()
            if not dirs:
                return False
            path = os.path.join(self.config.output_dir, dirs[-1])
        else:
            path = which
        state = torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)
        self.factor_net.load_state_dict(state["policy"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.global_step = int(state["global_step"])
        return True

    def save_pretrained(self, output_dir: str) -> str:
        """The final policy: ``factor_net.pt`` (its ``state_dict``) and
        ``factor_net_config.json``, loadable as
        ``FactorNet(FactorNetConfig(**json)).load_state_dict(torch.load(...))``
        or :func:`consolver_torch.policy.io.load_factor_ckpt`.  Rank 0
        writes it on a mesh."""
        if self.mesh is None or self.mesh.is_primary:
            path = save_factor_net(self.factor_net, output_dir)
        if self.mesh is not None:
            self.mesh.barrier()
            path = self.mesh.broadcast_object(path if self.mesh.is_primary else None)
        return path
