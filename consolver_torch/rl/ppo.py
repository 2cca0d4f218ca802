"""PPO machinery: group-relative advantages, clipped surrogate, update step.

Port of ``consolver_tpu/rl/ppo.py``.  Semantics kept:

  * group advantages ``(r - mean) / (std + 1e-8) * scale`` within each
    contiguous group, with the population std;
  * the FLUX baseline-clip variant: each group's mean is clipped from below
    by its naive-solver baseline reward (no scale);
  * the advantage broadcast over steps times the warm-up masks;
  * joint log-probs over the action dims, ratio clip, ``-min(A r, A r_clip)``,
    entropy bonus ``-coef * H``, ``valid``-weighted means;
  * the optimizer of the JAX package (``optax.chain(clip_by_global_norm,
    adamw)``, wrapped in ``MultiSteps`` when accumulating), written out over
    the FactorNet's parameters by :class:`PolicyOptimizer`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from consolver_torch.pipelines.t2i import Trajectory
from consolver_torch.policy.factor_net import FactorNet


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    clip_range: float = 0.2
    entropy_coef: float = 0.01
    ppo_epochs: int = 1
    advantage_scale: float = 10.0
    learning_rate: float = 1e-4
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    weight_decay: float = 1e-2
    max_grad_norm: float = 1.0
    # apply the optimizer every k update calls, on the mean of their grads
    grad_accumulation_steps: int = 1


def group_advantages(
    rewards: torch.Tensor, scale: float = 10.0, num_groups: int = 1
) -> torch.Tensor:
    """``(r - mean) / (std + 1e-8) * scale`` within each of ``num_groups``
    contiguous groups (population std)."""
    r = rewards.reshape(num_groups, -1)
    adv = (r - r.mean(dim=1, keepdim=True)) / (r.std(dim=1, keepdim=True, correction=0) + 1e-8)
    return adv.reshape(rewards.shape) * scale


def baseline_clipped_advantages(
    rewards: torch.Tensor, baseline_reward, max_clip: float = 100.0, num_groups: int = 1
) -> torch.Tensor:
    """FLUX variant: each group's mean clipped to ``[baseline, max_clip]``.
    ``baseline_reward`` is a scalar (one group) or ``[num_groups]``."""
    r = rewards.reshape(num_groups, -1)
    base = torch.as_tensor(baseline_reward, device=r.device).reshape(-1)
    base = base.expand(num_groups).to(r.dtype)
    mean = torch.maximum(r.mean(dim=1), base).clamp_max(max_clip)
    adv = (r - mean[:, None]) / (r.std(dim=1, keepdim=True, correction=0) + 1e-8)
    return adv.reshape(rewards.shape)


def flatten_trajectory(
    traj: Trajectory, advantages: torch.Tensor
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``[B, S-1, ...]`` trajectory -> flat ``[B*(S-1), ...]`` PPO batch with
    the advantage broadcast over steps and masked.

    Returns (conds, actions, old_probs, masked_advantages ``[N, A]``,
    valid ``[N, 1]``); ``valid`` marks the real rows of a padded rollout
    (all ones otherwise)."""
    b, s = traj.actions.shape[:2]
    n = b * s

    def flat(x):
        return x.reshape((n,) + tuple(x.shape[2:]))

    conds = {"x": flat(traj.conds_x)}
    if traj.conds_eps is not None:
        conds["epsilon"] = flat(traj.conds_eps)
    adv = advantages.reshape(b, 1).repeat_interleave(s, dim=1).reshape(n, 1)
    if traj.valid is None:
        valid = torch.ones((n, 1), dtype=torch.float32, device=traj.actions.device)
    else:
        valid = flat(traj.valid).reshape(n, 1).float()
    return conds, flat(traj.actions), flat(traj.probs), adv * flat(traj.masks), valid


def ppo_loss(
    factor_net: FactorNet,
    conds: Dict[str, torch.Tensor],
    actions: torch.Tensor,
    old_probs: torch.Tensor,
    advantages: torch.Tensor,
    clip_range: float = 0.2,
    entropy_coef: float = 0.01,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Clipped-surrogate loss with joint log-probs.  ``valid`` ``[N, 1]``
    weights rows in every mean, so pad rows of a padded rollout count in
    neither the surrogate nor the entropy bonus; None = plain means."""
    curr_probs, entropy = factor_net.get_action_probs(conds, actions)
    log_probs = torch.log(curr_probs + 1e-9).sum(dim=1, keepdim=True)
    old_log_probs = torch.log(old_probs + 1e-9).sum(dim=1, keepdim=True)
    ratio = torch.exp(log_probs - old_log_probs)
    clipped_ratio = ratio.clamp(1 - clip_range, 1 + clip_range)
    surrogate = -torch.minimum(advantages * ratio, advantages * clipped_ratio)

    if valid is None:
        policy_loss = surrogate.mean()
        entropy_mean = entropy.mean()
        ratio_mean = ratio.mean()
    else:
        w = valid.reshape(-1, 1).to(surrogate.dtype)
        n_rows = w.sum().clamp_min(1.0)
        policy_loss = (surrogate * w).sum() / (n_rows * surrogate.shape[1])
        entropy_mean = (entropy * w).sum() / (n_rows * entropy.shape[1])
        ratio_mean = (ratio * w).sum() / n_rows
    loss = policy_loss - entropy_coef * entropy_mean
    return loss, {
        "policy_loss": policy_loss,
        "entropy": entropy_mean,
        "ratio_mean": ratio_mean,
        "loss": loss,
    }


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every element of every tensor."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


class PolicyOptimizer:
    """The JAX package's optimizer over a module's parameters:

    * with ``grad_accumulation_steps = k > 1`` the gradients of k calls are
      averaged by optax ``MultiSteps``' running mean ``acc + (g - acc) /
      (n + 1)`` and the update applies on every k-th call only;
    * the (accumulated) gradient is clipped by optax's ``clip_by_global_norm``
      rule: ``g / norm * max_norm`` when ``norm >= max_norm``, else as is
      (``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6``);
    * then ``torch.optim.AdamW``, whose decay ``lr * wd * p`` is optax
      ``adamw``'s.

    :meth:`step` reads the parameters' ``.grad``."""

    def __init__(self, params: Iterable[torch.nn.Parameter], config: PPOConfig):
        self.params: List[torch.nn.Parameter] = list(params)
        self.config = config
        self.adamw = torch.optim.AdamW(
            self.params, lr=config.learning_rate, betas=(config.adam_b1, config.adam_b2),
            eps=config.adam_eps, weight_decay=config.weight_decay,
        )
        self.mini_step = 0
        self.acc_grads = [torch.zeros_like(p) for p in self.params]

    def step(self) -> None:
        """One optimizer call."""
        grads = [p.grad for p in self.params]
        k = self.config.grad_accumulation_steps
        if k > 1:
            n = self.mini_step
            self.acc_grads = [a + (g - a) / (n + 1) for g, a in zip(grads, self.acc_grads)]
            self.mini_step = (n + 1) % k
            if self.mini_step:
                return
            grads = self.acc_grads
            self.acc_grads = [torch.zeros_like(a) for a in self.acc_grads]
        max_norm = self.config.max_grad_norm
        norm = global_norm(grads)
        if not norm < max_norm:
            grads = [g / norm * max_norm for g in grads]
        for p, g in zip(self.params, grads):
            p.grad = g
        self.adamw.step()

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(), "mini_step": self.mini_step,
                "acc_grads": [a.clone() for a in self.acc_grads]}

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.mini_step = int(state["mini_step"])
        self.acc_grads = [a.to(p.device, p.dtype).clone()
                          for a, p in zip(state["acc_grads"], self.params)]


def make_optimizer(factor_net: FactorNet, config: PPOConfig) -> PolicyOptimizer:
    """The policy's optimizer: global-norm clip + AdamW, accumulated over
    ``grad_accumulation_steps`` calls."""
    return PolicyOptimizer(factor_net.parameters(), config)


def make_update_fn(
    factor_net: FactorNet,
    optimizer: PolicyOptimizer,
    config: PPOConfig,
    grad_sync: Optional[Callable] = None,
):
    """The PPO update: ``update(conds, actions, old_probs, advantages,
    valid=None) -> aux`` runs the loss, its gradient and one optimizer call
    in place.  ``aux["grad_norm"]`` is this call's gradient norm before any
    clip.

    ``grad_sync`` (:func:`consolver_torch.dist.mesh.make_grad_sync`) makes
    it a data-parallel update over this rank's shard of the batch: the
    loss is the GLOBAL masked mean, as the JAX mesh update's (the shards of
    a padded program hold different ``valid`` counts, so an average of
    per-rank means would differ), so each rank scales its loss by its share
    of the global row count before the gradients are summed; the aux
    metrics are the global values, and the gradient norm and the clip come
    after the sum, as in optax's chain."""

    def update(conds, actions, old_probs, advantages, valid=None):
        factor_net.zero_grad(set_to_none=True)
        loss, aux = ppo_loss(factor_net, conds, actions, old_probs, advantages,
                             config.clip_range, config.entropy_coef, valid=valid)
        if grad_sync is not None:
            rows = (valid.sum() if valid is not None
                    else torch.tensor(float(actions.shape[0]), device=actions.device))
            share = grad_sync.share(rows.float())
            loss = loss * share
            aux = grad_sync.sum({name: value.detach() * share for name, value in aux.items()})
        loss.backward()
        if grad_sync is not None:
            grad_sync([p.grad for p in optimizer.params])
        aux = {name: value.detach() for name, value in aux.items()}
        aux["grad_norm"] = global_norm(p.grad for p in optimizer.params)
        optimizer.step()
        return aux

    return update
