"""FactorNet: the policy network emitting per-step solver coefficients.

Port of ``consolver_tpu/policy/factor_net.py``.  A small ReLU MLP maps the
``(t, t_prev)`` condition (optionally with cosine features of the epsilon
history) to independent categorical distributions over a fixed per-dimension
grid of coefficient values.

Family differences kept from the JAX package (:class:`FactorNetConfig`):
  * ``sd``: inputs scaled by 1/999, zero-initialised head, temperature 1.0,
    first-order grid ``linspace(0, 2)``;
  * ``fm``: no input scaling, default head init, temperature 0.01, first-order
    grid ``linspace(0, 1)``, optional mu group.
The grid-kind rule uses the corrected condition ``i == 1 and i < order_dim - 1``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from consolver_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class FactorNetConfig:
    num_actions: int = 161
    hidden_dim: int = 256
    order_dim: int = 4
    scaler_dim: int = 2
    mu_dim: int = 0
    use_conv: bool = False  # cosine-similarity features of the eps history
    family: str = "sd"  # "sd" | "fm"
    temperature_override: Optional[float] = None

    @property
    def action_dims(self) -> int:
        return self.order_dim + self.scaler_dim + self.mu_dim - 1

    @property
    def input_dim(self) -> int:
        return 2 + (self.order_dim - 1 if self.use_conv else 0)

    @property
    def input_scale(self) -> float:
        return 1.0 / 999.0 if self.family == "sd" else 1.0

    @property
    def temperature(self) -> float:
        if self.temperature_override is not None:
            return self.temperature_override
        return 1.0 if self.family == "sd" else 0.01

    @property
    def zero_init_head(self) -> bool:
        return self.family == "sd"

    def action_value_grid(self) -> np.ndarray:
        """``[action_dims, num_actions]`` discrete action values per dimension."""
        n = self.num_actions
        first = np.linspace(0, 2 if self.family == "sd" else 1, n)
        second = np.linspace(-2, 0, n)
        order = np.linspace(-1, 1, n)
        scaler = np.linspace(-0.05, 0.05, n)
        mu = np.concatenate([[0.0], np.linspace(0.5, 0.99, n - 1)])
        rows = []
        for i in range(self.action_dims):
            if i == 0:
                rows.append(first)
            elif i == 1 and i < self.order_dim - 1:
                rows.append(second)
            elif i < self.order_dim - 1:
                rows.append(order)
            elif i < self.order_dim + self.scaler_dim - 1:
                rows.append(scaler)
            else:
                rows.append(mu)
        return np.stack(rows).astype(np.float32)


def _cosine_features(epsilon: torch.Tensor, order_dim: int, eps: float = 1e-8) -> torch.Tensor:
    """Cosine similarity of each history slot to the most recent one.
    epsilon: ``[B, order_dim, ...]`` -> ``[B, order_dim - 1]``."""
    flat = epsilon.reshape(epsilon.shape[0], order_dim, -1).float()
    ref = flat[:, 0]
    ref_norm = torch.linalg.vector_norm(ref, dim=-1).clamp_min(eps)
    sims = []
    for i in range(1, order_dim):
        cur = flat[:, i]
        cur_norm = torch.linalg.vector_norm(cur, dim=-1).clamp_min(eps)
        sims.append((ref * cur).sum(dim=-1) / (ref_norm * cur_norm))
    return torch.stack(sims, dim=-1)


@dataclasses.dataclass(frozen=True)
class ShardedGenerator:
    """A data-parallel rank's view of the policy's draws: ``generator``
    draws for the global batch of ``rows`` rows and the rank keeps rows
    ``start : start + its batch``, so that every rank samples what the
    unsharded rollout samples for those rows.  One process is the shard
    ``start = 0`` of its own batch (:meth:`of`)."""

    generator: Optional[torch.Generator]
    start: int
    rows: int

    @classmethod
    def of(cls, generator, rows: int) -> "ShardedGenerator":
        """``generator`` itself when it is a shard, else a plain generator's
        (or the default one's, for None) draws for all ``rows`` rows."""
        return generator if isinstance(generator, cls) else cls(generator, 0, rows)

    def randn(self, shape, device) -> torch.Tensor:
        """This shard's rows of a global ``[rows, *shape[1:]]`` normal draw."""
        full = torch.randn((self.rows, *shape[1:]), generator=self.generator, device=device)
        return full[self.start:self.start + shape[0]]

    def exponential(self, shape, device, dtype) -> torch.Tensor:
        """This shard's rows of a global ``[rows, *shape[1:]]`` Exp(1) draw."""
        full = torch.empty((self.rows, *shape[1:]), device=device, dtype=dtype)
        full.exponential_(1, generator=self.generator)
        return full[self.start:self.start + shape[0]]


class FactorNet(nn.Module):
    """The policy MLP (``fc0``/``fc1``/``head``) with its action grids."""

    def __init__(self, config: FactorNetConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        out_dim = config.num_actions * config.action_dims
        self.fc0 = nn.Linear(config.input_dim, config.hidden_dim, device=device)
        self.fc1 = nn.Linear(config.hidden_dim, config.hidden_dim, device=device)
        self.head = nn.Linear(config.hidden_dim, out_dim, device=device)
        if config.zero_init_head:
            nn.init.zeros_(self.head.weight)
            nn.init.zeros_(self.head.bias)
        self.register_buffer(
            "action_values",
            torch.as_tensor(config.action_value_grid(), device=device),
            persistent=False,
        )

    def _features(self, conds: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = conds["x"].float() * self.config.input_scale
        if self.config.use_conv:
            x = torch.cat([x, _cosine_features(conds["epsilon"], self.config.order_dim)], dim=-1)
        return x

    def log_probs(self, conds: Dict[str, torch.Tensor]) -> torch.Tensor:
        """``[B, action_dims, num_actions]`` log-probabilities."""
        cfg = self.config
        x = F.relu(self.fc0(self._features(conds)))
        x = F.relu(self.fc1(x))
        logits = self.head(x).reshape(-1, cfg.action_dims, cfg.num_actions)
        return F.log_softmax(logits / cfg.temperature, dim=-1)

    def probs(self, conds: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.log_probs(conds).exp()

    def _values_and_probs(
        self, logp: torch.Tensor, idx: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        probs = logp.exp().gather(-1, idx[..., None])[..., 0]
        dims = torch.arange(self.config.action_dims, device=idx.device)[None, :]
        return self.action_values[dims, idx], probs

    def sample_action(
        self, conds: Dict[str, torch.Tensor],
        generator: Union[torch.Generator, ShardedGenerator, None] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One sampled action per dimension: (values ``[B, A]``, their
        probabilities ``[B, A]``).  A :class:`ShardedGenerator` draws for the
        whole batch and keeps this shard's rows."""
        logp = self.log_probs(conds)
        b, a, n = logp.shape
        # torch.multinomial's draw of one sample, bit for bit: argmax(p / q), q ~ Exp(1)
        q = ShardedGenerator.of(generator, b).exponential((b, a, n), logp.device, logp.dtype)
        return self._values_and_probs(logp, (logp.exp() / q).argmax(dim=-1))

    def mode_action(self, conds: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """The most likely action per dimension; same contract as
        :meth:`sample_action`, without randomness."""
        logp = self.log_probs(conds)
        return self._values_and_probs(logp, logp.argmax(dim=-1))

    def actions_to_indices(self, actions: torch.Tensor) -> torch.Tensor:
        """Nearest grid point of each action value."""
        diffs = (actions[:, :, None] - self.action_values[None, :, :]).abs()
        return diffs.argmin(dim=-1)

    def get_action_probs(
        self, conds: Dict[str, torch.Tensor], actions: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Probabilities of the given actions under the current policy and
        the normalized per-dimension entropy ``H / log(K)``."""
        logp = self.log_probs(conds)
        idx = self.actions_to_indices(actions)
        selected = logp.exp().gather(-1, idx[..., None])[..., 0]
        entropy = -(logp.exp() * logp).sum(dim=-1) / np.log(self.config.num_actions)
        return selected, entropy
