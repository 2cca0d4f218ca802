"""Continuous-action FactorNet: a diagonal Gaussian policy.

Port of ``consolver_tpu/policy/continuous.py``: the same action semantics as
the discrete :class:`~consolver_torch.policy.factor_net.FactorNet`, with a
state-dependent mean (zero-initialised head, so the initial policy matches
the discrete net's zero-init behaviour), a learned global log-std, and
analytic densities and entropy.  It slots into the PPO machinery of
``rl/ppo.py``: :meth:`sample_action` returns per-dimension densities in
place of categorical probabilities, so the joint surrogate's ratio is the
density ratio.  Actions are clipped to the discrete grids' ranges and their
density is taken at the clipped value, the one stored in the trajectory and
re-evaluated by :meth:`get_action_probs`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from consolver_torch.device import resolve_device
from consolver_torch.policy.factor_net import FactorNetConfig, _cosine_features


@dataclasses.dataclass(frozen=True)
class ContinuousFactorNetConfig:
    hidden_dim: int = 256
    order_dim: int = 4
    scaler_dim: int = 2
    mu_dim: int = 0
    use_conv: bool = False
    family: str = "sd"
    init_log_std: float = -1.0

    @property
    def action_dims(self) -> int:
        return self.order_dim + self.scaler_dim + self.mu_dim - 1

    @property
    def input_dim(self) -> int:
        return 2 + (self.order_dim - 1 if self.use_conv else 0)

    @property
    def input_scale(self) -> float:
        return 1.0 / 999.0 if self.family == "sd" else 1.0

    def action_bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-dimension clip bounds: the discrete grids' ranges."""
        grid = FactorNetConfig(
            num_actions=3, hidden_dim=self.hidden_dim, order_dim=self.order_dim,
            scaler_dim=self.scaler_dim, mu_dim=self.mu_dim, family=self.family,
        ).action_value_grid()
        return grid.min(axis=1), grid.max(axis=1)


class ContinuousFactorNet(nn.Module):
    """``fc0`` / ``fc1`` / ``head`` (zero-init) and ``log_std``."""

    def __init__(self, config: ContinuousFactorNetConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.fc0 = nn.Linear(config.input_dim, config.hidden_dim, device=device)
        self.fc1 = nn.Linear(config.hidden_dim, config.hidden_dim, device=device)
        self.head = nn.Linear(config.hidden_dim, config.action_dims, device=device)
        nn.init.zeros_(self.head.weight)
        nn.init.zeros_(self.head.bias)
        self.log_std = nn.Parameter(
            torch.full((config.action_dims,), config.init_log_std, device=device))
        low, high = config.action_bounds()
        self.register_buffer("low", torch.as_tensor(low, device=device), persistent=False)
        self.register_buffer("high", torch.as_tensor(high, device=device), persistent=False)

    def _features(self, conds: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = conds["x"].float() * self.config.input_scale
        if self.config.use_conv:
            x = torch.cat([x, _cosine_features(conds["epsilon"], self.config.order_dim)], dim=-1)
        return x

    def dist(self, conds: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean ``[B, A]``, std ``[1, A]``)."""
        x = F.relu(self.fc0(self._features(conds)))
        mean = self.head(F.relu(self.fc1(x)))
        return mean, self.log_std.exp()[None, :]

    @staticmethod
    def density(mean: torch.Tensor, std: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
        z = (value - mean) / std
        return torch.exp(-0.5 * z ** 2) / (std * math.sqrt(2 * math.pi))

    def sample_action(self, conds: Dict[str, torch.Tensor],
                      generator: Optional[torch.Generator] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(actions clipped to the grid ranges, per-dimension densities at
        the clipped values); the normal draw comes from ``generator``."""
        mean, std = self.dist(conds)
        noise = torch.randn(mean.shape, generator=generator, device=mean.device)
        actions = torch.clamp(mean + std * noise, self.low[None, :], self.high[None, :])
        return actions, self.density(mean, std, actions)

    def get_action_probs(self, conds: Dict[str, torch.Tensor], actions: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(per-dimension densities of ``actions``, per-dimension analytic
        entropy in nats, not normalised to [0, 1])."""
        mean, std = self.dist(conds)
        entropy = 0.5 * torch.log(2 * math.pi * math.e * std ** 2)
        return self.density(mean, std, actions.float()), entropy.expand(mean.shape)
