"""MuNet: a one-layer policy over a discrete shift-value grid.

Port of ``consolver_tpu/policy/mu_net.py`` (the reference's ``MuNetPPO``):
one linear layer maps a scalar condition to a categorical over the shift
values ``linspace(1, 2, 21)``.  As in the JAX package, no trainer uses it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from consolver_torch.device import resolve_device


class MuNet(nn.Module):
    def __init__(self, input_dim: int = 1, num_actions: int = 21, low: float = 1.0,
                 high: float = 2.0, device=None):
        super().__init__()
        device = resolve_device(device)
        self.num_actions = num_actions
        self.input_dim = input_dim
        self.fc = nn.Linear(input_dim, num_actions, device=device)
        self.register_buffer(
            "action_values",
            torch.as_tensor(np.linspace(low, high, num_actions), dtype=torch.float32,
                            device=device),
            persistent=False)

    def log_probs(self, x: torch.Tensor) -> torch.Tensor:
        return F.log_softmax(self.fc(x.float()), dim=-1)

    def _picked(self, logp: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        return logp.exp().gather(-1, idx[:, None])[:, 0]

    def sample_action(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(shift values ``[B]``, their probabilities ``[B]``); the draw is
        ``argmax(p / q)`` with ``q ~ Exp(1)`` from ``generator``."""
        logp = self.log_probs(x)
        q = torch.empty_like(logp).exponential_(1, generator=generator)
        idx = (logp.exp() / q).argmax(dim=-1)
        return self.action_values[idx], self._picked(logp, idx)

    def get_action_probs(self, x: torch.Tensor, actions: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Probabilities of the nearest grid values and the entropy
        normalised by ``log(num_actions)``."""
        logp = self.log_probs(x)
        idx = (actions[:, None] - self.action_values[None, :]).abs().argmin(dim=-1)
        entropy = -(logp.exp() * logp).sum(dim=-1) / np.log(np.float32(self.num_actions))
        return self._picked(logp, idx), entropy
