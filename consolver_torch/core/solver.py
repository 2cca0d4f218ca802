"""The learnable linear-multistep (LMM) solver core, on torch tensors.

Port of ``consolver_tpu/core/solver.py``.  The history of
model outputs is a ring ``ets`` of shape ``[B, order_dim, *sample_shape]``,
most recent first, with ``num_ets`` valid slots; slots ``>= num_ets`` are
zero.  The denoise loop is a Python loop, so ``num_ets`` is a Python int.

Semantics kept from the JAX package:
  * push puts the newest output at slot 0 and drops the oldest;
  * coefficient normalization: placeholder-append the last action, add 1 to
    the first, and close with ``1 - sum`` of the earlier ones only when
    ``num_ets > 1`` so the combination sums to 1;
  * the first step (``num_ets == 1``) passes the raw output through;
  * warm-up masks zero the order actions not yet active;
  * DDIM x0-form update, with ``final_alpha_cumprod`` when ``t_prev < 0``;
  * flow-matching Euler update ``x + dt * v`` and the per-token branch,
    whose dt is ``current - next`` (the mirror of the ladder's).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from consolver_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class LMMState:
    """Solver history: ``ets`` ``[B, order_dim, ...]`` most recent first and
    the number of valid entries ``num_ets`` (``<= order_dim``)."""

    ets: torch.Tensor
    num_ets: int

    @property
    def order_dim(self) -> int:
        return self.ets.shape[1]


def init_state(
    batch: int,
    order_dim: int,
    sample_shape: Tuple[int, ...],
    dtype: torch.dtype = torch.float32,
    device=None,
) -> LMMState:
    ets = torch.zeros((batch, order_dim) + tuple(sample_shape), dtype=dtype, device=device)
    return LMMState(ets=ets, num_ets=0)


def push(state: LMMState, model_output: torch.Tensor) -> LMMState:
    """Push the newest model output into the history ring (most recent first)."""
    ets = torch.cat([model_output[:, None].to(state.ets.dtype), state.ets[:, :-1]], dim=1)
    return LMMState(ets=ets, num_ets=min(state.num_ets + 1, state.order_dim))


def normalized_coefficients(
    order_actions: torch.Tensor, num_ets: int, order_dim: int
) -> torch.Tensor:
    """``[B, order_dim - 1]`` raw actions -> ``[B, order_dim]`` coefficients;
    when ``num_ets > 1`` the first ``num_ets`` of them sum to 1."""
    batch = order_actions.shape[0]
    if order_dim == 1:
        return torch.ones((batch, 1), dtype=order_actions.dtype, device=order_actions.device)
    base = torch.cat([order_actions, order_actions[:, -1:]], dim=1)  # placeholder-append
    base[:, 0] += 1.0
    idx = torch.arange(order_dim, device=base.device)[None, :]
    prefix = torch.where(idx < num_ets - 1, base, torch.zeros_like(base)).sum(dim=1, keepdim=True)
    closing = (idx == num_ets - 1) & (num_ets > 1)
    return torch.where(closing, 1.0 - prefix, base)


def combine(state: LMMState, coeffs: torch.Tensor) -> torch.Tensor:
    """``sum_i c_i * ets_i`` over the valid history; the first step
    (``num_ets == 1``) passes the raw model output through unscaled."""
    if state.num_ets == 1:
        return state.ets[:, 0].to(coeffs.dtype)
    batch, order_dim = state.ets.shape[:2]
    valid = (torch.arange(order_dim, device=coeffs.device) < state.num_ets).to(coeffs.dtype)
    weights = (coeffs * valid[None, :]).reshape(
        (batch, order_dim) + (1,) * (state.ets.ndim - 2)
    )
    return (weights * state.ets.to(coeffs.dtype)).sum(dim=1)


def warmup_masks(
    num_ets: int, order_dim: int, action_dims: int, batch: int, device=None
) -> torch.Tensor:
    """PPO masks: zero for order-action dims not yet active during warm-up
    (``masks[:, num_ets-1 : order_dim-1] = 0``)."""
    j = torch.arange(action_dims, device=device)
    inactive = (j >= num_ets - 1) & (j < order_dim - 1)
    row = torch.where(inactive, 0.0, 1.0).to(torch.float32)
    return row[None, :].expand(batch, action_dims)


def split_actions(actions: torch.Tensor, order_dim: int, scaler_dim: int, mu_dim: int = 0):
    """Split ``[B, order_dim + scaler_dim + mu_dim - 1]`` actions into the
    (order, scaler, mu) groups.  The mu actions are recorded for PPO but no
    update reads them."""
    del mu_dim
    order_actions = actions[:, : order_dim - 1]
    scale_actions = actions[:, order_dim - 1 : order_dim - 1 + scaler_dim]
    mu_actions = actions[:, order_dim - 1 + scaler_dim :]
    return order_actions, scale_actions, mu_actions


def apply_scalers(
    effective_output: torch.Tensor, sample: torch.Tensor, scale_actions: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scale the combined output (and, with two scalers, the sample) by
    ``1 + action``."""
    scaler_dim = scale_actions.shape[1]
    if scaler_dim == 0:
        return effective_output, sample
    if scaler_dim > 2:
        raise NotImplementedError("More than two scale parameters not supported.")
    expand = (slice(None),) + (None,) * (effective_output.ndim - 1)
    effective_output = effective_output * (scale_actions[:, 0][expand] + 1.0)
    if scaler_dim == 2:
        sample = sample * (scale_actions[:, 1][expand] + 1.0)
    return effective_output, sample


def lmm_combine_step(
    state: LMMState,
    model_output: torch.Tensor,
    actions: torch.Tensor,
    sample: torch.Tensor,
    order_dim: int,
    scaler_dim: int,
) -> Tuple[LMMState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Push the history, normalize the order actions, combine and scale.
    Returns (new state, effective output, scaled sample, masks)."""
    state = push(state, model_output)
    order_actions, scale_actions, _ = split_actions(actions, order_dim, scaler_dim)
    coeffs = normalized_coefficients(order_actions.float(), state.num_ets, order_dim)
    effective = combine(state, coeffs)
    effective, sample = apply_scalers(effective, sample, scale_actions.float())
    masks = warmup_masks(state.num_ets, order_dim, actions.shape[1], actions.shape[0],
                         actions.device)
    return state, effective, sample, masks


def ddim_update(
    sample: torch.Tensor,
    model_output: torch.Tensor,
    alpha_prod_t: torch.Tensor,
    alpha_prod_t_prev: torch.Tensor,
    prediction_type: str = "epsilon",
) -> torch.Tensor:
    """DDIM x0-form update."""
    beta_prod_t = 1.0 - alpha_prod_t
    beta_prod_t_prev = 1.0 - alpha_prod_t_prev
    if prediction_type == "v_prediction":
        model_output = (alpha_prod_t**0.5) * model_output + (beta_prod_t**0.5) * sample
    elif prediction_type != "epsilon":
        raise ValueError(f"Unsupported prediction_type: {prediction_type}")
    pred_original = (sample - beta_prod_t**0.5 * model_output) / alpha_prod_t**0.5
    return alpha_prod_t_prev**0.5 * pred_original + beta_prod_t_prev**0.5 * model_output


def gather_alpha_prods(
    alphas_cumprod: torch.Tensor,
    timestep,
    prev_timestep,
    final_alpha_cumprod: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """alpha-bar at t and t_prev, with ``final_alpha_cumprod`` where
    ``t_prev < 0`` (the last step of a trailing ladder).  On a CUDA device
    this blocks the host five times, each inside a ``host.sync`` span: three
    copies of host numbers, and two indexings by a 0-dim tensor, which read
    the index back to the host."""
    device = alphas_cumprod.device
    timestep = profiling.to_device(timestep, device)
    prev_timestep = profiling.to_device(prev_timestep, device)
    with profiling.host_sync():
        alpha_prod_t = alphas_cumprod[timestep]
    with profiling.host_sync():
        alpha_prod_prev = alphas_cumprod[prev_timestep.clamp(0, alphas_cumprod.shape[0] - 1)]
    alpha_prod_t_prev = torch.where(
        prev_timestep >= 0,
        alpha_prod_prev,
        profiling.to_device(final_alpha_cumprod, device, alphas_cumprod.dtype),
    )
    return alpha_prod_t, alpha_prod_t_prev


def add_noise(
    alphas_cumprod: torch.Tensor,
    original_samples: torch.Tensor,
    noise: torch.Tensor,
    timesteps: torch.Tensor,
) -> torch.Tensor:
    """DDPM forward process."""
    a = alphas_cumprod[timesteps].to(original_samples.dtype)
    a = a.reshape(a.shape + (1,) * (original_samples.ndim - a.ndim))
    return a**0.5 * original_samples + (1 - a) ** 0.5 * noise


def fm_euler_update(sample: torch.Tensor, velocity: torch.Tensor, dt) -> torch.Tensor:
    """Flow-matching Euler update ``x <- x + dt * v``."""
    return sample + dt * velocity


def fm_scale_noise(sigma: torch.Tensor, sample: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Flow-matching forward process ``x_sigma = sigma * noise + (1 - sigma) * x``."""
    sigma = sigma.reshape(sigma.shape + (1,) * (sample.ndim - sigma.ndim)).to(sample.dtype)
    return sigma * noise + (1.0 - sigma) * sample


def per_token_sigma_pair(
    per_token_timesteps: torch.Tensor,
    sigma_ladder: torch.Tensor,
    num_train_timesteps: int = 1000,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(current, next) sigmas ``[B, S]`` of the per-token branch: a token's
    next sigma is the largest ladder entry strictly below its current one
    (0 at the terminal)."""
    per_token_sigmas = per_token_timesteps.float() / num_train_timesteps
    ladder = sigma_ladder.float()[:, None, None]  # [L, 1, 1]
    lower_mask = ladder < per_token_sigmas[None] - 1e-6
    lower_sigmas = torch.where(lower_mask, ladder, torch.zeros_like(ladder)).amax(dim=0)
    return per_token_sigmas, lower_sigmas


def fm_per_token_update(
    sample: torch.Tensor,
    velocity: torch.Tensor,
    per_token_timesteps: torch.Tensor,
    sigma_ladder: torch.Tensor,
    num_train_timesteps: int = 1000,
) -> torch.Tensor:
    """Per-token Euler step (sample/velocity ``[B, S, C]``, timesteps
    ``[B, S]``) with ``dt = current - next``: positive, the mirror of the
    ladder branch's ``next - current``, as in the JAX package."""
    cur, low = per_token_sigma_pair(per_token_timesteps, sigma_ladder, num_train_timesteps)
    dt = (cur - low)[..., None]
    return (sample.float() + dt * velocity.float()).to(sample.dtype)
