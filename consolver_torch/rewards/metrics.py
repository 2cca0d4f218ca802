"""Consistency reward metrics, batched, on tensors.

Port of ``consolver_tpu/rewards/metrics.py``.  Every metric is a plain
batched function; images are NHWC in [0, 1].  Dtypes follow the JAX
functions: a mean over bf16 images is bf16 (``jnp.mean`` keeps the input
type), so a bf16 decode gives bf16 rewards.

Formulas:
  * feature cosine -> [0, 100]:   ``(cos + 1) * 50``
  * image PSNR:  ``10 log10(1 / (mse + 1e-8))`` clamped to [0, 100]
  * depth PSNR:  per-map min-max normalization, then PSNR clamped >= 0
  * segmentation "dice": pixel accuracy * 100 (the reference's name)
"""

from __future__ import annotations

from typing import Callable

import torch


def image_psnr_reward(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``[B, H, W, C]`` x2 -> ``[B]`` PSNR in [0, 100]."""
    mse = ((pred - target) ** 2).mean(dim=(1, 2, 3))
    psnr = 10.0 * torch.log10(1.0 / (mse + 1e-8))
    return psnr.clamp(0.0, 100.0)


def feature_cosine_reward(
    pred_features: torch.Tensor, target_features: torch.Tensor, eps: float = 1e-8
) -> torch.Tensor:
    """``[B, D]`` features x2 -> ``[B]`` cosine similarity scaled to [0, 100]."""
    def unit(x):
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(eps)

    return ((unit(pred_features) * unit(target_features)).sum(dim=-1) + 1.0) * 50.0


def _minmax_normalize(depth: torch.Tensor) -> torch.Tensor:
    """Per-map min-max normalization to [0, 1]."""
    lo = depth.amin(dim=(-2, -1), keepdim=True)
    hi = depth.amax(dim=(-2, -1), keepdim=True)
    return (depth - lo) / (hi - lo + 1e-8)


def depth_psnr_reward(pred_depth: torch.Tensor, target_depth: torch.Tensor) -> torch.Tensor:
    """``[B, H, W]`` depth maps x2 -> ``[B]`` PSNR of the min-max-normalized
    maps, clamped non-negative."""
    diff = _minmax_normalize(pred_depth) - _minmax_normalize(target_depth)
    mse = (diff**2).mean(dim=(-2, -1))
    psnr = 10.0 * torch.log10(1.0 / (mse + 1e-8))
    return psnr.clamp_min(0.0)


def segmentation_reward(pred_mask: torch.Tensor, target_mask: torch.Tensor) -> torch.Tensor:
    """``[B, H, W]`` integer class masks x2 -> ``[B]`` pixel accuracy * 100."""
    return (pred_mask == target_mask).float().mean(dim=(-2, -1)) * 100.0


def encoder_cosine_reward(
    encode_fn: Callable[[torch.Tensor], torch.Tensor],
    pred: torch.Tensor,
    target: torch.Tensor,
) -> torch.Tensor:
    """Backbone-feature consistency (dino / clip / inception rewards): one
    batched encoder call over ``[pred; target]``."""
    pf, tf = encode_fn(torch.cat([pred, target], dim=0)).chunk(2, dim=0)
    return feature_cosine_reward(pf, tf)
