"""Noise schedules for the DDPM family (host-side numpy).

The port of the DDPM half of ``consolver_tpu/core/schedules.py``.  Schedule
construction is static per configuration and step count and returns float32
numpy arrays that the denoise loop moves to the device once.  The
flow-matching half arrives with the edit family.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np


def betas_for_alpha_bar(
    num_diffusion_timesteps: int,
    max_beta: float = 0.999,
    alpha_transform_type: str = "cosine",
) -> np.ndarray:
    """Beta schedule derived from an alpha-bar function (squaredcos_cap_v2)."""
    if alpha_transform_type == "cosine":

        def alpha_bar_fn(t):
            return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

    elif alpha_transform_type == "exp":

        def alpha_bar_fn(t):
            return math.exp(t * -12.0)

    else:
        raise ValueError(f"Unsupported alpha_transform_type: {alpha_transform_type}")

    betas = []
    for i in range(num_diffusion_timesteps):
        t1 = i / num_diffusion_timesteps
        t2 = (i + 1) / num_diffusion_timesteps
        betas.append(min(1 - alpha_bar_fn(t2) / alpha_bar_fn(t1), max_beta))
    return np.asarray(betas, dtype=np.float32)


def make_betas(
    num_train_timesteps: int = 1000,
    beta_start: float = 0.0001,
    beta_end: float = 0.02,
    beta_schedule: str = "linear",
    trained_betas: Optional[Sequence[float]] = None,
) -> np.ndarray:
    if trained_betas is not None:
        return np.asarray(trained_betas, dtype=np.float32)
    if beta_schedule == "linear":
        return np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float32)
    if beta_schedule == "scaled_linear":
        return (
            np.linspace(
                beta_start**0.5, beta_end**0.5, num_train_timesteps, dtype=np.float32
            )
            ** 2
        )
    if beta_schedule == "squaredcos_cap_v2":
        return betas_for_alpha_bar(num_train_timesteps)
    raise NotImplementedError(f"{beta_schedule} schedule not implemented.")


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Precomputed alpha-bar table for the DDPM family.

    ``final_alpha_cumprod`` is used when the previous timestep underflows
    below 0 at the last solver step.
    """

    num_train_timesteps: int
    betas: np.ndarray
    alphas_cumprod: np.ndarray
    final_alpha_cumprod: float
    prediction_type: str = "epsilon"

    @classmethod
    def create(
        cls,
        num_train_timesteps: int = 1000,
        beta_start: float = 0.0001,
        beta_end: float = 0.02,
        beta_schedule: str = "linear",
        trained_betas: Optional[Sequence[float]] = None,
        prediction_type: str = "epsilon",
    ) -> "DiffusionSchedule":
        betas = make_betas(
            num_train_timesteps, beta_start, beta_end, beta_schedule, trained_betas
        )
        alphas_cumprod = np.cumprod(1.0 - betas, axis=0).astype(np.float32)
        return cls(
            num_train_timesteps=num_train_timesteps,
            betas=betas,
            alphas_cumprod=alphas_cumprod,
            final_alpha_cumprod=float(alphas_cumprod[0]),
            prediction_type=prediction_type,
        )

    @classmethod
    def sd15(cls, prediction_type: str = "epsilon") -> "DiffusionSchedule":
        """The SD-1.5 production schedule."""
        return cls.create(
            num_train_timesteps=1000,
            beta_start=0.00085,
            beta_end=0.012,
            beta_schedule="scaled_linear",
            prediction_type=prediction_type,
        )


def spaced_timesteps(
    num_train_timesteps: int,
    num_inference_steps: int,
    spacing: str = "trailing",
    steps_offset: int = 0,
) -> np.ndarray:
    """Discrete inference timesteps, descending, int64."""
    if num_inference_steps > num_train_timesteps:
        raise ValueError(
            f"num_inference_steps ({num_inference_steps}) cannot exceed "
            f"num_train_timesteps ({num_train_timesteps})."
        )
    if spacing == "linspace":
        timesteps = (
            np.linspace(0, num_train_timesteps - 1, num_inference_steps)
            .round()[::-1]
            .copy()
            .astype(np.int64)
        )
    elif spacing == "leading":
        step_ratio = num_train_timesteps // num_inference_steps
        timesteps = (
            (np.arange(0, num_inference_steps) * step_ratio)
            .round()[::-1]
            .copy()
            .astype(np.int64)
        )
        timesteps += steps_offset
    elif spacing == "trailing":
        step_ratio = num_train_timesteps / num_inference_steps
        timesteps = (
            np.round(np.arange(num_train_timesteps, 0, -step_ratio)).astype(np.int64)
            - 1
        )
    else:
        raise ValueError(f"Unsupported timestep_spacing: {spacing}.")
    return timesteps
