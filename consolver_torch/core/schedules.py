"""Noise schedules for the DDPM family and sigma ladders for flow matching
(host-side numpy).

Port of ``consolver_tpu/core/schedules.py``.  Schedule construction is static
per configuration and step count and returns float32 numpy arrays that the
denoise loop moves to the device once.
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


# ---------------------------------------------------------------------------
# Flow-matching sigma schedules
# ---------------------------------------------------------------------------


def static_shift(sigmas: np.ndarray, shift: float) -> np.ndarray:
    """sigma <- s*sigma / (1 + (s-1)*sigma)  (scheduler_fmppo.py:146,215)."""
    return shift * sigmas / (1 + (shift - 1) * sigmas)


def time_shift(mu: float, sigma_pow: float, t: np.ndarray, kind: str = "exponential"):
    """Resolution-dependent dynamic shift (scheduler_fmppo.py:546-550)."""
    if kind == "exponential":
        return math.exp(mu) / (math.exp(mu) + (1 / t - 1) ** sigma_pow)
    if kind == "linear":
        return mu / (mu + (1 / t - 1) ** sigma_pow)
    raise ValueError("time_shift_type must be 'exponential' or 'linear'.")


def stretch_shift_to_terminal(t: np.ndarray, shift_terminal: float) -> np.ndarray:
    """Stretch the schedule so it terminates at shift_terminal
    (scheduler_fmppo.py:495-499)."""
    one_minus_z = 1 - t
    scale_factor = one_minus_z[-1] / (1 - shift_terminal)
    return 1 - (one_minus_z / scale_factor)


def convert_to_karras(
    in_sigmas: np.ndarray, num_inference_steps: int, rho: float = 7.0
) -> np.ndarray:
    sigma_min = float(in_sigmas[-1])
    sigma_max = float(in_sigmas[0])
    ramp = np.linspace(0, 1, num_inference_steps)
    min_inv_rho = sigma_min ** (1 / rho)
    max_inv_rho = sigma_max ** (1 / rho)
    return (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho


def convert_to_exponential(in_sigmas: np.ndarray, num_inference_steps: int):
    sigma_min = float(in_sigmas[-1])
    sigma_max = float(in_sigmas[0])
    return np.exp(np.linspace(math.log(sigma_max), math.log(sigma_min), num_inference_steps))


def convert_to_beta(
    in_sigmas: np.ndarray,
    num_inference_steps: int,
    alpha: float = 0.6,
    beta: float = 0.6,
) -> np.ndarray:
    try:
        import scipy.stats
    except ImportError as e:  # pragma: no cover - scipy is available in the image
        raise ImportError("scipy is required for beta sigmas") from e
    sigma_min = float(in_sigmas[-1])
    sigma_max = float(in_sigmas[0])
    return np.array(
        [
            sigma_min + (ppf * (sigma_max - sigma_min))
            for ppf in [
                scipy.stats.beta.ppf(timestep, alpha, beta)
                for timestep in 1 - np.linspace(0, 1, num_inference_steps)
            ]
        ]
    )


def calculate_flux_mu(
    image_seq_len: int,
    base_seq_len: int = 256,
    max_seq_len: int = 4096,
    base_shift: float = 0.5,
    max_shift: float = 1.15,
) -> float:
    """Resolution-dependent mu for FLUX (edit_ppo/pipeline.py:119-130)."""
    m = (max_shift - base_shift) / (max_seq_len - base_seq_len)
    b = base_shift - m * base_seq_len
    return image_seq_len * m + b


@dataclasses.dataclass(frozen=True)
class FlowMatchConfig:
    """Configuration of the flow-matching sigma machinery
    (scheduler_fmppo.py:107-139)."""

    num_train_timesteps: int = 1000
    shift: float = 1.0
    use_dynamic_shifting: bool = False
    base_shift: float = 0.5
    max_shift: float = 1.15
    base_image_seq_len: int = 256
    max_image_seq_len: int = 4096
    invert_sigmas: bool = False
    shift_terminal: Optional[float] = None
    use_karras_sigmas: bool = False
    use_exponential_sigmas: bool = False
    use_beta_sigmas: bool = False
    time_shift_type: str = "exponential"

    @classmethod
    def flux(cls) -> "FlowMatchConfig":
        """FLUX production config: dynamic resolution shift."""
        return cls(use_dynamic_shifting=True, base_shift=0.5, max_shift=1.15)


def fm_sigmas(
    config: FlowMatchConfig,
    num_inference_steps: int,
    mu: Optional[float] = None,
    sigmas: Optional[np.ndarray] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Build the inference sigma ladder and matching "timesteps".

    Returns (sigmas[num_steps + 1], timesteps[num_steps]); sigmas carries the
    appended terminal value (scheduler_fmppo.py:233-238).
    """
    if config.use_dynamic_shifting and mu is None:
        raise ValueError("mu must be passed when use_dynamic_shifting is True")

    if sigmas is None:
        sigma_max = static_shift(1.0, config.shift) if not config.use_dynamic_shifting else 1.0
        sigma_min = (
            static_shift(1.0 / config.num_train_timesteps, config.shift)
            if not config.use_dynamic_shifting
            else 1.0 / config.num_train_timesteps
        )
        # The reference seeds set_timesteps from the *already shifted* stored
        # sigma_min/max (scheduler_fmppo.py:144-151,203-207) and then shifts
        # again; for the default (shift applied once) path we reproduce the
        # net effect: linspace in t-space then one shift application.
        timesteps = np.linspace(
            sigma_max * config.num_train_timesteps,
            sigma_min * config.num_train_timesteps,
            num_inference_steps,
        )
        sigmas = timesteps / config.num_train_timesteps
    else:
        sigmas = np.asarray(sigmas, dtype=np.float32)
        num_inference_steps = len(sigmas)

    if config.use_dynamic_shifting:
        sigmas = time_shift(mu, 1.0, sigmas, config.time_shift_type)
    else:
        sigmas = static_shift(sigmas, config.shift)

    if config.shift_terminal:
        sigmas = stretch_shift_to_terminal(sigmas, config.shift_terminal)

    if config.use_karras_sigmas:
        sigmas = convert_to_karras(sigmas, num_inference_steps)
    elif config.use_exponential_sigmas:
        sigmas = convert_to_exponential(sigmas, num_inference_steps)
    elif config.use_beta_sigmas:
        sigmas = convert_to_beta(sigmas, num_inference_steps)

    sigmas = np.asarray(sigmas, dtype=np.float32)

    if config.invert_sigmas:
        sigmas = 1.0 - sigmas
        timesteps = sigmas * config.num_train_timesteps
        sigmas = np.concatenate([sigmas, np.ones(1, dtype=np.float32)])
    else:
        timesteps = sigmas * config.num_train_timesteps
        sigmas = np.concatenate([sigmas, np.zeros(1, dtype=np.float32)])

    return sigmas.astype(np.float32), timesteps.astype(np.float32)
