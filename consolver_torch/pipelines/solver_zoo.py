"""Training-free baseline solvers for the DDPM family.

Port of ``consolver_tpu/pipelines/solver_zoo.py``: multistep DPM-Solver
("dpmsolver" / "dpmsolver++", orders 1-3, the ``sde-*`` variants), UniPC
(bh2 with the UniC corrector), DEIS, iPNDM, DDIM (leading, trailing for DMD2,
``eta > 0``) and the AMED plugin (learned integer schedules with time / grad
scales).

Every coefficient depends only on the step index, so each solver keeps its
tables in float64 numpy on the host and hands each coefficient to torch as a
Python ``float`` (a 0-d numpy array times an f32 tensor would give f64).
The denoise loop is an eager Python loop over the schedule; the solvers keep
their history in Python lists.

The stochastic variants (``sde-*``, and ddim / dmd2 with ``eta > 0``) draw
their per-step noise through ``noise_fn(i, shape)``; the denoise function
builds it from the rollout's ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from consolver_torch.core import schedules
from consolver_torch.policy.factor_net import ShardedGenerator

NoiseFn = Callable[[int, tuple], torch.Tensor]

# AMED-solver learned schedules printed by the AMED weights.
AMED_SCHEDULES = {
    4: {
        "amed": [999, 694, 500, 110, 0],
        "grad_scale": [1.0, 0.991, 1.0, 0.9912, 1.0],
        "time_scale": [1.0, 1.0333, 1.0, 0.9861, 1.0],
    },
    6: {
        "amed": [999, 758, 666, 495, 333, 107, 0],
        "grad_scale": [1.0, 0.9924, 1.0, 0.9916, 1.0, 0.9906, 1.0],
        "time_scale": [1.0, 1.052, 1.0, 0.9998, 1.0, 0.9781, 1.0],
    },
    8: {
        "amed": [999, 831, 749, 623, 500, 394, 250, 88, 0],
        "grad_scale": [1.0, 0.9976, 1.0, 0.991, 1.0, 0.9907, 1.0, 0.9905, 1.0],
        "time_scale": [1.0, 1.0257, 1.0, 0.9989, 1.0, 1.0022, 1.0, 0.9747, 1.0],
    },
    10: {
        "amed": [999, 885, 799, 705, 599, 492, 400, 329, 200, 73, 0],
        "grad_scale": [1.0, 0.9974, 1.0, 0.9904, 1.0, 0.991, 1.0, 0.9905, 1.0, 0.9904, 1.0],
        "time_scale": [1.0, 0.9872, 1.0, 1.0152, 1.0, 1.0186, 1.0, 0.9934, 1.0, 0.9731, 1.0],
    },
    14: {
        "amed": [999, 924, 856, 790, 714, 623, 571, 494, 428, 374, 285, 241, 143, 55, 0],
        "grad_scale": [1.0, 0.9922, 1.0, 0.9909, 1.0, 0.9914, 1.0, 0.9908, 1.0, 0.9904,
                       1.0, 0.9903, 1.0, 0.9904, 1.0],
        "time_scale": [1.0, 0.9835, 1.0, 1.0293, 1.0, 1.0216, 1.0, 1.0241, 1.0, 1.0021,
                       1.0, 0.9844, 1.0, 0.9714, 1.0],
    },
}


def _all_sigmas(schedule: schedules.DiffusionSchedule) -> np.ndarray:
    """Karras-style sigma table ``sqrt((1 - abar) / abar)``, float64."""
    abar = schedule.alphas_cumprod.astype(np.float64)
    return np.sqrt((1 - abar) / abar)


def _alpha_sigma(sigma):
    """A table sigma -> ``(alpha_t, sigma_t)`` with ``alpha^2 + sigma^2 = 1``."""
    alpha_t = 1.0 / np.sqrt(1.0 + sigma**2)
    return alpha_t, sigma * alpha_t


def _linspace_timesteps(num_train: int, num_steps: int) -> np.ndarray:
    """diffusers' multistep 'linspace' spacing:
    ``linspace(0, T-1, S+1).round()[::-1][:-1]``."""
    return (
        np.linspace(0, num_train - 1, num_steps + 1).round()[::-1][:-1].copy().astype(np.int64)
    )


def _sigma_ladder(schedule, timesteps: np.ndarray, final_sigmas_type: str) -> np.ndarray:
    table = _all_sigmas(schedule)
    sig = table[timesteps]
    if final_sigmas_type == "sigma_min":
        last = table[0]
    elif final_sigmas_type == "zero":
        last = 0.0
    else:
        raise ValueError(final_sigmas_type)
    return np.concatenate([sig, [last]])


class BaselineSolver:
    """``timesteps`` (the ints fed to the denoiser) and ``step(i, x, eps)``,
    called once per entry with the CFG-combined epsilon."""

    timesteps: np.ndarray

    def reset(self):
        raise NotImplementedError

    def step(self, i: int, x: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


def _draw(noise_fn: NoiseFn, i: int, x: torch.Tensor) -> torch.Tensor:
    return noise_fn(i, tuple(x.shape)).to(device=x.device, dtype=x.dtype)


# ---------------------------------------------------------------------------
# Multistep DPM-Solver (diffusers DPMSolverMultistepScheduler semantics)
# ---------------------------------------------------------------------------


class DpmMultistep(BaselineSolver):
    def __init__(
        self,
        schedule: schedules.DiffusionSchedule,
        num_steps: int,
        algorithm: str = "dpmsolver",
        solver_order: int = 2,
        final_sigmas_type: str = "sigma_min",
        lower_order_final: bool = True,
        custom_timesteps: Optional[Sequence[int]] = None,
        custom_sigmas: Optional[np.ndarray] = None,
        grad_scales: Optional[Sequence[float]] = None,
        noise_fn: Optional[NoiseFn] = None,
    ):
        # the sde-* variants follow the AMED plugin's stochastic updates and
        # need per-step variance noise
        assert algorithm in ("dpmsolver", "dpmsolver++", "sde-dpmsolver", "sde-dpmsolver++")
        if algorithm.startswith("sde-") and noise_fn is None:
            raise ValueError(f"{algorithm} requires noise_fn")
        self.noise_fn = noise_fn
        self.algorithm = algorithm
        self.solver_order = solver_order
        self.num_steps = num_steps
        if custom_timesteps is not None:
            self.timesteps = np.asarray(custom_timesteps, np.int64)
            self.sigmas = np.asarray(custom_sigmas, np.float64)
        else:
            self.timesteps = _linspace_timesteps(schedule.num_train_timesteps, num_steps)
            self.sigmas = _sigma_ladder(schedule, self.timesteps, final_sigmas_type)
        self.lower_order_final = lower_order_final
        self.final_sigmas_type = final_sigmas_type
        self.grad_scales = (
            list(grad_scales) if grad_scales is not None else [1.0] * len(self.timesteps)
        )
        self.reset()

    def reset(self):
        self.hist: List[torch.Tensor] = []
        self.lower_order_nums = 0

    def _convert(self, i: int, x, eps):
        """eps -> the solver's prediction space (x0 for the ++ variants)."""
        if self.algorithm in ("dpmsolver", "sde-dpmsolver"):
            return eps
        alpha_t, sigma_t = _alpha_sigma(self.sigmas[i])
        return (x - float(sigma_t) * eps) / float(alpha_t)

    def _noise(self, i: int, x):
        return _draw(self.noise_fn, i, x)

    def _lam(self, i: int) -> float:
        alpha_t, sigma_t = _alpha_sigma(self.sigmas[i])
        return float(np.log(alpha_t) - np.log(sigma_t))

    def step(self, i: int, x, eps):
        n = len(self.timesteps)
        lower_order_final = (i == n - 1) and (
            (self.lower_order_final and n < 15) or self.final_sigmas_type == "zero"
        )
        lower_order_second = (i == n - 2) and self.lower_order_final and n < 15

        m = self._convert(i, x, eps)
        self.hist = (self.hist + [m])[-self.solver_order:]
        scale = float(self.grad_scales[i])

        alpha_t, sigma_t = _alpha_sigma(self.sigmas[i + 1])
        alpha_s0, sigma_s0 = _alpha_sigma(self.sigmas[i])
        lam_t, lam_s0 = self._lam(i + 1), self._lam(i)
        h = lam_t - lam_s0

        first = self.solver_order == 1 or self.lower_order_nums < 1 or lower_order_final
        second = self.solver_order == 2 or self.lower_order_nums < 2 or lower_order_second

        if first:
            m0 = self.hist[-1]
            if self.algorithm == "dpmsolver++":
                x = float(sigma_t / sigma_s0) * x - scale * float(
                    alpha_t * (math.exp(-h) - 1.0)) * m0
            elif self.algorithm == "dpmsolver":
                x = float(alpha_t / alpha_s0) * x - scale * float(
                    sigma_t * (math.exp(h) - 1.0)) * m0
            elif self.algorithm == "sde-dpmsolver++":
                noise = self._noise(i, x)
                x = (float(sigma_t / sigma_s0 * math.exp(-h)) * x
                     + scale * float(alpha_t * (1 - math.exp(-2.0 * h))) * m0
                     + float(sigma_t * math.sqrt(1.0 - math.exp(-2 * h))) * noise)
            else:  # sde-dpmsolver
                noise = self._noise(i, x)
                x = (float(alpha_t / alpha_s0) * x
                     - scale * 2.0 * float(sigma_t * (math.exp(h) - 1.0)) * m0
                     + float(sigma_t * math.sqrt(math.exp(2 * h) - 1.0)) * noise)
        elif second:
            lam_s1 = self._lam(i - 1)
            h_0 = lam_s0 - lam_s1
            r0 = h_0 / h
            m0, m1 = self.hist[-1], self.hist[-2]
            d0 = m0
            d1 = (m0 - m1) / float(r0)
            if self.algorithm == "dpmsolver++":  # midpoint
                c = float(alpha_t * (math.exp(-h) - 1.0))
                x = float(sigma_t / sigma_s0) * x - scale * c * d0 - scale * 0.5 * c * d1
            elif self.algorithm == "dpmsolver":  # midpoint
                c = float(sigma_t * (math.exp(h) - 1.0))
                x = float(alpha_t / alpha_s0) * x - scale * c * d0 - scale * 0.5 * c * d1
            elif self.algorithm == "sde-dpmsolver++":  # midpoint
                noise = self._noise(i, x)
                c = float(alpha_t * (1 - math.exp(-2.0 * h)))
                x = (float(sigma_t / sigma_s0 * math.exp(-h)) * x
                     + scale * c * d0 + scale * 0.5 * c * d1
                     + float(sigma_t * math.sqrt(1.0 - math.exp(-2 * h))) * noise)
            else:  # sde-dpmsolver midpoint
                noise = self._noise(i, x)
                c = float(sigma_t * (math.exp(h) - 1.0))
                x = (float(alpha_t / alpha_s0) * x - scale * 2.0 * c * d0 - scale * c * d1
                     + float(sigma_t * math.sqrt(math.exp(2 * h) - 1.0)) * noise)
        else:  # third order
            if self.algorithm.startswith("sde-"):
                raise NotImplementedError(
                    "sde variants support solver_order <= 2 (as in the plugin)")
            lam_s1, lam_s2 = self._lam(i - 1), self._lam(i - 2)
            h_0, h_1 = lam_s0 - lam_s1, lam_s1 - lam_s2
            r0, r1 = h_0 / h, h_1 / h
            m0, m1, m2 = self.hist[-1], self.hist[-2], self.hist[-3]
            d1_0 = (m0 - m1) / float(r0)
            d1_1 = (m1 - m2) / float(r1)
            d1 = d1_0 + float(r0 / (r0 + r1)) * (d1_0 - d1_1)
            d2 = (d1_0 - d1_1) / float(r0 + r1)
            if self.algorithm == "dpmsolver++":
                x = (float(sigma_t / sigma_s0) * x
                     - scale * float(alpha_t * (math.exp(-h) - 1.0)) * m0
                     + scale * float(alpha_t * ((math.exp(-h) - 1.0) / h + 1.0)) * d1
                     - scale * float(alpha_t * ((math.exp(-h) - 1.0 + h) / h**2 - 0.5)) * d2)
            else:
                x = (float(alpha_t / alpha_s0) * x
                     - scale * float(sigma_t * (math.exp(h) - 1.0)) * m0
                     - scale * float(sigma_t * ((math.exp(h) - 1.0) / h - 1.0)) * d1
                     - scale * float(sigma_t * ((math.exp(h) - 1.0 - h) / h**2 - 0.5)) * d2)
        if self.lower_order_nums < self.solver_order:
            self.lower_order_nums += 1
        return x


def amed_solver(schedule: schedules.DiffusionSchedule, num_steps: int) -> DpmMultistep:
    """The AMED plugin: dpmsolver++ over the learned integer schedule, with
    the time-scale sigma snap and per-step grad scales."""
    if num_steps not in AMED_SCHEDULES:
        raise ValueError(f"AMED schedule only published for {sorted(AMED_SCHEDULES)} steps")
    sched_tbl = AMED_SCHEDULES[num_steps]
    ts = list(sched_tbl["amed"])
    table = _all_sigmas(schedule)
    sigmas = table[np.asarray(ts)]
    timesteps = np.asarray(ts[:-1], np.int64)  # drop the trailing 0
    # snap each odd-indexed sigma scaled by time_scale to the nearest table
    # sigma between its neighbours, and remap its timestep
    time_scale = sched_tbl["time_scale"]
    for i in range(len(time_scale)):
        if i % 2 == 1:
            target = sigmas[i] * time_scale[i]
            lo, hi = ts[i + 1] + 1, ts[i - 1]
            source = table[lo:hi]
            timesteps[i] = lo + int(np.argmin(np.abs(source - target)))
    return DpmMultistep(schedule, num_steps, algorithm="dpmsolver++",
                        custom_timesteps=timesteps, custom_sigmas=sigmas,
                        grad_scales=sched_tbl["grad_scale"])


# ---------------------------------------------------------------------------
# DEIS (logrho, order 2, eps space): diffusers DEISMultistepScheduler
# ---------------------------------------------------------------------------


class Deis(BaselineSolver):
    def __init__(self, schedule: schedules.DiffusionSchedule, num_steps: int,
                 solver_order: int = 2, lower_order_final: bool = True):
        self.num_steps = num_steps
        self.solver_order = solver_order
        self.lower_order_final = lower_order_final
        self.timesteps = _linspace_timesteps(schedule.num_train_timesteps, num_steps)
        self.sigmas = _sigma_ladder(schedule, self.timesteps, "sigma_min")
        self.reset()

    def reset(self):
        self.hist: List[torch.Tensor] = []
        self.lower_order_nums = 0

    def step(self, i: int, x, eps):
        n = len(self.timesteps)
        lower_order_final = (i == n - 1) and self.lower_order_final and n < 15
        lower_order_second = (i == n - 2) and self.lower_order_final and n < 15

        # DEIS keeps an epsilon-space history
        self.hist = (self.hist + [eps])[-self.solver_order:]

        alpha_t, sigma_t = _alpha_sigma(self.sigmas[i + 1])
        alpha_s0, sigma_s0 = _alpha_sigma(self.sigmas[i])

        first = self.solver_order == 1 or self.lower_order_nums < 1 or lower_order_final
        second = self.solver_order == 2 or self.lower_order_nums < 2 or lower_order_second

        if first:
            lam_t = float(np.log(alpha_t) - np.log(sigma_t))
            lam_s = float(np.log(alpha_s0) - np.log(sigma_s0))
            h = lam_t - lam_s
            x = float(alpha_t / alpha_s0) * x - float(sigma_t * (math.exp(h) - 1.0)) * self.hist[-1]
        elif second:
            rho_t = float(sigma_t / alpha_t)
            rho_s0 = float(sigma_s0 / alpha_s0)
            a1, s1 = _alpha_sigma(self.sigmas[i - 1])
            rho_s1 = float(s1 / a1)

            def ind_fn(t, b, c):
                # integral of the log-Lagrange basis (DEIS 'logrho')
                return t * (-math.log(c) + math.log(t) - 1.0) / (math.log(b) - math.log(c))

            coef1 = ind_fn(rho_t, rho_s0, rho_s1) - ind_fn(rho_s0, rho_s0, rho_s1)
            coef2 = ind_fn(rho_t, rho_s1, rho_s0) - ind_fn(rho_s0, rho_s1, rho_s0)
            m0, m1 = self.hist[-1], self.hist[-2]
            x = float(alpha_t) * (x / float(alpha_s0) + float(coef1) * m0 + float(coef2) * m1)
        else:
            raise NotImplementedError("DEIS third order not needed (order<=2)")
        if self.lower_order_nums < self.solver_order:
            self.lower_order_nums += 1
        return x


# ---------------------------------------------------------------------------
# UniPC (bh2, predict_x0, with the UniC corrector): diffusers
# UniPCMultistepScheduler
# ---------------------------------------------------------------------------


class UniPC(BaselineSolver):
    def __init__(self, schedule: schedules.DiffusionSchedule, num_steps: int,
                 solver_order: int = 2, lower_order_final: bool = True):
        self.num_steps = num_steps
        self.solver_order = solver_order
        self.lower_order_final = lower_order_final
        self.timesteps = _linspace_timesteps(schedule.num_train_timesteps, num_steps)
        self.sigmas = _sigma_ladder(schedule, self.timesteps, "sigma_min")
        self.reset()

    def reset(self):
        self.hist: List[torch.Tensor] = []
        self.last_x = None
        self.lower_order_nums = 0
        self.last_order = None

    def _as(self, idx: int):
        return _alpha_sigma(self.sigmas[idx])

    def _x0(self, idx: int, x, eps):
        alpha_t, sigma_t = self._as(idx)
        return (x - float(sigma_t) * eps) / float(alpha_t)

    def _bh_coeffs(self, idx_t: int, idx_s0: int, hist_idx: List[int], order: int):
        """rks / R / b of the B(h) expansion at the transition s0 -> t, with
        the earlier nodes ``hist_idx``."""
        alpha_t, sigma_t = self._as(idx_t)
        alpha_s0, sigma_s0 = self._as(idx_s0)

        def lam(a, s):
            return math.log(a) - math.log(s)

        lam_t, lam_s0 = lam(alpha_t, sigma_t), lam(alpha_s0, sigma_s0)
        h = lam_t - lam_s0
        rks = []
        for si in hist_idx:
            a, s = self._as(si)
            rks.append((lam(a, s) - lam_s0) / h)
        rks.append(1.0)
        rks = np.asarray(rks, np.float64)

        hh = -h  # predict_x0
        h_phi_1 = math.expm1(hh)
        h_phi_k = h_phi_1 / hh - 1
        b_h = math.expm1(hh)  # bh2
        R, b = [], []
        factorial_i = 1.0
        for i in range(1, order + 1):
            R.append(rks ** (i - 1))
            b.append(h_phi_k * factorial_i / b_h)
            factorial_i *= i + 1
            h_phi_k = h_phi_k / hh - 1 / factorial_i
        return (float(alpha_t), float(sigma_t), float(sigma_s0), float(h_phi_1),
                float(b_h), rks, np.stack(R), np.asarray(b, np.float64))

    def step(self, i: int, x, eps):
        n = len(self.timesteps)
        m_t = self._x0(i, x, eps)

        # corrector (UniC) on the transition just taken
        if i > 0 and self.last_x is not None:
            order = self.last_order
            hist_idx = [i - 1 - k for k in range(1, order)]
            (alpha_t, sigma_t, sigma_s0, h_phi_1, b_h, rks, R, b) = self._bh_coeffs(
                i, i - 1, hist_idx, order)
            m0 = self.hist[-1]
            d1s = [(self.hist[-(k + 2)] - m0) / float(rks[k]) for k in range(order - 1)]
            rhos_c = np.asarray([0.5]) if order == 1 else np.linalg.solve(R, b)
            x_t_ = float(sigma_t / sigma_s0) * self.last_x - float(alpha_t * h_phi_1) * m0
            corr = sum(float(rhos_c[k]) * d1s[k] for k in range(order - 1))
            d1_t = m_t - m0
            x = x_t_ - float(alpha_t * b_h) * (corr + float(rhos_c[-1]) * d1_t)

        # diffusers converts the model output once, with the pre-corrector
        # sample, and stores that conversion; the corrected x only feeds the
        # predictor
        self.hist = (self.hist + [m_t])[-self.solver_order:]

        # predictor (UniP)
        this_order = min(self.solver_order, n - i) if self.lower_order_final else self.solver_order
        this_order = min(this_order, self.lower_order_nums + 1)
        self.last_order = this_order

        hist_idx = [i - k for k in range(1, this_order)]
        (alpha_t, sigma_t, sigma_s0, h_phi_1, b_h, rks, R, b) = self._bh_coeffs(
            i + 1, i, hist_idx, this_order)
        m0 = self.hist[-1]
        d1s = [(self.hist[-(k + 2)] - m0) / float(rks[k]) for k in range(this_order - 1)]
        self.last_x = x
        x_t_ = float(sigma_t / sigma_s0) * x - float(alpha_t * h_phi_1) * m0
        if d1s:
            rhos_p = np.asarray([0.5]) if this_order == 2 else np.linalg.solve(R[:-1, :-1], b[:-1])
            pred = sum(float(rhos_p[k]) * d1s[k] for k in range(this_order - 1))
            x = x_t_ - float(alpha_t * b_h) * pred
        else:
            x = x_t_
        if self.lower_order_nums < self.solver_order:
            self.lower_order_nums += 1
        return x


# ---------------------------------------------------------------------------
# iPNDM / PLMS: diffusers PNDMScheduler with skip_prk_steps=True (the SD
# config), 'leading' spacing, steps_offset 1
# ---------------------------------------------------------------------------


class IPndm(BaselineSolver):
    def __init__(self, schedule: schedules.DiffusionSchedule, num_steps: int,
                 steps_offset: int = 1):
        self.schedule = schedule
        self.num_steps = num_steps
        self.step_ratio = schedule.num_train_timesteps // num_steps
        base = (np.arange(0, num_steps) * self.step_ratio).round().astype(np.int64)
        base = base + steps_offset  # ascending
        # the PLMS schedule repeats the second-to-last ascending entry
        plms = np.concatenate([base[:-1], base[-2:-1], base[-1:]])[::-1].copy()
        self.timesteps = plms
        self.reset()

    def reset(self):
        self.ets: List[torch.Tensor] = []
        self.cur_sample = None
        self.counter = 0

    def _prev_sample(self, sample, t: int, t_prev: int, model_output):
        abar = self.schedule.alphas_cumprod
        a_t = float(abar[t])
        a_prev = float(abar[t_prev]) if t_prev >= 0 else float(self.schedule.final_alpha_cumprod)
        # PNDM's closed-form x_{t-1} (the DDIM x0-form update)
        x0 = (sample - (1 - a_t) ** 0.5 * model_output) / a_t**0.5
        return a_prev**0.5 * x0 + (1 - a_prev) ** 0.5 * model_output

    def step(self, i: int, x, eps):
        t = int(self.timesteps[i])
        if self.counter != 1:
            self.ets = self.ets[-3:]
            self.ets.append(eps)
            t_prev = t - self.step_ratio
        else:
            t_prev = t
            t = t + self.step_ratio

        if len(self.ets) == 1 and self.counter == 0:
            model_output = eps
            self.cur_sample = x
        elif len(self.ets) == 1 and self.counter == 1:
            model_output = (eps + self.ets[-1]) / 2
            x = self.cur_sample
            self.cur_sample = None
        elif len(self.ets) == 2:
            model_output = (3 * self.ets[-1] - self.ets[-2]) / 2
        elif len(self.ets) == 3:
            model_output = (23 * self.ets[-1] - 16 * self.ets[-2] + 5 * self.ets[-3]) / 12
        else:
            model_output = (1 / 24) * (55 * self.ets[-1] - 59 * self.ets[-2]
                                       + 37 * self.ets[-3] - 9 * self.ets[-4])
        self.counter += 1
        return self._prev_sample(x, t, t_prev, model_output)


# ---------------------------------------------------------------------------
# DDIM (with trailing spacing for DMD2-distilled weights)
# ---------------------------------------------------------------------------


class Ddim(BaselineSolver):
    def __init__(
        self,
        schedule: schedules.DiffusionSchedule,
        num_steps: int,
        timestep_spacing: str = "leading",
        steps_offset: int = 1,
        eta: float = 0.0,
        noise_fn: Optional[NoiseFn] = None,
    ):
        """``eta > 0``: stochastic DDIM with per-step variance
        ``eta * sqrt((1-a_prev)/(1-a_t)) * sqrt(1 - a_t/a_prev)``."""
        if eta > 0 and noise_fn is None:
            raise ValueError("eta > 0 requires noise_fn")
        self.schedule = schedule
        self.eta = eta
        self.noise_fn = noise_fn
        self.timesteps = schedules.spaced_timesteps(
            schedule.num_train_timesteps, num_steps, timestep_spacing, steps_offset)
        self.step_ratio = schedule.num_train_timesteps // num_steps
        self.reset()

    def reset(self):
        pass

    def step(self, i: int, x, eps):
        t = int(self.timesteps[i])
        t_prev = t - self.step_ratio
        abar = self.schedule.alphas_cumprod
        a_t = float(abar[t])
        a_prev = float(abar[t_prev]) if t_prev >= 0 else float(self.schedule.final_alpha_cumprod)
        x0 = (x - (1 - a_t) ** 0.5 * eps) / a_t**0.5
        if self.eta <= 0:
            return a_prev**0.5 * x0 + (1 - a_prev) ** 0.5 * eps
        sigma = self.eta * math.sqrt((1 - a_prev) / (1 - a_t)) * math.sqrt(1 - a_t / a_prev)
        noise = _draw(self.noise_fn, i, x)
        return (a_prev**0.5 * x0 + math.sqrt(max(1 - a_prev - sigma**2, 0.0)) * eps
                + sigma * noise)


# ---------------------------------------------------------------------------
# Registry and the denoise loop
# ---------------------------------------------------------------------------

SOLVERS = (
    "ddim", "ipndm", "unipc", "deis", "multistep-dpm", "amed", "dmd2",
    "sde-dpmsolver", "sde-dpmsolver++",
)


def make_solver(
    name: str,
    schedule: schedules.DiffusionSchedule,
    num_steps: int,
    noise_fn: Optional[NoiseFn] = None,
    eta: float = 0.0,
) -> BaselineSolver:
    """A zoo solver by its reference name.  ``sde-*`` need ``noise_fn``, as
    do ddim / dmd2 with ``eta > 0``."""
    if name == "ddim":
        return Ddim(schedule, num_steps, eta=eta, noise_fn=noise_fn)
    if name == "dmd2":  # DDIM-trailing; pair with DMD2-distilled UNet weights
        return Ddim(schedule, num_steps, timestep_spacing="trailing", steps_offset=0,
                    eta=eta, noise_fn=noise_fn)
    if eta > 0:
        raise ValueError(f"eta only applies to ddim/dmd2, not {name!r}")
    if name == "ipndm":
        return IPndm(schedule, num_steps)
    if name == "unipc":
        return UniPC(schedule, num_steps)
    if name == "deis":
        return Deis(schedule, num_steps)
    if name == "multistep-dpm":
        return DpmMultistep(schedule, num_steps, algorithm="dpmsolver",
                            final_sigmas_type="sigma_min")
    if name in ("sde-dpmsolver", "sde-dpmsolver++"):
        return DpmMultistep(schedule, num_steps, algorithm=name, final_sigmas_type="sigma_min",
                            noise_fn=noise_fn)
    if name == "amed":
        return amed_solver(schedule, num_steps)
    raise ValueError(f"Unknown solver {name!r}; one of {SOLVERS}")


def make_baseline_denoise_fn(
    unet_apply: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
    schedule: schedules.DiffusionSchedule,
    solver_name: str,
    num_inference_steps: int,
    guidance_scale: float = 3.0,
    eta: float = 0.0,
    noise_fn: Optional[NoiseFn] = None,
):
    """The eager denoise loop of a zoo solver:
    ``(generator, noise, context, uncond_context) -> final latents``.
    CFG-batched like the learnable pipeline (one 2B UNet call per entry, in
    ``[uncond, text]`` order).  A stochastic solver draws its per-step noise
    from ``generator`` (on the latents' device), unless ``noise_fn`` is
    given; a deterministic one ignores ``generator``."""
    do_cfg = guidance_scale > 1.0
    stochastic = solver_name.startswith("sde-") or eta > 0

    def denoise(generator, noise, context, uncond_context):
        x = noise.float()
        draw = noise_fn
        if stochastic and draw is None:
            if generator is None:
                raise ValueError(f"{solver_name} (eta={eta}) needs a generator")

            def draw(i, shape):
                return ShardedGenerator.of(generator, shape[0]).randn(shape, x.device)

        solver = make_solver(solver_name, schedule, num_inference_steps, noise_fn=draw, eta=eta)
        batch = x.shape[0]
        full_ctx = torch.cat([uncond_context, context], dim=0) if do_cfg else context
        for i, t in enumerate(solver.timesteps):
            if do_cfg:
                t_in = torch.full((2 * batch,), int(t), dtype=torch.int64, device=x.device)
                eps_all = unet_apply(torch.cat([x, x], dim=0), t_in, full_ctx)
                e_u, e_c = eps_all.chunk(2, dim=0)
                eps = e_u + guidance_scale * (e_c - e_u)
            else:
                t_in = torch.full((batch,), int(t), dtype=torch.int64, device=x.device)
                eps = unet_apply(x, t_in, context)
            x = solver.step(i, x, eps.float())
        return x

    return denoise
