"""Flow-matching denoise loops: the learnable FMPPO solver and the
training-free FM baseline solvers.

Port of ``consolver_tpu/pipelines/fm.py``.  The model is abstracted as
``velocity_fn(x, timestep[B], cond) -> v`` with the timestep in train units
(``sigma * 1000``).  Each step of the learnable loop runs the velocity model,
pushes ``v`` into the solver history, lets the FactorNet pick an action from
the sigma pair, combines the history and takes the Euler step
``x + (sigma_next - sigma_t) * v_hat``; the trajectory drops step 0 and a
pad step of the padded program passes latents and history through, as in
:mod:`consolver_torch.pipelines.t2i`.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from consolver_torch.core import schedules, solver
from consolver_torch.models.vae import chunked_apply
from consolver_torch.pipelines.base import Pipeline
from consolver_torch.pipelines.t2i import Trajectory, _solver_dims
from consolver_torch.policy.factor_net import FactorNet
from consolver_torch.utils import profiling

FM_SOLVERS = ("euler", "heun", "dpm-solver", "dpm-solver-multistep")

VelocityFn = Callable[[torch.Tensor, torch.Tensor, object], torch.Tensor]


def _make_fm_loop(
    velocity_fn: VelocityFn,
    factor_net: Optional[FactorNet],
    record_trajectory: bool,
    deterministic_policy: bool,
    per_token_ladder: Optional[np.ndarray] = None,
    num_train_timesteps: int = 1000,
):
    """The step loop shared by the per-count, padded and per-token programs,
    over a host ladder ``(ts, sig_t, sig_next, valid)``.  With
    ``per_token_ladder`` (the sigma ladder with its terminal 0) each token
    steps by its own sigma pair and the carried per-token timesteps descend
    the ladder independently."""
    order_dim, scaler_dim, action_dims = _solver_dims(factor_net)
    use_conv = factor_net is not None and factor_net.config.use_conv

    def step(generator, cond, t, s_t, s_next, v_row, x, st, ptts, ladder, padded):
        """One step: the velocity model, then the policy and the solver
        update (``pipeline.policy``); returns (x, state, per-token
        timesteps, the step's record)."""
        device = x.device
        batch = x.shape[0]
        t_in = torch.full((batch,), t, dtype=torch.float32, device=device)
        vel = velocity_fn(x, t_in, cond).float()

        with profiling.span("pipeline.policy"):
            x32 = x.float()
            conds_x = profiling.to_device([s_t, s_next], device, torch.float32)
            conds_x = conds_x[None].expand(batch, 2)
            st_new = solver.push(st, vel)
            if factor_net is not None:
                conds = {"x": conds_x, "epsilon": st_new.ets}
                if deterministic_policy:
                    actions, probs = factor_net.mode_action(conds)
                else:
                    actions, probs = factor_net.sample_action(conds, generator)
            else:
                actions = torch.zeros((batch, action_dims), device=device)
                probs = torch.ones((batch, action_dims), device=device)

            order_actions, scale_actions, _ = solver.split_actions(actions, order_dim, scaler_dim)
            coeffs = solver.normalized_coefficients(order_actions.float(), st_new.num_ets, order_dim)
            effective = solver.combine(st_new, coeffs)
            effective, x32 = solver.apply_scalers(effective, x32, scale_actions.float())
            masks = solver.warmup_masks(st_new.num_ets, order_dim, action_dims, batch, device) * v_row

            if per_token_ladder is not None:
                cur_s, low_s = solver.per_token_sigma_pair(ptts, ladder, num_train_timesteps)
                x = (x32 + (cur_s - low_s)[..., None] * effective).to(x.dtype)
                ptts = low_s * num_train_timesteps
                st = st_new
            elif v_row > 0:
                # dt in f32, as the JAX package subtracts the f32 ladder entries
                dt = float(np.float32(s_next) - np.float32(s_t))
                x = solver.fm_euler_update(x32, effective, dt).to(x.dtype)
                st = st_new
        record = None
        if record_trajectory:
            record = {"conds_x": conds_x, "actions": actions, "probs": probs, "masks": masks}
            if padded:
                record["valid"] = torch.full((batch,), float(v_row), device=device)
            if use_conv:  # the history after the step (unchanged on a pad step)
                record["conds_eps"] = st.ets
        return x, st, ptts, record

    def loop(generator, noise, cond, ts, sig_t, sig_next, valid, padded, per_token_timesteps=None):
        device = noise.device
        batch = noise.shape[0]
        st = solver.init_state(batch, order_dim, tuple(noise.shape[1:]), device=device)
        x = noise
        ladder = ptts = None
        if per_token_ladder is not None:
            ladder = profiling.to_device(per_token_ladder, device, torch.float32)
            ptts = profiling.to_device(per_token_timesteps, device, torch.float32)
        records = []
        for i, (t, s_t, s_next, v_row) in enumerate(zip(ts.tolist(), sig_t.tolist(),
                                                        sig_next.tolist(), valid.tolist())):
            with profiling.span("pipeline.step", i):
                x, st, ptts, record = step(generator, cond, t, s_t, s_next, v_row, x, st, ptts,
                                           ladder, padded)
            if record is not None:
                records.append(record)

        if not record_trajectory:
            return x, None
        stacked = {name: torch.stack([r[name] for r in records], dim=1)[:, 1:] for name in records[0]}
        return x, Trajectory(**stacked)

    return loop


def make_fm_denoise_fn(
    velocity_fn: VelocityFn,
    fm_config: schedules.FlowMatchConfig,
    factor_net: Optional[FactorNet],
    num_inference_steps: int,
    mu: Optional[float] = None,
    record_trajectory: bool = True,
    per_token: bool = False,
    deterministic_policy: bool = False,
):
    """The learnable-FM denoise function: ``(generator, noise, cond) ->
    (latents, Trajectory or None)``.

    ``per_token=True`` takes a trailing ``per_token_timesteps`` ``[B, S]``
    argument (noise token-major ``[B, S, C]``): each token steps with
    ``dt = its sigma - the largest ladder sigma below it`` (positive, the
    mirror of the ladder branch), while the policy conds and the velocity
    model keep the ladder's sigma pair and timestep.
    ``deterministic_policy=True`` takes the mode action."""
    sigmas, timesteps = schedules.fm_sigmas(fm_config, num_inference_steps, mu=mu)
    valid = np.ones(num_inference_steps, np.float32)
    loop = _make_fm_loop(velocity_fn, factor_net, record_trajectory, deterministic_policy,
                         per_token_ladder=sigmas if per_token else None,
                         num_train_timesteps=fm_config.num_train_timesteps)

    def denoise(generator, noise, cond, per_token_timesteps=None):
        if per_token and per_token_timesteps is None:
            raise ValueError("the per-token program needs per_token_timesteps [B, S]")
        return loop(generator, noise, cond, timesteps, sigmas[:-1], sigmas[1:], valid,
                    padded=False, per_token_timesteps=per_token_timesteps)

    return denoise


def padded_fm_ladder(
    fm_config: schedules.FlowMatchConfig,
    num_inference_steps: int,
    max_steps: int,
    mu: Optional[float] = None,
):
    """The ``num_inference_steps`` FM ladder front-loaded into ``[max_steps]``
    host arrays ``(ts, sig_t, sig_next, valid)``; pad steps repeat the last
    entries."""
    if not 1 <= num_inference_steps <= max_steps:
        raise ValueError(f"need 1 <= num_inference_steps ({num_inference_steps}) <= {max_steps}")
    sigmas, timesteps = schedules.fm_sigmas(fm_config, num_inference_steps, mu=mu)
    pad = max_steps - num_inference_steps

    def padded(a):
        a = np.asarray(a, np.float32)
        return np.concatenate([a, np.repeat(a[-1:], pad)])

    valid = np.concatenate([np.ones(num_inference_steps), np.zeros(pad)]).astype(np.float32)
    return padded(timesteps), padded(sigmas[:-1]), padded(sigmas[1:]), valid


def make_padded_fm_denoise_fn(
    velocity_fn: VelocityFn,
    fm_config: schedules.FlowMatchConfig,
    factor_net: Optional[FactorNet],
    max_steps: int,
    record_trajectory: bool = True,
    deterministic_policy: bool = False,
):
    """Pad-to-max variant of :func:`make_fm_denoise_fn`: one function serves
    every step count in ``[1, max_steps]``.  Returned fn: ``(generator,
    noise, cond, ts, sig_t, sig_next, valid) -> (latents, Trajectory with
    valid)``, the ladder from :func:`padded_fm_ladder`."""
    del fm_config  # the ladder arrives as data
    loop = _make_fm_loop(velocity_fn, factor_net, record_trajectory, deterministic_policy)

    def denoise(generator, noise, cond, ts, sig_t, sig_next, valid):
        if len(ts) != max_steps:
            raise ValueError(f"ladder has {len(ts)} steps, program has {max_steps}")
        return loop(generator, noise, cond, *(np.asarray(a) for a in (ts, sig_t, sig_next, valid)),
                    padded=True)

    return denoise


class FmBaseline:
    """Training-free FM solvers: euler, heun (2-stage over sigma pairs),
    dpm-solver (2-stage) and dpm-solver-multistep, with Python-level
    state."""

    def __init__(
        self,
        fm_config: schedules.FlowMatchConfig,
        num_inference_steps: int,
        solver_type: str = "euler",
        mu: Optional[float] = None,
    ):
        if solver_type not in FM_SOLVERS:
            raise ValueError(f"Unknown FM solver {solver_type!r}; one of {FM_SOLVERS}")
        self.type = solver_type
        self.sigmas, self.timesteps = schedules.fm_sigmas(fm_config, num_inference_steps, mu=mu)
        self.reset()

    def reset(self):
        self.prev_dt = None
        self.prev_sample = None
        self.prev_model_output = None

    def step(self, i: int, x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        sig = self.sigmas
        x = x.float()
        if self.type == "euler":
            return x + float(sig[i + 1] - sig[i]) * v
        if self.type == "heun":
            # predictor jumps two sigmas; the next call averages the velocities
            if i % 2 == 0:
                nxt = sig[i + 2] if i + 2 < len(sig) else sig[-1]
                dt = float(nxt - sig[i])
                self.prev_dt, self.prev_sample, self.prev_model_output = dt, x, v
                return x + dt * v
            return self.prev_sample + 0.5 * self.prev_dt * (self.prev_model_output + v)
        if self.type == "dpm-solver":
            # predictor takes one sigma; the corrector re-integrates the
            # combined interval with the midpoint velocity
            if i % 2 == 0:
                dt = float(sig[i + 1] - sig[i])
                self.prev_dt, self.prev_sample, self.prev_model_output = dt, x, v
                return x + dt * v
            return self.prev_sample + (self.prev_dt + float(sig[i + 1] - sig[i])) * v
        if i == 0:  # dpm-solver-multistep
            dt = float(sig[i + 1] - sig[i])
            self.prev_dt, self.prev_sample = dt, x
            return x + dt * v
        out = self.prev_sample + (self.prev_dt + float(sig[i + 1] - sig[i])) * v
        self.prev_dt = float(sig[i + 1] - sig[i])
        self.prev_sample = x
        return out


def make_fm_baseline_denoise_fn(
    velocity_fn: VelocityFn,
    fm_config: schedules.FlowMatchConfig,
    solver_type: str,
    num_inference_steps: int,
    mu: Optional[float] = None,
):
    """Baseline FM denoise: ``(noise, cond) -> final latents``."""
    FmBaseline(fm_config, num_inference_steps, solver_type, mu=mu)  # validate early

    def denoise(noise, cond):
        s = FmBaseline(fm_config, num_inference_steps, solver_type, mu=mu)
        x = noise
        batch = x.shape[0]
        for i, t in enumerate(s.timesteps):
            with profiling.span("pipeline.step", i):
                t_in = torch.full((batch,), float(t), dtype=torch.float32, device=x.device)
                v = velocity_fn(x, t_in, cond).float()
                with profiling.span("pipeline.policy"):
                    x = s.step(i, x, v).to(noise.dtype)
        return x

    return denoise


class FlowMatchPipeline(Pipeline):
    """A pipeline whose denoiser is a velocity model under the FM solvers:
    the learnable ``fmppo`` or a baseline of :data:`FM_SOLVERS`.  A family
    supplies ``velocity()``, which builds its velocity model, and its ``mu``;
    it holds ``fm_config``, ``factor_net``, its 16-channel ``vae`` and that
    VAE's ``vae_scaling_factor`` and ``vae_shift_factor``."""

    LEARNABLE_SOLVER = "fmppo"

    def decode_latents(self, latents: torch.Tensor, chunk: Optional[int] = None) -> torch.Tensor:
        """Latents NHWC -> images in [0, 1]; ``chunk`` micro-batches the decode."""
        with profiling.span("pipeline.decode"):
            x = latents / self.vae_scaling_factor + self.vae_shift_factor
            img = chunked_apply(self.vae.decode, x, chunk)
            return (img / 2 + 0.5).clamp(0.0, 1.0)

    def _fm_program(self, key: Tuple, velocity: Callable[[], VelocityFn],
                    num_inference_steps: int, solver: str, record: bool,
                    deterministic_policy: bool, mu: Optional[float] = None):
        """The per-count program: ``(generator, noise, cond) -> (latents,
        Trajectory or None)``."""

        def baseline():
            base = make_fm_baseline_denoise_fn(velocity(), self.fm_config, solver,
                                               num_inference_steps, mu=mu)
            return lambda generator, noise, cond: base(noise, cond)  # draws no noise

        return self._program(
            (*key, num_inference_steps), solver, record, deterministic_policy,
            lambda det: make_fm_denoise_fn(velocity(), self.fm_config, self.factor_net,
                                           num_inference_steps, mu=mu, record_trajectory=record,
                                           deterministic_policy=det),
            baseline)

    def _fm_padded_program(self, key: Tuple, velocity: Callable[[], VelocityFn],
                           max_steps: int, record: bool, deterministic_policy: bool,
                           use_policy: bool = True):
        """The pad-to-max program of ``max_steps``, fed a
        :func:`padded_fm_ladder`; ``use_policy=False`` runs the same loop
        without the policy, the Euler baseline (order 1, coefficients [1])."""
        key = ("padded", *key, max_steps)

        def padded(net, det):
            return make_padded_fm_denoise_fn(velocity(), self.fm_config, net, max_steps,
                                             record_trajectory=record, deterministic_policy=det)

        if use_policy:
            return self._program(key, self.LEARNABLE_SOLVER, record, deterministic_policy,
                                 lambda det: padded(self.factor_net, det))
        return self._cached((*key, "euler", record, False), lambda: padded(None, False))
