"""Text-to-image denoise pipeline: an eager per-step loop.

Port of ``consolver_tpu/pipelines/t2i.py`` (the learnable-solver path).  Each
step runs a CFG-batched UNet forward, pushes the new epsilon into the solver
history, lets the FactorNet pick an action from that history, combines the
history and applies the DDIM x0-form update; the RL trajectory (conds,
actions, probs, masks) is recorded per step and step 0 is dropped, as in the
JAX package's scan.  The plain-DDIM baseline is ``factor_net=None``
(``order_dim=1``, passthrough combine); the baseline solver zoo runs
through ``pipelines/solver_zoo.py``.

A deterministic program (``deterministic_policy=True``) calls the UNet with
``slot_invariant=True``, so that a request's bits do not depend on its batch
slot; sampled programs keep the batched convolutions.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from consolver_torch.core import schedules, solver
from consolver_torch.data.tokenizer import HashTokenizer, tokenize_batch
from consolver_torch.dist.tp import UNET_TP_RULES
from consolver_torch.kernels.quant import quantize_like
from consolver_torch.models.unet_2d import UNet2DCondition
from consolver_torch.models.vae import AutoencoderKL
from consolver_torch.models.vae import decode_latents as _decode_latents
from consolver_torch.pipelines import solver_zoo
from consolver_torch.pipelines.base import Pipeline
from consolver_torch.policy.factor_net import FactorNet
from consolver_torch.utils import profiling

UNetApply = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Trajectory:
    """Per-step PPO records shaped ``[B, steps-1, ...]`` (step 0 dropped).
    ``valid`` marks real (non-pad) rows of a padded rollout."""

    conds_x: torch.Tensor  # [B, S-1, 2]
    actions: torch.Tensor  # [B, S-1, A]
    probs: torch.Tensor  # [B, S-1, A]
    masks: torch.Tensor  # [B, S-1, A]
    conds_eps: Optional[torch.Tensor] = None  # [B, S-1, order_dim, ...] if use_conv
    valid: Optional[torch.Tensor] = None  # [B, S-1]


def _solver_dims(factor_net: Optional[FactorNet]) -> Tuple[int, int, int]:
    if factor_net is None:
        return 1, 0, 1  # degenerate DDIM solver: passthrough, no actions
    cfg = factor_net.config
    return cfg.order_dim, cfg.scaler_dim, cfg.action_dims


def _make_loop(
    unet_apply: UNetApply,
    schedule: schedules.DiffusionSchedule,
    factor_net: Optional[FactorNet],
    guidance_scale: float,
    record_trajectory: bool,
    deterministic_policy: bool,
):
    """The step loop shared by the per-count and padded programs: runs over a
    host ladder ``(ts, prev_ts, valid)``; a step with ``valid == 0`` runs the
    UNet and policy but leaves latents and history unchanged."""
    order_dim, scaler_dim, action_dims = _solver_dims(factor_net)
    do_cfg = guidance_scale > 1.0
    use_conv = factor_net is not None and factor_net.config.use_conv

    def step(generator, t, t_prev, v, latents, st, full_context, alphas, padded):
        """One step: the UNet (``model.unet``), then the policy and the
        solver update (``pipeline.policy``); returns (latents, state,
        the step's record)."""
        device = latents.device
        batch = latents.shape[0]
        if do_cfg:
            t_in = torch.full((2 * batch,), t, dtype=torch.int64, device=device)
            with profiling.span("model.unet", 2 * batch):
                eps_all = unet_apply(torch.cat([latents, latents], dim=0), t_in, full_context)
            eps_uncond, eps_text = eps_all.chunk(2, dim=0)
            eps = eps_uncond + guidance_scale * (eps_text - eps_uncond)
        else:
            t_in = torch.full((batch,), t, dtype=torch.int64, device=device)
            with profiling.span("model.unet", batch):
                eps = unet_apply(latents, t_in, full_context)
        eps = eps.float()

        with profiling.span("pipeline.policy"):
            conds_x = profiling.to_device([t, t_prev], device, torch.float32)
            conds_x = conds_x[None].expand(batch, 2)
            # The history is pushed before the policy reads it.
            st_new = solver.push(st, eps)
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
            effective, scaled_sample = solver.apply_scalers(effective, latents, scale_actions.float())
            masks = solver.warmup_masks(st_new.num_ets, order_dim, action_dims, batch, device) * v

            a_t, a_prev = solver.gather_alpha_prods(alphas, t, t_prev, schedule.final_alpha_cumprod)
            if v > 0:
                latents = solver.ddim_update(
                    scaled_sample, effective, a_t, a_prev, schedule.prediction_type
                )
                st = st_new
        record = None
        if record_trajectory:
            record = {"conds_x": conds_x, "actions": actions, "probs": probs, "masks": masks}
            if padded:
                record["valid"] = torch.full((batch,), float(v), device=device)
            if use_conv:  # the history after the step (unchanged on a pad step)
                record["conds_eps"] = st.ets
        return latents, st, record

    def loop(generator, noise, context, uncond_context, ts, prev_ts, valid, padded):
        device = noise.device
        batch = noise.shape[0]
        alphas = profiling.to_device(schedule.alphas_cumprod, device)
        full_context = torch.cat([uncond_context, context], dim=0) if do_cfg else context
        st = solver.init_state(batch, order_dim, tuple(noise.shape[1:]), device=device)
        latents = noise.float()
        records = []
        for i, (t, t_prev, v) in enumerate(zip(ts.tolist(), prev_ts.tolist(), valid.tolist())):
            with profiling.span("pipeline.step", i):
                latents, st, record = step(generator, t, t_prev, v, latents, st, full_context,
                                           alphas, padded)
            if record is not None:
                records.append(record)

        if not record_trajectory:
            return latents, None
        # [S][B, ...] -> [B, S-1, ...], dropping step 0
        stacked = {name: torch.stack([r[name] for r in records], dim=1)[:, 1:] for name in records[0]}
        return latents, Trajectory(**stacked)

    return loop


def make_denoise_fn(
    unet_apply: UNetApply,
    schedule: schedules.DiffusionSchedule,
    factor_net: Optional[FactorNet],
    num_inference_steps: int,
    guidance_scale: float = 3.0,
    timestep_spacing: str = "trailing",
    steps_offset: int = 1,
    record_trajectory: bool = True,
    deterministic_policy: bool = False,
):
    """Build the denoise function.

    ``unet_apply``: (latents NHWC, timesteps [B], context) -> epsilon.
    Returned fn: (generator, noise, context, uncond_context) -> (final
    latents, Trajectory or None).  CFG runs as one 2B-batched UNet call in
    ``[uncond, text]`` order; with ``guidance_scale <= 1`` the uncond branch
    is skipped.  ``deterministic_policy=True`` takes the mode action.
    """
    ts = schedules.spaced_timesteps(
        schedule.num_train_timesteps, num_inference_steps, timestep_spacing, steps_offset
    )
    prev_ts = ts - schedule.num_train_timesteps // num_inference_steps
    valid = np.ones(len(ts), np.float32)
    loop = _make_loop(unet_apply, schedule, factor_net, guidance_scale,
                      record_trajectory, deterministic_policy)

    def denoise(generator, noise, context, uncond_context):
        return loop(generator, noise, context, uncond_context, ts, prev_ts, valid, padded=False)

    return denoise


def padded_ladder(
    schedule: schedules.DiffusionSchedule,
    num_inference_steps: int,
    max_steps: int,
    timestep_spacing: str = "trailing",
    steps_offset: int = 1,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The ``num_inference_steps`` ladder front-loaded into ``[max_steps]``
    host arrays with a validity mask (pad steps repeat the last entry)."""
    if not 1 <= num_inference_steps <= max_steps:
        raise ValueError(f"need 1 <= num_inference_steps ({num_inference_steps}) <= {max_steps}")
    ts = schedules.spaced_timesteps(
        schedule.num_train_timesteps, num_inference_steps, timestep_spacing, steps_offset
    )
    prev_ts = ts - schedule.num_train_timesteps // num_inference_steps
    pad = max_steps - num_inference_steps
    ts_p = np.concatenate([ts, np.repeat(ts[-1:], pad)]).astype(np.int32)
    prev_p = np.concatenate([prev_ts, np.repeat(prev_ts[-1:], pad)]).astype(np.int32)
    valid = np.concatenate([np.ones(num_inference_steps), np.zeros(pad)]).astype(np.float32)
    return ts_p, prev_p, valid


def make_padded_denoise_fn(
    unet_apply: UNetApply,
    schedule: schedules.DiffusionSchedule,
    factor_net: Optional[FactorNet],
    max_steps: int,
    guidance_scale: float = 3.0,
    record_trajectory: bool = True,
    deterministic_policy: bool = False,
):
    """Pad-to-max variant of :func:`make_denoise_fn`: one function serves
    every step count in ``[1, max_steps]``.  Pad steps run the UNet but pass
    latents and history through, and their trajectory masks are zero.

    Returned fn: (generator, noise, context, uncond_context, ts[M],
    prev_ts[M], valid[M]) -> (latents, Trajectory with ``valid``)."""
    loop = _make_loop(unet_apply, schedule, factor_net, guidance_scale,
                      record_trajectory, deterministic_policy)

    def denoise(generator, noise, context, uncond_context, ts, prev_ts, valid):
        if len(ts) != max_steps:
            raise ValueError(f"ladder has {len(ts)} steps, program has {max_steps}")
        return loop(generator, noise, context, uncond_context,
                    np.asarray(ts), np.asarray(prev_ts), np.asarray(valid), padded=True)

    return denoise


class TextToImagePipeline(Pipeline):
    """The models, schedule and policy of one text-to-image deployment, with
    cached denoise functions per (steps, cfg, solver) program."""

    MODULES = ("unet", "text_encoder", "vae", "factor_net")
    LEARNABLE_SOLVER = "consistencysolver"
    TENSOR_PARALLEL = ("unet", UNET_TP_RULES)

    def __init__(
        self,
        unet,
        text_encoder,
        vae,
        schedule: schedules.DiffusionSchedule,
        factor_net: Optional[FactorNet] = None,
        timestep_spacing: str = "trailing",
        steps_offset: int = 1,
        tokenizer=None,
        device=None,
    ):
        super().__init__(device)
        self.unet = unet
        self.text_encoder = text_encoder
        self.vae = vae
        self.schedule = schedule
        self.factor_net = factor_net
        self.timestep_spacing = timestep_spacing
        self.steps_offset = steps_offset
        self.tokenizer = tokenizer

    @property
    def latent_channels(self) -> int:
        return self.unet.cfg.in_channels

    def tokenize(self, prompts: Sequence[str], max_length: Optional[int] = None) -> np.ndarray:
        """``[B, max_length]`` int64 ids from the attached tokenizer (else a
        hashing one); ``max_length`` defaults to the text encoder's context."""
        n = int(max_length or self.text_encoder.cfg.max_position_embeddings)
        tok = self.tokenizer or HashTokenizer(max_length=n)
        return tokenize_batch(tok, prompts, n, vocab_size=self.text_encoder.cfg.vocab_size)

    def _encode(self, prompt_ids, uncond_ids):
        """(context, uncond_context) of the prompt and the empty prompt."""
        with profiling.span("pipeline.text"):
            return self.text_encoder(prompt_ids), self.text_encoder(uncond_ids)

    def decode_latents(self, latents: torch.Tensor, chunk: Optional[int] = None) -> torch.Tensor:
        """Scaled latents -> [0, 1] images."""
        with profiling.span("pipeline.decode"):
            return _decode_latents(self.vae, latents, chunk=chunk)

    def uncond_ids_for(self, prompt_ids) -> torch.Tensor:
        """The empty prompt's ids for CFG, from the attached tokenizer (else
        the HashTokenizer's ``[BOS, EOS, pad...]``) - not all-zero ids."""
        ids = self.tokenize([""], int(prompt_ids.shape[1]))
        return profiling.to_device(np.tile(ids, (int(prompt_ids.shape[0]), 1)), self.device)

    def quantize(self, skip_levels: Tuple[int, ...] = (0,)) -> "TextToImagePipeline":
        """A W8A8 int8 copy of this pipeline for serving and rollouts: the
        UNet's projections at every level but ``skip_levels`` and the VAE
        decoder run on the int8 layers (``kernels/quant.py``), quantized
        from this pipeline's weights one layer at a time.  The text encoder,
        FactorNet, tokenizer, schedule and timestep settings are shared; the
        copy starts with an empty denoise cache (the cached functions hold
        their models), and this pipeline is left as it was.  The default
        keeps UNet level 0 float (the JAX package's hybrid); ``()`` is
        uniform int8."""
        unet_cfg = dataclasses.replace(self.unet.cfg, quant_int8=True,
                                       quant_skip_levels=tuple(skip_levels))
        vae_cfg = dataclasses.replace(self.vae.cfg, quant_int8=True)
        return self.replace(
            unet=quantize_like(UNet2DCondition(unet_cfg, device="meta"), self.unet),
            vae=quantize_like(AutoencoderKL(vae_cfg, device="meta"), self.vae))

    def _unet_apply(self, deterministic_policy: bool) -> UNetApply:
        """The UNet as the step loop calls it: slot-invariant for the
        deterministic programs."""
        if deterministic_policy:
            return functools.partial(self.unet, slot_invariant=True)
        return self.unet

    def denoise_fn(
        self,
        num_inference_steps: int,
        guidance_scale: float,
        record: bool = True,
        solver: str = "consistencysolver",
        deterministic_policy: bool = False,
    ):
        """``solver='consistencysolver'`` is the learnable LMM (plain DDIM
        without a factor net); any other name is a baseline zoo solver
        (:data:`solver_zoo.SOLVERS`), whose function returns ``(latents,
        None)`` and draws any per-step noise from the generator."""
        return self._program(
            (num_inference_steps, float(guidance_scale)), solver, record, deterministic_policy,
            lambda det: make_denoise_fn(
                self._unet_apply(det), self.schedule, self.factor_net, num_inference_steps,
                guidance_scale, self.timestep_spacing, self.steps_offset,
                record_trajectory=record, deterministic_policy=det),
            lambda: solver_zoo.make_baseline_denoise_fn(
                self.unet, self.schedule, solver, num_inference_steps, guidance_scale))

    def padded_denoise_fn(
        self,
        max_steps: int,
        guidance_scale: float,
        record: bool = True,
        deterministic_policy: bool = False,
    ):
        """The learnable solver's pad-to-max program of ``max_steps``, fed a
        :func:`padded_ladder`."""
        return self._program(
            ("padded", max_steps, float(guidance_scale)), self.LEARNABLE_SOLVER, record,
            deterministic_policy,
            lambda det: make_padded_denoise_fn(
                self._unet_apply(det), self.schedule, self.factor_net, max_steps, guidance_scale,
                record_trajectory=record, deterministic_policy=det))

    @torch.inference_mode()
    def __call__(
        self,
        generator: Optional[torch.Generator],
        prompt_ids,
        noise,
        num_inference_steps: int = 8,
        guidance_scale: float = 3.0,
        uncond_ids=None,
        decode: bool = True,
        solver: str = "consistencysolver",
        deterministic_policy: bool = False,
        padded_max_steps: Optional[int] = None,
        record: bool = True,
    ):
        """Returns (images NHWC in [0, 1], or the final latents when
        ``decode=False``; the trajectory, or None when ``record=False``).

        ``generator`` drives the policy's sampling and a stochastic zoo
        solver's noise (it must live on the pipeline's device);
        ``padded_max_steps`` routes through the
        pad-to-max program."""
        prompt_ids = profiling.to_device(prompt_ids, self.device)
        noise = profiling.to_device(noise, self.device)
        if uncond_ids is None:
            uncond_ids = self.uncond_ids_for(prompt_ids)
        uncond_ids = profiling.to_device(uncond_ids, self.device)
        context, uncond_context = self._encode(prompt_ids, uncond_ids)
        if padded_max_steps is not None:
            if not self.is_learnable(solver):
                raise ValueError(f"padded_max_steps supports only the learnable "
                                 f"{self.LEARNABLE_SOLVER} program")
            denoise = self.padded_denoise_fn(
                padded_max_steps, guidance_scale, record=record,
                deterministic_policy=deterministic_policy,
            )
            ladder = padded_ladder(
                self.schedule, num_inference_steps, padded_max_steps,
                self.timestep_spacing, self.steps_offset,
            )
            latents, traj = denoise(generator, noise, context, uncond_context, *ladder)
        else:
            denoise = self.denoise_fn(
                num_inference_steps, guidance_scale, solver=solver, record=record,
                deterministic_policy=deterministic_policy,
            )
            latents, traj = denoise(generator, noise, context, uncond_context)
        if not decode:
            return latents, traj
        return self.decode_latents(latents), traj
