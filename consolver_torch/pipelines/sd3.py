"""Stable Diffusion 3 text-to-image: three text towers, the MMDiT, the
flow-matching solvers and the 16-channel VAE.

A family of its own beside ``t2i.py``: its conditioning (three encoders, a
sequence context and a pooled vector) and its step loop (flow matching, the
FMPPO solver of ``fm.py`` that the FLUX edit pipeline runs) share nothing
with the SD-1.5 UNet's DDIM loop.  As diffusers' ``StableDiffusion3Pipeline``:

  * the prompt and the empty negative prompt go through CLIP-L and
    OpenCLIP bigG (77 tokens each) and T5-XXL; the context is the two CLIP
    towers' penultimate states concatenated on channels (768 + 1280),
    zero-padded to T5's width, then T5's states after them on the sequence
    (77 + 256 = 333 tokens); the pooled vector is the two towers' projected
    EOS states concatenated (768 + 1280 = 2048);
  * the ladder is ``FlowMatchEulerDiscreteScheduler(shift=3.0)``: a linspace
    from sigma 1 to the shifted training table's smallest sigma, shifted
    again, then a trailing 0 (:func:`consolver_torch.core.schedules.fm_sigmas`);
  * classifier-free guidance runs as one 2-row MMDiT call a step in
    ``[negative, prompt]`` order, ``v = v_u + s (v_c - v_u)``;
  * the decode is ``latents / scaling_factor + shift_factor`` through the VAE.

Spans: ``pipeline.text`` around the three towers (``text.clip_l``,
``text.clip_g``, ``text.t5``), ``model.mmdit#<rows>`` around each MMDiT
call, ``fm.py``'s ``pipeline.step`` / ``pipeline.policy``, and
``pipeline.decode``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from consolver_torch.core import schedules
from consolver_torch.data.tokenizer import HashTokenizer, tokenize_batch
from consolver_torch.kernels.quant import quantize_like
from consolver_torch.models.mmdit import SD3Transformer
from consolver_torch.models.vae import AutoencoderKL
from consolver_torch.pipelines import fm
from consolver_torch.policy.factor_net import FactorNet
from consolver_torch.utils import profiling

CLIP_MAX_LENGTH = 77
# (clip_l ids, clip_g ids, t5 ids), each [B, S] int64
PromptIds = Tuple[np.ndarray, np.ndarray, np.ndarray]


def sd3_fm_config() -> schedules.FlowMatchConfig:
    """``scheduler/scheduler_config.json`` of SD3.5 Large: static shift 3.0."""
    return schedules.FlowMatchConfig(shift=3.0)


class SD3Pipeline(fm.FlowMatchPipeline):
    """The MMDiT, CLIP-L, bigG, T5 and VAE of one SD3 deployment, its
    FactorNet (the FM family's) and tokenizers, with cached denoise
    functions per (steps, guidance, solver) program.  ``tokenizers``: the
    CLIP-L, bigG and T5 tokenizers (real ones, else hashing ones).  No
    tensor-parallel rule: it serves on one card per engine (an MMDiT step is
    some 60 TFLOP against about 1,200 launches)."""

    MODULES = ("transformer", "clip_l", "clip_g", "t5", "vae", "factor_net")

    def __init__(
        self,
        transformer: SD3Transformer,
        clip_l,
        clip_g,
        t5,
        vae: AutoencoderKL,
        fm_config: Optional[schedules.FlowMatchConfig] = None,
        factor_net: Optional[FactorNet] = None,
        vae_scaling_factor: float = 1.5305,
        vae_shift_factor: float = 0.0609,
        t5_max_length: int = 256,
        tokenizers: Optional[Sequence] = None,
        device=None,
    ):
        super().__init__(device)
        self.transformer = transformer
        self.clip_l = clip_l
        self.clip_g = clip_g
        self.t5 = t5
        self.vae = vae
        self.fm_config = fm_config or sd3_fm_config()
        self.factor_net = factor_net
        self.vae_scaling_factor = vae_scaling_factor
        self.vae_shift_factor = vae_shift_factor
        self.t5_max_length = int(t5_max_length)
        # the hashing tokenizers hash CLIP words into CLIP's vocabulary and T5
        # words into T5's; tokenize() wraps ids into a smaller encoder's table
        self.tokenizers = tuple(tokenizers) if tokenizers is not None else (
            HashTokenizer(max_length=CLIP_MAX_LENGTH), HashTokenizer(max_length=CLIP_MAX_LENGTH),
            HashTokenizer(vocab_size=t5.cfg.vocab_size, max_length=self.t5_max_length))

    @property
    def latent_channels(self) -> int:
        return self.transformer.cfg.in_channels

    # ------------------------------------------------------------ prompts
    def tokenize(self, prompts: Sequence[str], max_length: Optional[int] = None) -> PromptIds:
        """The prompts' ids for the three towers; ``max_length``: T5's
        (default ``t5_max_length``)."""
        lengths = (CLIP_MAX_LENGTH, CLIP_MAX_LENGTH, max_length or self.t5_max_length)
        encoders = (self.clip_l, self.clip_g, self.t5)
        return tuple(tokenize_batch(tok, prompts, n, vocab_size=enc.cfg.vocab_size)
                     for tok, n, enc in zip(self.tokenizers, lengths, encoders))

    def encode_prompt(self, ids: PromptIds):
        """(context ``[B, 77 + S_t5, joint_dim]``, pooled ``[B, 2048]``), f32;
        one call of each tower over the ids' rows."""
        clip_l_ids, clip_g_ids, t5_ids = (profiling.to_device(i, self.device) for i in ids)
        with profiling.span("pipeline.text"):
            with profiling.span("text.clip_l"):
                hidden_l, pooled_l = self.clip_l(clip_l_ids, return_pooled=True, penultimate=True)
            with profiling.span("text.clip_g"):
                hidden_g, pooled_g = self.clip_g(clip_g_ids, return_pooled=True, penultimate=True)
            with profiling.span("text.t5"):
                t5_states = self.t5(t5_ids).float()
            clip = torch.cat([hidden_l.float(), hidden_g.float()], dim=-1)
            clip = F.pad(clip, (0, t5_states.shape[-1] - clip.shape[-1]))
            return torch.cat([clip, t5_states], dim=1), torch.cat([pooled_l, pooled_g], dim=-1)

    def quantize(self) -> "SD3Pipeline":
        """A W8A8 int8 copy: the MMDiT blocks' projections and modulations
        (the shared ``make_dense``) and the VAE decoder, quantized from this
        pipeline's weights one layer at a time.  Encoders, FactorNet,
        tokenizers and the ladder are shared; the copy's denoise cache starts
        empty, and this pipeline is left as it was."""
        qcfg = dataclasses.replace(self.transformer.cfg, quant_int8=True)
        vae_cfg = dataclasses.replace(self.vae.cfg, quant_int8=True)
        return self.replace(
            transformer=quantize_like(SD3Transformer(qcfg, device="meta"), self.transformer),
            vae=quantize_like(AutoencoderKL(vae_cfg, device="meta"), self.vae))

    # ------------------------------------------------------------ denoise
    def _velocity_fn(self, guidance_scale: float):
        """The MMDiT as ``velocity(x, t, cond)``; ``cond`` = (context,
        pooled), with the negative prompt's rows first under CFG."""
        do_cfg = guidance_scale > 1.0

        def velocity(x, t, cond):
            context, pooled = cond  # [2B, ...] under CFG, negative rows first
            if not do_cfg:
                with profiling.span("model.mmdit", x.shape[0]):
                    return self.transformer(x, context, pooled, t)
            with profiling.span("model.mmdit", 2 * x.shape[0]):
                v = self.transformer(torch.cat([x, x]), context, pooled, torch.cat([t, t]))
            v_u, v_c = v.chunk(2)
            return v_u + guidance_scale * (v_c - v_u)

        return velocity

    def denoise_fn(self, num_inference_steps: int, guidance_scale: float, solver: str = "fmppo",
                   record: bool = True, deterministic_policy: bool = False):
        """``(generator, noise, cond) -> (latents, Trajectory or None)``:
        ``fmppo`` is the learnable solver, any name of :data:`fm.FM_SOLVERS`
        a training-free baseline (``None`` trajectory)."""
        return self._fm_program((float(guidance_scale),),
                                functools.partial(self._velocity_fn, guidance_scale),
                                num_inference_steps, solver, record, deterministic_policy)

    def padded_denoise_fn(self, max_steps: int, guidance_scale: float, record: bool = True,
                          deterministic_policy: bool = False):
        """One fmppo function for every step count in ``[1, max_steps]``, fed
        a :func:`fm.padded_fm_ladder`."""
        return self._fm_padded_program((float(guidance_scale),),
                                       functools.partial(self._velocity_fn, guidance_scale),
                                       max_steps, record, deterministic_policy)

    def uncond_ids_for(self, batch_size: int, max_length: Optional[int] = None) -> PromptIds:
        """The empty negative prompt's ids, tiled to the batch (``max_length``:
        T5's, as in :meth:`tokenize`)."""
        return tuple(np.tile(ids, (batch_size, 1)) for ids in self.tokenize([""], max_length))

    @torch.inference_mode()
    def __call__(
        self,
        generator: Optional[torch.Generator],
        prompt_ids: PromptIds,
        noise,
        num_inference_steps: int = 8,
        guidance_scale: float = 3.5,
        decode: bool = True,
        solver: str = "fmppo",
        deterministic_policy: bool = False,
        padded_max_steps: Optional[int] = None,
        record: bool = True,
    ):
        """``prompt_ids``: host arrays (:meth:`tokenize`);
        noise NHWC ``[B, h, w, 16]``.  Returns (images NHWC in [0, 1], or
        the final latents when ``decode=False``; the trajectory, or None when
        ``record=False`` or for a baseline solver).  ``generator`` drives
        the policy's sampling (on the pipeline's device);
        ``padded_max_steps`` routes fmppo through the pad-to-max program.
        Under CFG the empty negative prompt's rows and the prompt's go
        through each tower in one call."""
        noise = profiling.to_device(noise, self.device)
        batch = int(noise.shape[0])
        if guidance_scale > 1.0:
            uncond = self.uncond_ids_for(batch, int(prompt_ids[2].shape[1]))
            prompt_ids = tuple(torch.cat([torch.as_tensor(n), torch.as_tensor(p)])
                               for n, p in zip(uncond, prompt_ids))
        cond = self.encode_prompt(prompt_ids)
        if padded_max_steps is not None:
            if not self.is_learnable(solver):
                raise ValueError(f"padded_max_steps supports only the learnable "
                                 f"{self.LEARNABLE_SOLVER} program")
            denoise = self.padded_denoise_fn(padded_max_steps, guidance_scale, record=record,
                                             deterministic_policy=deterministic_policy)
            ladder = fm.padded_fm_ladder(self.fm_config, num_inference_steps, padded_max_steps)
            latents, traj = denoise(generator, noise, cond, *ladder)
        else:
            denoise = self.denoise_fn(num_inference_steps, guidance_scale, solver, record=record,
                                      deterministic_policy=deterministic_policy)
            latents, traj = denoise(generator, noise, cond)
        if not decode:
            return latents, traj
        return self.decode_latents(latents), traj
