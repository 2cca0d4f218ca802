"""FLUX-Kontext instructional image editing.

Port of ``consolver_tpu/pipelines/edit.py``: T5 + CLIP prompt encoding, VAE
encode of the reference image, 2x2 latent packing with RoPE ids (the
reference tokens carry ``ids[..., 0] = 1``, text ids are zeros), the
resolution-dependent mu shift, guidance embeds, then the flow-matching
denoise (the learnable FMPPO solver or an FM baseline) and the VAE decode.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from consolver_torch.core import schedules
from consolver_torch.dist.tp import FLUX_TP_RULES
from consolver_torch.kernels.quant import quantize_like
from consolver_torch.models import flux as flux_lib
from consolver_torch.models.vae import AutoencoderKL
from consolver_torch.pipelines import fm
from consolver_torch.policy.factor_net import FactorNet
from consolver_torch.utils import profiling


class FluxKontextPipeline(fm.FlowMatchPipeline):
    """The FLUX transformer, T5 and CLIP encoders, 16-channel VAE and the
    policy of one editing deployment, with cached denoise functions."""

    MODULES = ("transformer", "t5", "clip", "vae", "factor_net")
    TENSOR_PARALLEL = ("transformer", FLUX_TP_RULES)

    def __init__(
        self,
        transformer,
        t5,
        clip,
        vae,
        fm_config: Optional[schedules.FlowMatchConfig] = None,
        factor_net: Optional[FactorNet] = None,
        vae_scaling_factor: float = 0.3611,
        vae_shift_factor: float = 0.1159,
        device=None,
    ):
        super().__init__(device)
        self.transformer = transformer
        self.t5 = t5
        self.clip = clip
        self.vae = vae
        self.fm_config = fm_config or schedules.FlowMatchConfig.flux()
        self.factor_net = factor_net
        self.vae_scaling_factor = vae_scaling_factor
        self.vae_shift_factor = vae_shift_factor

    @property
    def latent_channels(self) -> int:
        return self.vae.cfg.latent_channels

    def encode_prompt(self, t5_ids, clip_ids):
        """(T5 joint embeddings, CLIP pooled embedding)."""
        with profiling.span("pipeline.text"):
            return self.t5(t5_ids), self.clip(clip_ids, return_pooled=True)[1]

    def encode_image(self, image: torch.Tensor) -> torch.Tensor:
        """Reference image ``[B, H, W, 3]`` in [-1, 1] -> the latent mean,
        shifted then scaled, NHWC."""
        with profiling.span("pipeline.vae_encode"):
            mean, _ = self.vae.encode(image)
            return (mean - self.vae_shift_factor) * self.vae_scaling_factor

    def quantize(self, bits: int = 8) -> "FluxKontextPipeline":
        """A quantized copy of this pipeline.  ``bits=8``: W8A8 int8 DiT
        stream-block projections and modulations and an int8 VAE decoder;
        ``bits=4``: packed 4-bit DiT weights computed in the DiT's dtype
        (W4A16, group-128 scales: the memory configuration), the VAE decoder
        still int8.  Quantized from this pipeline's weights one layer at a
        time; the encoders, FactorNet and FM settings are shared, the copy's
        denoise cache starts empty, and this pipeline is left as it was."""
        if bits not in (4, 8):
            raise ValueError(f"bits must be 4 or 8, got {bits}")
        cfg = self.transformer.cfg
        qcfg = (dataclasses.replace(cfg, quant_int4=True) if bits == 4
                else dataclasses.replace(cfg, quant_int8=True))
        vae_cfg = dataclasses.replace(self.vae.cfg, quant_int8=True)
        return self.replace(
            transformer=quantize_like(flux_lib.FluxTransformer(qcfg, device="meta"),
                                      self.transformer),
            vae=quantize_like(AutoencoderKL(vae_cfg, device="meta"), self.vae))

    def _ids(self, lh: int, lw: int, seq_txt: int):
        img_ids = torch.cat([
            flux_lib.latent_image_ids(lh, lw, device=self.device),
            flux_lib.latent_image_ids(lh, lw, offset=1.0, device=self.device),
        ], dim=0)
        return img_ids, torch.zeros((seq_txt, 3), device=self.device)

    def _velocity_fn(self, lh: int, lw: int, seq_txt: int, guidance_scale, true_cfg_scale=None):
        """The DiT as ``velocity(x, t, cond)`` at ``lh x lw`` latents and
        ``seq_txt`` text tokens: appends the reference tokens,
        runs the transformer and slices the target tokens back.  With
        ``true_cfg_scale`` the cond also carries negative-prompt embeddings
        and both branches run as one 2x batch:
        ``v = v_neg + s * (v_pos - v_neg)``."""
        seq_len_target = (lh // 2) * (lw // 2)
        img_ids, txt_ids = self._ids(lh, lw, seq_txt)

        def velocity(x, t, cond):
            if true_cfg_scale is None:
                prompt_embeds, pooled, ref_tokens = cond
                tokens = torch.cat([x, ref_tokens], dim=1)
                guidance = torch.full((x.shape[0],), guidance_scale, dtype=torch.float32,
                                      device=x.device)
                with profiling.span("model.dit", tokens.shape[0]):
                    v = self.transformer(tokens, prompt_embeds, pooled, t, guidance, img_ids,
                                         txt_ids)
                return v[:, :seq_len_target]
            pe, pooled, neg_pe, neg_pooled, ref_tokens = cond
            tokens = torch.cat([x, ref_tokens], dim=1)
            tokens2 = torch.cat([tokens, tokens], dim=0)
            guidance = torch.full((tokens2.shape[0],), guidance_scale, dtype=torch.float32,
                                  device=x.device)
            with profiling.span("model.dit", tokens2.shape[0]):
                v = self.transformer(tokens2, torch.cat([pe, neg_pe], dim=0),
                                     torch.cat([pooled, neg_pooled], dim=0),
                                     torch.cat([t, t], dim=0),
                                     guidance, img_ids, txt_ids)[:, :seq_len_target]
            v_pos, v_neg = v.chunk(2, dim=0)
            return v_neg + true_cfg_scale * (v_pos - v_neg)

        return velocity

    def mu_for(self, lh: int, lw: int) -> float:
        """Resolution-dependent FM shift."""
        c = self.fm_config
        return schedules.calculate_flux_mu((lh // 2) * (lw // 2), c.base_image_seq_len,
                                           c.max_image_seq_len, c.base_shift, c.max_shift)

    def denoise_fn(
        self,
        lh: int,
        lw: int,
        seq_txt: int,
        num_inference_steps: int,
        guidance_scale: float,
        solver: str = "fmppo",
        record: bool = True,
        true_cfg_scale: Optional[float] = None,
        deterministic_policy: bool = False,
    ):
        """The denoise function of one (latent size, steps, solver) program:
        ``(generator, noise, cond) -> (latents, Trajectory or None)``."""
        return self._fm_program(
            (lh, lw, seq_txt, guidance_scale, true_cfg_scale),
            functools.partial(self._velocity_fn, lh, lw, seq_txt, guidance_scale, true_cfg_scale),
            num_inference_steps, solver, record, deterministic_policy, mu=self.mu_for(lh, lw))

    def padded_denoise_fn(
        self,
        lh: int,
        lw: int,
        seq_txt: int,
        max_steps: int,
        guidance_scale: float,
        record: bool = True,
        true_cfg_scale: Optional[float] = None,
        deterministic_policy: bool = False,
        use_policy: bool = True,
    ):
        """One function for every step count in ``[1, max_steps]``, fed a
        :func:`fm.padded_fm_ladder`; ``use_policy=False`` is the Euler
        baseline (order 1, coefficients [1])."""
        return self._fm_padded_program(
            (lh, lw, seq_txt, guidance_scale, true_cfg_scale),
            functools.partial(self._velocity_fn, lh, lw, seq_txt, guidance_scale, true_cfg_scale),
            max_steps, record, deterministic_policy, use_policy)

    def __call__(self, *args, **kwargs):
        """Serving: :meth:`rollout` under ``torch.inference_mode()``."""
        with torch.inference_mode():
            return self.rollout(*args, **kwargs)

    def rollout(
        self,
        generator: Optional[torch.Generator],
        t5_ids,
        clip_ids,
        ref_image,
        noise,
        num_inference_steps: int = 5,
        guidance_scale: float = 2.5,
        solver: str = "fmppo",
        decode: bool = True,
        neg_t5_ids=None,
        neg_clip_ids=None,
        true_cfg_scale: float = 1.0,
        deterministic_policy: bool = False,
        record: bool = True,
        padded_max_steps: Optional[int] = None,
    ):
        """ref_image ``[B, H, W, 3]`` in [-1, 1]; noise ``[B, h, w, 16]``.
        Runs in the caller's grad mode: a trainer calls it under
        ``torch.no_grad()``, so the trajectory's tensors are normal ones that
        the FactorNet's backward may save (inference-mode tensors may not be).
        Returns (edited images in [0, 1], or the final latents when
        ``decode=False``; the trajectory, or None when ``record=False`` or
        for a baseline solver).

        ``padded_max_steps`` routes through the pad-to-max program (fmppo
        and euler only).  Negative-prompt ids with ``true_cfg_scale > 1``
        turn on the true-CFG double forward."""
        t5_ids, clip_ids, ref_image, noise = (
            profiling.to_device(a, self.device) for a in (t5_ids, clip_ids, ref_image, noise))
        _, lh, lw, _ = noise.shape
        prompt_embeds, pooled = self.encode_prompt(t5_ids, clip_ids)
        ref_tokens = flux_lib.pack_latents(self.encode_image(ref_image))
        packed_noise = flux_lib.pack_latents(noise)

        do_true_cfg = neg_t5_ids is not None and true_cfg_scale > 1.0
        cfg_scale = true_cfg_scale if do_true_cfg else None
        if do_true_cfg:
            if neg_clip_ids is None:
                # T5 ids are not CLIP ids (another tokenizer and vocabulary)
                raise ValueError("true-CFG needs neg_clip_ids alongside neg_t5_ids "
                                 "(tokenize the negative prompt with both tokenizers)")
            neg_embeds, neg_pooled = self.encode_prompt(
                profiling.to_device(neg_t5_ids, self.device),
                profiling.to_device(neg_clip_ids, self.device))
            cond = (prompt_embeds, pooled, neg_embeds, neg_pooled, ref_tokens)
        else:
            cond = (prompt_embeds, pooled, ref_tokens)

        seq_txt = int(t5_ids.shape[1])
        if padded_max_steps is not None:
            if not (self.is_learnable(solver) or solver == "euler"):
                raise ValueError("padded_max_steps supports the learnable fmppo program "
                                 "and the degenerate euler baseline")
            denoise = self.padded_denoise_fn(
                lh, lw, seq_txt, padded_max_steps, guidance_scale, record=record,
                true_cfg_scale=cfg_scale, deterministic_policy=deterministic_policy,
                use_policy=self.is_learnable(solver),
            )
            ladder = fm.padded_fm_ladder(self.fm_config, num_inference_steps, padded_max_steps,
                                         mu=self.mu_for(lh, lw))
            packed_out, traj = denoise(generator, packed_noise, cond, *ladder)
        else:
            denoise = self.denoise_fn(
                lh, lw, seq_txt, num_inference_steps, guidance_scale, solver, record=record,
                true_cfg_scale=cfg_scale, deterministic_policy=deterministic_policy,
            )
            packed_out, traj = denoise(generator, packed_noise, cond)
        latents = flux_lib.unpack_latents(packed_out, lh, lw)
        if not decode:
            return latents, traj
        return self.decode_latents(latents), traj
