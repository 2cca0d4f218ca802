"""Diffusion Preview sessions: cheap learnable-solver previews, full-step
refinement on acceptance.

Port of ``consolver_tpu/pipelines/preview.py``, the paper's product loop:
low-step previews with the ConsistencySolver; when the user accepts one, the
SAME initial noise runs through a full-step teacher solver, which the
learned solver was trained to predict.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from consolver_torch.pipelines.solver_zoo import make_baseline_denoise_fn
from consolver_torch.pipelines.t2i import TextToImagePipeline


@dataclasses.dataclass
class Preview:
    """One preview candidate: the decoded image and the noise it came from."""

    image: torch.Tensor  # [H, W, 3] in [0, 1]
    noise: torch.Tensor  # [h, w, c] initial latent noise
    prompt_ids: torch.Tensor
    num_steps: int


class PreviewSession:
    """Preview -> accept -> refine over a TextToImagePipeline whose solver is
    the trained ConsistencySolver."""

    def __init__(
        self,
        pipeline: TextToImagePipeline,
        preview_steps: int = 8,
        refine_steps: int = 40,
        refine_solver: str = "multistep-dpm",
        guidance_scale: float = 3.0,
    ):
        self.pipe = pipeline
        self.preview_steps = preview_steps
        self.refine_steps = refine_steps
        self.guidance_scale = guidance_scale
        self._refine = make_baseline_denoise_fn(
            pipeline.unet, pipeline.schedule, refine_solver, refine_steps, guidance_scale)

    def preview(
        self,
        generator: torch.Generator,
        prompt_ids,
        latent_hw: tuple = (64, 64),
        num_candidates: int = 4,
        noise: Optional[torch.Tensor] = None,
    ) -> List[Preview]:
        """``num_candidates`` cheap previews of one prompt.  The noise is
        drawn from ``generator`` (on the pipeline's device), which then
        drives the policy, unless ``noise`` ``[n, h, w, 4]`` is given."""
        device = self.pipe.device
        prompt_ids = torch.as_tensor(prompt_ids, device=device)
        if noise is None:
            h, w = latent_hw
            noise = torch.randn((num_candidates, h, w, self.pipe.unet.cfg.in_channels),
                                generator=generator, device=device)
        noise = torch.as_tensor(noise, device=device)
        ids = prompt_ids.reshape(1, -1).repeat(num_candidates, 1)
        images, _ = self.pipe(generator, ids, noise, num_inference_steps=self.preview_steps,
                              guidance_scale=self.guidance_scale, record=False)
        return [Preview(images[i], noise[i], prompt_ids, self.preview_steps)
                for i in range(num_candidates)]

    @torch.inference_mode()
    def refine(self, preview: Preview, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The full-step image from the accepted preview's exact noise
        (``generator`` only for a stochastic refine solver)."""
        ids = preview.prompt_ids.reshape(1, -1)
        context, uncond = self.pipe._encode(ids, self.pipe.uncond_ids_for(ids))
        latents = self._refine(generator, preview.noise[None], context, uncond)
        return self.pipe.decode_latents(latents)[0]
