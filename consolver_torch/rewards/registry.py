"""Reward registry: one dispatch over the reward types.

Port of ``consolver_tpu/rewards/registry.py``.  Types: depth | inception |
segmentation | image_psnr | clip | dino | llava | qwen_vl.  The backbone
rewards take a caller-supplied ``encode`` (or depth / segment) callable;
the VLM judges are host callables that get numpy arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from consolver_torch.rewards import metrics

REWARD_TYPES = (
    "depth",
    "inception",
    "segmentation",
    "image_psnr",
    "clip",
    "dino",
    "llava",
    "qwen_vl",
)


@dataclasses.dataclass
class RewardModel:
    """The callables behind a reward type.

    encode: images [B,H,W,C] in [0,1] -> features [B,D]   (dino/clip/inception)
    depth:  images -> depth maps [B,H,W]                   (depth)
    segment: images -> int class masks [B,H,W]             (segmentation)
    vlm_judge: host fn (pred_np, target_np) -> scores [B]  (llava/qwen_vl)
    """

    encode: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    depth: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    segment: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    vlm_judge: Optional[Callable] = None


def build_encoder_for(reward_type: str, params) -> Callable:
    """The production feature encoder of a backbone-cosine reward type."""
    raise NotImplementedError(
        f"the {reward_type!r} feature encoder needs the ViT / Inception backbones, "
        "which are not ported yet (ROADMAP Queue A.12)"
    )


def make_reward_fn(
    reward_type: str, model: Optional[RewardModel] = None
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Returns ``(pred_images, target_images) -> [B]`` rewards."""
    if reward_type not in REWARD_TYPES:
        raise ValueError(f"Unknown reward type {reward_type!r}; one of {REWARD_TYPES}")
    model = model or RewardModel()

    if reward_type == "image_psnr":
        return metrics.image_psnr_reward

    if reward_type in ("dino", "clip", "inception"):
        if model.encode is None:
            raise ValueError(
                f"reward type {reward_type!r} needs RewardModel.encode "
                "(an image-feature extractor)"
            )
        encode = model.encode
        return lambda pred, target: metrics.encoder_cosine_reward(encode, pred, target)

    if reward_type == "depth":
        if model.depth is None:
            raise ValueError("reward type 'depth' needs RewardModel.depth")
        depth = model.depth
        return lambda pred, target: metrics.depth_psnr_reward(depth(pred), depth(target))

    if reward_type == "segmentation":
        if model.segment is None:
            raise ValueError("reward type 'segmentation' needs RewardModel.segment")
        segment = model.segment
        return lambda pred, target: metrics.segmentation_reward(segment(pred), segment(target))

    # VLM judges: host-side generative scoring
    if model.vlm_judge is None:
        raise ValueError(
            f"reward type {reward_type!r} needs RewardModel.vlm_judge "
            "(a host callable; wrap an external VLM service)"
        )
    judge = model.vlm_judge

    def vlm_reward(pred, target):
        scores = judge(pred.float().cpu().numpy(), target.float().cpu().numpy())
        return torch.as_tensor(scores, dtype=torch.float32, device=pred.device)

    vlm_reward.host_side = True
    return vlm_reward
