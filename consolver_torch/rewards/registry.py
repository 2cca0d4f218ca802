"""Reward registry: one dispatch over the reward types.

Port of ``consolver_tpu/rewards/registry.py``.  Types: depth | inception |
segmentation | image_psnr | clip | dino | llava | qwen_vl.  The backbone
rewards take an ``encode`` (or depth / segment) callable: the production
encoders from :func:`build_encoder_for`, ``models.depth_anything.
make_depth_fn`` and ``models.segformer.make_segment_fn``, or any other; the
VLM judges (``rewards/vlm.py``) are host callables that get numpy arrays.
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


def build_encoder_for(reward_type: str, params=None, device=None,
                      dtype: Optional[torch.dtype] = None) -> Callable:
    """The production feature encoder of a backbone-cosine reward type
    (reward_model.py:59-64,92-134): dino -> DINOv2-base's CLS state, clip ->
    CLIP-ViT-L/14's projected image embedding, inception -> the stock
    InceptionV3 eval forward (1000-class logits, reward_model.py:339-341).
    ``params`` is the JAX package's converted tree of that backbone, loaded
    with ``load_jax_params``; None keeps the module's own initialisation
    (seed torch first).  The backbone is ``encode.model``."""
    from consolver_torch.models.convert import load_jax_params

    if reward_type == "inception":
        from consolver_torch.models.inception import InceptionV3, make_inception_encoder

        model = InceptionV3(num_classes=1000, device=device)
        make = make_inception_encoder
    elif reward_type in ("dino", "clip"):
        from consolver_torch.models.vit import ViT, ViTConfig, make_encoder

        cfg = ViTConfig.dinov2_base() if reward_type == "dino" else ViTConfig.clip_vit_l14()
        model = ViT(cfg, device=device)

        def make(vit):
            return make_encoder(vit, reward_type)
    else:
        raise ValueError(
            f"no feature encoder for reward type {reward_type!r} (expected dino | clip | inception)"
        )
    if params is not None:
        load_jax_params(model, params)
    if dtype is not None:
        model.to(dtype)
    return make(model)


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
