"""Depth-Anything-V2 (a DPT head on a DINOv2 ViT): the SD trainer's
production ``depth`` reward.

Port of ``consolver_tpu/models/depth_anything.py``: the DINOv2 trunk tapped
at ``out_indices`` (the final LayerNorm applied to each tap), the DPT
reassemble (1x1 projection, then a ConvTranspose with kernel = stride for
factors 4 and 2, nothing for 1, a strided 3x3 with padding 1 for 0.5), the
neck's 3x3 convs, the fusion pyramid (pre-activation residual units, an
align-corners bilinear upsample, a 1x1 projection) and the head (3x3,
upsample to the patch grid's pixels, 3x3, ReLU, 1x1, ReLU).

Key names are transformers ``DepthAnythingForDepthEstimation``'s
(``backbone.*`` as ``Dinov2Backbone``, ``neck.reassemble_stage.layers.N``,
``neck.convs.N``, ``neck.fusion_stage.layers.N``, ``head.convN``), which
``convert_depth_anything`` reads; like the JAX module, the first fusion
layer has no ``residual_layer1`` (it has no residual to refine).  The
JAX ``_BlockUpsample`` einsum is exactly ``nn.ConvTranspose2d`` with kernel
= stride.  Public calls are NHWC; the neck and head run NCHW.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from consolver_torch.device import resolve_device
from consolver_torch.models.vit import (
    DINOV2_RENAMES,
    IMAGENET_MEAN,
    IMAGENET_STD,
    ViT,
    ViTConfig,
    container,
    preprocess,
)
from consolver_torch.utils.resize import resize, resize_align_corners

# ``consolver_tpu/models/depth_anything.py::convert_depth_anything`` (:228-260)
RENAMES = tuple((r"^backbone\." + p[1:], "backbone." + r) for p, r in DINOV2_RENAMES) + (
    (r"^neck\.reassemble_stage\.layers\.(\d+)\.projection\.", r"reassemble_\1_projection."),
    (r"^neck\.reassemble_stage\.layers\.(\d+)\.resize\.", r"reassemble_\1_resize."),
    (r"^neck\.convs\.(\d+)\.", r"neck_convs.\1."),
    (r"^neck\.fusion_stage\.layers\.(\d+)\.projection\.", r"fusion_\1.projection."),
    (r"^neck\.fusion_stage\.layers\.(\d+)\.residual_layer(\d)\.convolution(\d)\.",
     r"fusion_\1.residual_layer\2.convolution\3."),
    (r"^head\.conv1\.", "head_conv1."),
    (r"^head\.conv2\.", "head_conv2."),
    (r"^head\.conv3\.", "head_conv3."),
)


@dataclasses.dataclass(frozen=True)
class DepthAnythingConfig:
    backbone: ViTConfig = dataclasses.field(
        default_factory=lambda: ViTConfig(
            image_size=518, patch_size=14, hidden_size=384, num_layers=12,
            num_heads=6, layerscale=True, ln_eps=1e-6,
        )
    )
    out_indices: Tuple[int, ...] = (9, 10, 11, 12)  # 1-based encoder layers
    reassemble_factors: Tuple[float, ...] = (4, 2, 1, 0.5)
    neck_hidden_sizes: Tuple[int, ...] = (48, 96, 192, 384)
    fusion_hidden_size: int = 64
    head_hidden_size: int = 32

    @classmethod
    def small_v2(cls) -> "DepthAnythingConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "DepthAnythingConfig":
        return cls(
            backbone=ViTConfig(image_size=28, patch_size=14, hidden_size=32,
                               num_layers=4, num_heads=2, layerscale=True),
            out_indices=(1, 2, 3, 4),
            neck_hidden_sizes=(8, 8, 8, 8),
            fusion_hidden_size=8,
            head_hidden_size=8,
        )


class _PreActResidual(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.convolution1 = nn.Conv2d(channels, channels, 3, padding=1)
        self.convolution2 = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.convolution2(F.relu(self.convolution1(F.relu(x))))


class _FusionLayer(nn.Module):
    def __init__(self, channels: int, has_residual: bool):
        super().__init__()
        if has_residual:
            self.residual_layer1 = _PreActResidual(channels)
        self.residual_layer2 = _PreActResidual(channels)
        self.projection = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None,
                size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        if residual is not None:
            if x.shape != residual.shape:
                residual = resize(residual, x.shape, "linear")
            x = x + self.residual_layer1(residual)
        x = self.residual_layer2(x)
        if size is None:
            size = (x.shape[2] * 2, x.shape[3] * 2)
        return self.projection(resize_align_corners(x, size, axes=(2, 3)))


class DepthAnything(nn.Module):
    """pixel_values NHWC (ImageNet-normalised) -> predicted depth ``[B, H, W]``
    in the model dtype."""

    jax_renames = RENAMES

    def __init__(self, cfg: DepthAnythingConfig, device=None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        self.backbone = ViT(cfg.backbone, device=device)
        fusion = cfg.fusion_hidden_size
        hidden = cfg.backbone.hidden_size
        with torch.device(device):
            layers = []
            for ch, factor in zip(cfg.neck_hidden_sizes, cfg.reassemble_factors):
                layer = container(projection=nn.Conv2d(hidden, ch, 1))
                if factor > 1:
                    layer.resize = nn.ConvTranspose2d(ch, ch, int(factor), stride=int(factor))
                elif factor < 1:
                    layer.resize = nn.Conv2d(ch, ch, 3, stride=int(1 / factor), padding=1)
                layers.append(layer)
            convs = nn.ModuleList([nn.Conv2d(ch, fusion, 3, padding=1, bias=False)
                                   for ch in cfg.neck_hidden_sizes])
            fusions = nn.ModuleList([_FusionLayer(fusion, has_residual=i > 0)
                                     for i in range(len(cfg.neck_hidden_sizes))])
            self.neck = container(reassemble_stage=container(layers=nn.ModuleList(layers)),
                                  convs=convs, fusion_stage=container(layers=fusions))
            self.head = container(
                conv1=nn.Conv2d(fusion, fusion // 2, 3, padding=1),
                conv2=nn.Conv2d(fusion // 2, cfg.head_hidden_size, 3, padding=1),
                conv3=nn.Conv2d(cfg.head_hidden_size, 1, 1),
            )
        if dtype is not None:
            self.to(dtype)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        cfg, bb = self.cfg, self.cfg.backbone
        b, h, w, _ = pixel_values.shape
        ph, pw = h // bb.patch_size, w // bb.patch_size
        dtype = self.head.conv1.weight.dtype
        taps = self.backbone.taps(pixel_values, cfg.out_indices)

        features = []
        for hs, layer, conv in zip(taps, self.neck.reassemble_stage.layers, self.neck.convs):
            x = hs[:, 1:].reshape(b, ph, pw, bb.hidden_size).permute(0, 3, 1, 2).to(dtype)
            x = layer.projection(x)
            if hasattr(layer, "resize"):
                x = layer.resize(x)
            features.append(conv(x))

        # the fusion pyramid: deepest first, each step upsampled to the next level
        features = features[::-1]
        fused = None
        for idx, (feat, layer) in enumerate(zip(features, self.neck.fusion_stage.layers)):
            size = features[idx + 1].shape[2:] if idx != len(features) - 1 else None
            fused = layer(feat, size=size) if fused is None else layer(fused, feat, size=size)

        x = self.head.conv1(fused)
        x = resize_align_corners(x, (ph * bb.patch_size, pw * bb.patch_size), axes=(2, 3))
        x = F.relu(self.head.conv2(x))
        return F.relu(self.head.conv3(x))[:, 0]


def make_depth_fn(model: DepthAnything):
    """``RewardModel.depth``: images ``[B, H, W, 3]`` in [0, 1] -> depth maps
    ``[B, H, W]``: the whole image resized to the backbone's size, the
    model, and the map resized back to the source resolution
    (reward_model.py:387-392)."""

    def depth(images: torch.Tensor) -> torch.Tensor:
        size = model.cfg.backbone.image_size
        d = model(preprocess(images, size, IMAGENET_MEAN, IMAGENET_STD, resize_to=None))
        b, h, w = images.shape[:3]
        return resize(d[..., None], (b, h, w, 1), "linear")[..., 0]

    return depth
