"""AutoencoderKL (the SD VAE), float path.

Port of ``consolver_tpu/models/vae.py``.  The whole module tree (encoder and
decoder) is here so a JAX parameter tree carries across whole; the preview
path runs only :meth:`AutoencoderKL.decode`.  ``quant_int8`` runs the
decoder's ``mid_block`` and ``up_blocks`` on the W8A8 int8 layers; the
encoder, the quant convs and the decoder's ``conv_in`` / ``conv_out`` stay
float.  Public calls are NHWC; the conv
stacks run NCHW.  Attribute names follow the diffusers keys, which
``consolver_tpu.models.convert.convert_vae`` reads as they are.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from consolver_torch.device import resolve_device
from consolver_torch.kernels.quant import cast_float_layers
from consolver_torch.models.layers import (
    Downsample2D,
    ResnetBlock2D,
    Upsample2D,
    VaeAttention,
    conv_f32,
    group_norm_f32,
)


@dataclasses.dataclass(frozen=True)
class VaeConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    # W8A8 int8 decoder mid_block and up_blocks (kernels/quant.py).
    quant_int8: bool = False

    @classmethod
    def sd15(cls) -> "VaeConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "VaeConfig":
        return cls(block_out_channels=(16, 32), layers_per_block=1, norm_num_groups=4)


class _MidBlock(nn.Module):
    def __init__(self, channels: int, groups: int, quant: bool = False):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(channels, channels, groups, quant=quant)
                                      for _ in range(2)])
        self.attentions = nn.ModuleList([VaeAttention(channels, groups, quant)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _ResnetStack(nn.Module):
    """``resnets.*`` then an optional ``downsamplers.0`` / ``upsamplers.0``."""

    def __init__(self, in_channels: int, out_channels: int, layers: int, groups: int,
                 resample: Optional[str], quant: bool = False):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if j == 0 else out_channels, out_channels, groups,
                          quant=quant)
            for j in range(layers)
        ])
        if resample == "down":
            self.downsamplers = nn.ModuleList([Downsample2D(out_channels, out_channels)])
        elif resample == "up":
            self.upsamplers = nn.ModuleList([Upsample2D(out_channels, out_channels, quant)])
        self.resample = resample

    def forward(self, x):
        for resnet in self.resnets:
            x = resnet(x)
        if self.resample == "down":
            x = self.downsamplers[0](x)
        elif self.resample == "up":
            x = self.upsamplers[0](x)
        return x


class Encoder(nn.Module):
    def __init__(self, cfg: VaeConfig):
        super().__init__()
        ch = cfg.block_out_channels
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList([
            _ResnetStack(ch[max(i - 1, 0)], c, cfg.layers_per_block, cfg.norm_num_groups,
                         "down" if i != len(ch) - 1 else None)
            for i, c in enumerate(ch)
        ])
        self.mid_block = _MidBlock(ch[-1], cfg.norm_num_groups)
        self.conv_norm_out = nn.GroupNorm(cfg.norm_num_groups, ch[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(ch[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        """NCHW image -> NCHW moments (f32)."""
        dtype = self.conv_in.weight.dtype
        x = self.conv_in(x.to(dtype))
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        x = F.silu(group_norm_f32(self.conv_norm_out, x)).to(dtype)
        return conv_f32(self.conv_out, x)


class Decoder(nn.Module):
    def __init__(self, cfg: VaeConfig):
        super().__init__()
        rev = list(reversed(cfg.block_out_channels))
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = _MidBlock(rev[0], cfg.norm_num_groups, cfg.quant_int8)
        self.up_blocks = nn.ModuleList([
            _ResnetStack(rev[max(i - 1, 0)], c, cfg.layers_per_block + 1, cfg.norm_num_groups,
                         "up" if i != len(rev) - 1 else None, cfg.quant_int8)
            for i, c in enumerate(rev)
        ])
        self.conv_norm_out = nn.GroupNorm(cfg.norm_num_groups, rev[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(rev[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z):
        """NCHW latents -> NCHW image (f32)."""
        dtype = self.conv_in.weight.dtype
        x = self.mid_block(self.conv_in(z.to(dtype)))
        for block in self.up_blocks:
            x = block(x)
        x = F.silu(group_norm_f32(self.conv_norm_out, x)).to(dtype)
        return conv_f32(self.conv_out, x)


class AutoencoderKL(nn.Module):
    """``encode`` (mean, logvar) and ``decode``, NHWC; the 1x1 quant convs
    run in f32 as in the JAX package."""

    def __init__(self, cfg: VaeConfig, device=None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        with torch.device(resolve_device(device)):
            self.encoder = Encoder(cfg)
            self.decoder = Decoder(cfg)
            self.quant_conv = nn.Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1)
            self.post_quant_conv = nn.Conv2d(cfg.latent_channels, cfg.latent_channels, 1)
        if dtype is not None:
            cast_float_layers(self, dtype)

    def encode(self, x: torch.Tensor):
        """x NHWC in [-1, 1] -> (mean, logvar), each ``[B, h, w, latent]``."""
        moments = conv_f32(self.quant_conv, self.encoder(x.permute(0, 3, 1, 2)))
        mean, logvar = moments.permute(0, 2, 3, 1).chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z (unscaled latents) NHWC -> image NHWC in about [-1, 1]."""
        z = conv_f32(self.post_quant_conv, z.permute(0, 3, 1, 2))
        return self.decoder(z).permute(0, 2, 3, 1)


def chunked_apply(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                  chunk: Optional[int]) -> torch.Tensor:
    """Apply ``fn`` over ``chunk``-sized batch slices (bounding its
    activation memory); ``None`` or ``chunk >= B`` is one whole-batch call."""
    if chunk is None or x.shape[0] <= chunk:
        return fn(x)
    return torch.cat([fn(part) for part in x.split(chunk)], dim=0)


def decode_latents(vae: AutoencoderKL, latents: torch.Tensor,
                   scaling_factor: Optional[float] = None,
                   chunk: Optional[int] = None) -> torch.Tensor:
    """Scaled latents -> images in [0, 1]."""
    sf = scaling_factor if scaling_factor is not None else vae.cfg.scaling_factor
    img = chunked_apply(vae.decode, latents / sf, chunk)
    return (img / 2 + 0.5).clamp(0.0, 1.0)
