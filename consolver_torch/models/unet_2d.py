"""SD-1.5-class conditional UNet (float path).

Port of ``consolver_tpu/models/unet_2d.py``.  The public call takes NHWC
latents, ``[B]`` integer timesteps and a ``[B, S, cross_dim]`` context and
returns NHWC epsilon; inside, the conv stacks run NCHW.  Attribute names
follow the diffusers ``UNet2DConditionModel`` keys
(``down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_out.0``), so
``consolver_tpu.models.convert.convert_unet`` reads the state dict as is.

``quant_int8`` runs the resolution levels not in ``quant_skip_levels`` on the
W8A8 int8 layers (their resnet, transformer and resample projections; the
time projections, norms, ``conv_in`` / ``conv_out`` and the time embedding
stay float); :meth:`TextToImagePipeline.quantize` skips level 0.

``forward(..., slot_invariant=True)`` gives each sample bits that depend
neither on its batch slot nor on the batch size: every float 3x3
convolution outside the top level, the top level's downsampler and the f32
``conv_out`` run one sample at a time (``layers.slot_invariant_conv``).
Deterministic programs take it; sampled ones keep the batched
convolutions.

``cuda_graphs`` (:class:`~consolver_torch.models.graphs.ForwardGraphs`)
replays the forward from a CUDA graph per input signature once its owner
enables it; only a serving engine does (``serve/engine.py``).  Every other
call runs the eager body.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from consolver_torch.device import resolve_device
from consolver_torch.kernels.quant import cast_float_layers
from consolver_torch.models.graphs import ForwardGraphs
from consolver_torch.models.layers import (
    Downsample2D,
    ResnetBlock2D,
    TimestepEmbedding,
    Transformer2D,
    Upsample2D,
    conv_f32,
    group_norm_f32,
    timestep_embedding,
)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    # True => the block at this position has cross-attention transformers.
    cross_attn_blocks: Tuple[bool, ...] = (True, True, True, False)
    attention_head_dim: int = 8  # number of heads (diffusers SD-1.5 semantics)
    cross_attention_dim: int = 768
    norm_num_groups: int = 32
    transformer_depth: int = 1
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0
    # W8A8 int8 projections (kernels/quant.py), at every resolution level
    # (an index into block_out_channels, 0 = the highest resolution) but
    # those in quant_skip_levels, which stay float.
    quant_int8: bool = False
    quant_skip_levels: Tuple[int, ...] = ()

    @classmethod
    def sd15(cls) -> "UNetConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "UNetConfig":
        """Small fixture config for tests."""
        return cls(
            block_out_channels=(32, 64),
            layers_per_block=1,
            cross_attn_blocks=(True, False),
            attention_head_dim=2,
            cross_attention_dim=32,
            norm_num_groups=8,
        )


def _transformer(cfg: UNetConfig, channels: int, quant: bool) -> Transformer2D:
    heads = cfg.attention_head_dim
    return Transformer2D(
        channels, heads, channels // heads, cfg.cross_attention_dim,
        depth=cfg.transformer_depth, groups=cfg.norm_num_groups, quant=quant,
    )


class CrossAttnDownBlock(nn.Module):
    def __init__(self, cfg: UNetConfig, in_channels: int, out_channels: int,
                 has_attn: bool, add_downsample: bool, temb_channels: int, quant: bool = False):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if i == 0 else out_channels, out_channels,
                          cfg.norm_num_groups, temb_channels, quant)
            for i in range(cfg.layers_per_block)
        ])
        self.attentions = (
            nn.ModuleList([_transformer(cfg, out_channels, quant)
                           for _ in range(cfg.layers_per_block)])
            if has_attn else None
        )
        self.downsamplers = (
            nn.ModuleList([Downsample2D(out_channels, out_channels, quant)])
            if add_downsample else None
        )

    def forward(self, x, temb, context, per_sample=False, downsample_per_sample=None):
        skips = []
        for i, resnet in enumerate(self.resnets):
            x = resnet(x, temb, per_sample)
            if self.attentions is not None:
                x = self.attentions[i](x, context)
            skips.append(x)
        if self.downsamplers is not None:
            down = per_sample if downsample_per_sample is None else downsample_per_sample
            x = self.downsamplers[0](x, down)
            skips.append(x)
        return x, skips


class CrossAttnUpBlock(nn.Module):
    def __init__(self, cfg: UNetConfig, in_channels: List[int], out_channels: int,
                 has_attn: bool, add_upsample: bool, temb_channels: int, quant: bool = False):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(c, out_channels, cfg.norm_num_groups, temb_channels, quant)
            for c in in_channels
        ])
        self.attentions = (
            nn.ModuleList([_transformer(cfg, out_channels, quant) for _ in in_channels])
            if has_attn else None
        )
        self.upsamplers = (
            nn.ModuleList([Upsample2D(out_channels, out_channels, quant)])
            if add_upsample else None
        )

    def forward(self, x, skips, temb, context, per_sample=False):
        for i, resnet in enumerate(self.resnets):
            x = resnet(torch.cat([x, skips.pop()], dim=1), temb, per_sample)
            if self.attentions is not None:
                x = self.attentions[i](x, context)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x, per_sample)
        return x


class MidBlock(nn.Module):
    def __init__(self, cfg: UNetConfig, channels: int, temb_channels: int, quant: bool = False):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(channels, channels, cfg.norm_num_groups, temb_channels, quant)
            for _ in range(2)
        ])
        self.attentions = nn.ModuleList([_transformer(cfg, channels, quant)])

    def forward(self, x, temb, context, per_sample=False):
        x = self.resnets[0](x, temb, per_sample)
        x = self.attentions[0](x, context)
        return self.resnets[1](x, temb, per_sample)


class UNet2DCondition(nn.Module):
    """epsilon-prediction UNet: (latents NHWC, timesteps [B], context
    [B, S, cross_dim]) -> noise prediction NHWC (f32)."""

    def __init__(self, cfg: UNetConfig, device=None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        self.cuda_graphs = ForwardGraphs("model.unet")
        device = resolve_device(device)
        channels = cfg.block_out_channels
        temb_channels = channels[0] * 4
        with torch.device(device):
            self.time_embedding = TimestepEmbedding(channels[0], temb_channels)
            self.conv_in = nn.Conv2d(cfg.in_channels, channels[0], 3, padding=1)

            # Channel count of every skip, in push order, to size the up path.
            skip_channels = [channels[0]]
            self.down_blocks = nn.ModuleList()
            prev = channels[0]
            for i, out_ch in enumerate(channels):
                is_last = i == len(channels) - 1
                self.down_blocks.append(CrossAttnDownBlock(
                    cfg, prev, out_ch, cfg.cross_attn_blocks[i], not is_last, temb_channels,
                    self.level_quant(i),
                ))
                skip_channels += [out_ch] * (cfg.layers_per_block + (0 if is_last else 1))
                prev = out_ch

            self.mid_block = MidBlock(cfg, channels[-1], temb_channels,
                                      self.level_quant(len(channels) - 1))

            self.up_blocks = nn.ModuleList()
            for i, out_ch in enumerate(reversed(channels)):
                rev = len(channels) - 1 - i
                ins = []
                for _ in range(cfg.layers_per_block + 1):
                    ins.append(prev + skip_channels.pop())
                    prev = out_ch
                self.up_blocks.append(CrossAttnUpBlock(
                    cfg, ins, out_ch, cfg.cross_attn_blocks[rev],
                    i != len(channels) - 1, temb_channels, self.level_quant(rev),
                ))

            self.conv_norm_out = nn.GroupNorm(cfg.norm_num_groups, channels[0], eps=1e-5)
            self.conv_out = nn.Conv2d(channels[0], cfg.out_channels, 3, padding=1)
        if dtype is not None:
            cast_float_layers(self, dtype)

    def level_quant(self, level: int) -> bool:
        return self.cfg.quant_int8 and level not in self.cfg.quant_skip_levels

    def _apply(self, *args, **kwargs):
        # new parameter storage: the graphs would read the old
        self.cuda_graphs.clear()
        return super()._apply(*args, **kwargs)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor, slot_invariant: bool = False) -> torch.Tensor:
        inputs = (sample, timesteps, encoder_hidden_states)
        if self.cuda_graphs.takes(inputs):
            return self.cuda_graphs(self._forward_eager, inputs, slot_invariant)
        return self._forward_eager(*inputs, slot_invariant)

    def _forward_eager(self, sample: torch.Tensor, timesteps: torch.Tensor,
                      encoder_hidden_states: torch.Tensor,
                      slot_invariant: bool = False) -> torch.Tensor:
        cfg = self.cfg
        dtype = self.conv_in.weight.dtype
        context = encoder_hidden_states.to(dtype)
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(sample.shape[0])

        temb = timestep_embedding(
            timesteps, cfg.block_out_channels[0], cfg.flip_sin_to_cos, cfg.freq_shift
        ).to(dtype)
        temb = self.time_embedding(temb)

        x = self.conv_in(sample.permute(0, 3, 1, 2).to(dtype))
        skips = [x]
        last = len(self.down_blocks) - 1
        for level, block in enumerate(self.down_blocks):
            x, block_skips = block(x, temb, context, slot_invariant and level > 0,
                                   downsample_per_sample=slot_invariant)
            skips.extend(block_skips)
        x = self.mid_block(x, temb, context, slot_invariant)
        for i, block in enumerate(self.up_blocks):
            x = block(x, skips, temb, context, slot_invariant and last - i > 0)

        x = F.silu(group_norm_f32(self.conv_norm_out, x)).to(dtype)
        return conv_f32(self.conv_out, x, per_sample=slot_invariant).permute(0, 2, 3, 1)
