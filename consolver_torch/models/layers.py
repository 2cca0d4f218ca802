"""Shared neural blocks of the diffusion models (float path).

Port of ``consolver_tpu/models/layers.py``.  The blocks run NCHW inside;
the models' public calls are NHWC like the JAX package's.  Module attribute
names follow the diffusers checkpoint keys (``to_out.0``, ``ff.net.0.proj``,
``transformer_blocks.0``), so the JAX converters read their state dicts.

Numerics kept from the JAX package:
  * matmuls and convs run in the weights' dtype (the compute dtype);
  * GroupNorm runs in f32, eps 1e-5 in ``ResnetBlock2D`` and 1e-6 in
    ``Transformer2D`` / ``VaeAttention``; LayerNorm runs in f32, eps 1e-5;
  * GEGLU uses the tanh-approximated GELU (flax ``nn.gelu``'s default);
  * ``Downsample2D`` pads (0, 1) then runs a VALID stride-2 conv;
  * attention tokens are row-major over (h, w).

Every attention goes through :func:`consolver_torch.kernels.attention.attention`.

``quant`` (the JAX blocks' ``quant``) picks each projection's layer through
:func:`make_dense` / :func:`make_conv`: ``True`` / ``"int8"`` the W8A8 int8
layers of :mod:`consolver_torch.kernels.quant`, ``"int4"`` the packed int4
dense layer (its convolutions stay int8), anything else the float layers.
The time projection, the norms and the models' ``conv_in`` / ``conv_out``
stay float.  A block reads its compute dtype from a norm's weights, which
are never quantized; a quantized layer computes in its input's dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from consolver_torch.kernels.attention import attention as attention_op
from consolver_torch.kernels.quant import Int4Linear, Int8Conv2d, Int8Linear


def make_dense(quant, in_features: int, out_features: int, bias: bool = True) -> nn.Module:
    """``nn.Linear``, or its quantized twin under the quant policy."""
    if quant == "int4":
        return Int4Linear(in_features, out_features, bias=bias)
    if quant:
        return Int8Linear(in_features, out_features, bias=bias)
    return nn.Linear(in_features, out_features, bias=bias)


def make_conv(quant, in_channels: int, out_channels: int, kernel_size: int,
              stride: int = 1, padding: int = 0) -> nn.Module:
    """``nn.Conv2d``, or :class:`Int8Conv2d` under any truthy quant policy."""
    if quant:
        return Int8Conv2d(in_channels, out_channels, kernel_size, stride, padding)
    return nn.Conv2d(in_channels, out_channels, kernel_size, stride=stride, padding=padding)


def group_norm_f32(norm: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """GroupNorm computed in f32 (returns f32)."""
    return F.group_norm(
        x.float(), norm.num_groups, norm.weight.float(), norm.bias.float(), norm.eps
    )


def layer_norm_f32(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm computed in f32 (returns f32)."""
    return F.layer_norm(
        x.float(), norm.normalized_shape, norm.weight.float(), norm.bias.float(), norm.eps
    )


def batch_norm_f32(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """Inference BatchNorm over NCHW in f32 with the stored statistics:
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, the JAX backbones'
    order of operations (returns f32)."""
    inv = torch.rsqrt(bn.running_var.float() + bn.eps) * bn.weight.float()
    view = (1, -1, 1, 1)
    return ((x.float() - bn.running_mean.float().view(view)) * inv.view(view)
            + bn.bias.float().view(view))


def conv_f32(conv: nn.Conv2d, x: torch.Tensor, per_sample: bool = False) -> torch.Tensor:
    """A conv run in f32 whatever its weights' dtype (the models' ``conv_out``);
    ``per_sample`` runs it one sample at a time, as :func:`slot_invariant_conv`."""
    weight, bias = conv.weight.float(), conv.bias.float()
    if per_sample:
        return _per_sample_conv(conv, x.float(), weight, bias)
    return F.conv2d(x.float(), weight, bias, conv.stride, conv.padding)


def slot_invariant_conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)`` one sample at a time: one im2col of the batch, then one GEMM
    per sample, so that a row's bits depend neither on its batch slot nor on
    the batch size.  On an H100, cuDNN's batched bf16 3x3 convolutions below
    the UNet's top resolution reduce some slots in another order than others
    (``python -m consolver_torch.probes.slot_convs``), and the top level's
    stride-2 downsampler and the f32 ``conv_out`` pick another algorithm for
    another batch size (``python -m consolver_torch.probes.dp_shapes``); one
    GEMM shape gives the same bits at every call."""
    return _per_sample_conv(conv, x, conv.weight, conv.bias)


def _per_sample_conv(conv: nn.Conv2d, x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor]) -> torch.Tensor:
    b, _, h, w = x.shape
    kh, kw = conv.kernel_size
    (ph, pw), (sh, sw) = conv.padding, conv.stride
    cols = F.unfold(x, (kh, kw), padding=(ph, pw), stride=(sh, sw))  # [B, C*kh*kw, L]
    weight = weight.reshape(conv.out_channels, -1)
    ho, wo = (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1
    out = torch.stack([weight @ col for col in cols]).reshape(b, conv.out_channels, ho, wo)
    return out if bias is None else out + bias[:, None, None]


def run_conv(conv: nn.Module, x: torch.Tensor, per_sample: bool = False) -> torch.Tensor:
    """``conv(x)``; with ``per_sample`` a float 3x3 convolution takes
    :func:`slot_invariant_conv` (1x1 and int8 convolutions are already
    slot-invariant)."""
    if per_sample and isinstance(conv, nn.Conv2d) and conv.kernel_size != (1, 1):
        return slot_invariant_conv(conv, x)
    return conv(x)


def nchw_to_tokens(x: torch.Tensor) -> torch.Tensor:
    """``[B, C, H, W]`` -> ``[B, H*W, C]``, row-major over (h, w)."""
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h * w, c)


def tokens_to_nchw(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    b, _, c = x.shape
    return x.reshape(b, h, w, c).permute(0, 3, 1, 2)


def timestep_embedding(
    timesteps: torch.Tensor,
    dim: int,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
    max_period: float = 10000.0,
) -> torch.Tensor:
    """Sinusoidal timestep embeddings (diffusers ``get_timestep_embedding``)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    if flip_sin_to_cos:
        return torch.cat([cos, sin], dim=-1)
    return torch.cat([sin, cos], dim=-1)


class TimestepEmbedding(nn.Module):
    """2-layer SiLU MLP lifting the sinusoidal embedding."""

    def __init__(self, in_dim: int, embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, embed_dim)
        self.linear_2 = nn.Linear(embed_dim, embed_dim)

    def forward(self, t_emb: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(t_emb)))


class ResnetBlock2D(nn.Module):
    """GN-SiLU-Conv x2 residual block with additive time conditioning (NCHW)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        groups: int = 32,
        temb_channels: Optional[int] = None,
        quant=False,
    ):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_channels, eps=1e-5)
        self.conv1 = make_conv(quant, in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = (
            nn.Linear(temb_channels, out_channels) if temb_channels is not None else None
        )
        self.norm2 = nn.GroupNorm(groups, out_channels, eps=1e-5)
        self.conv2 = make_conv(quant, out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (
            make_conv(quant, in_channels, out_channels, 1) if in_channels != out_channels else None
        )

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None,
                per_sample: bool = False) -> torch.Tensor:
        dtype = self.norm1.weight.dtype
        h = run_conv(self.conv1, F.silu(group_norm_f32(self.norm1, x)).to(dtype), per_sample)
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = run_conv(self.conv2, F.silu(group_norm_f32(self.norm2, h)).to(dtype), per_sample)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x.to(dtype))
        return x + h


class Attention(nn.Module):
    """Multi-head attention with optional cross-attention context
    (``[B, S, C]`` tokens); heads split as ``reshape(b, s, H, D)``."""

    def __init__(
        self,
        query_dim: int,
        num_heads: int,
        head_dim: int,
        cross_dim: Optional[int] = None,
        out_bias: bool = True,
        quant=False,
    ):
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads = num_heads
        self.head_dim = head_dim
        kv_dim = cross_dim if cross_dim is not None else query_dim
        self.to_q = make_dense(quant, query_dim, inner, bias=False)
        self.to_k = make_dense(quant, kv_dim, inner, bias=False)
        self.to_v = make_dense(quant, kv_dim, inner, bias=False)
        self.to_out = nn.ModuleList([make_dense(quant, inner, inner, bias=out_bias)])

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        # the head count comes from to_q's width: num_heads // tp under a
        # tensor-parallel split (dist/tp.py), num_heads otherwise
        context = x if context is None else context
        b, sq = x.shape[:2]
        sk = context.shape[1]
        q = self.to_q(x).reshape(b, sq, -1, self.head_dim)
        k = self.to_k(context).reshape(b, sk, -1, self.head_dim)
        v = self.to_v(context).reshape(b, sk, -1, self.head_dim)
        out = attention_op(q, k, v).reshape(b, sq, -1)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, quant=False):
        super().__init__()
        self.proj = make_dense(quant, dim_in, dim_out * 2)
        self.proj.tp_parts = (dim_out, dim_out)  # [h | gate]: a TP split slices each

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    """``net.0`` GEGLU, ``net.1`` the (inference-time) dropout, ``net.2`` out."""

    def __init__(self, dim: int, mult: int = 4, quant=False):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult, quant), nn.Identity(),
                                  make_dense(quant, dim * mult, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.net:
            x = layer(x)
        return x


class BasicTransformerBlock(nn.Module):
    """LN -> self-attn -> LN -> cross-attn -> LN -> GEGLU FF, all residual."""

    def __init__(self, dim: int, num_heads: int, head_dim: int, cross_dim: int, quant=False):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, num_heads, head_dim, quant=quant)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, num_heads, head_dim, cross_dim=cross_dim, quant=quant)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim, quant=quant)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        dtype = self.norm1.weight.dtype
        x = x + self.attn1(layer_norm_f32(self.norm1, x).to(dtype))
        x = x + self.attn2(layer_norm_f32(self.norm2, x).to(dtype), context)
        return x + self.ff(layer_norm_f32(self.norm3, x).to(dtype))


class Transformer2D(nn.Module):
    """Spatial transformer: GN -> 1x1 conv in -> transformer blocks -> 1x1 out
    (NCHW in and out; SD-1.5's conv projections)."""

    def __init__(
        self,
        channels: int,
        num_heads: int,
        head_dim: int,
        cross_dim: int,
        depth: int = 1,
        groups: int = 32,
        quant=False,
    ):
        super().__init__()
        self.norm = nn.GroupNorm(groups, channels, eps=1e-6)
        self.proj_in = make_conv(quant, channels, channels, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(channels, num_heads, head_dim, cross_dim, quant)
             for _ in range(depth)]
        )
        self.proj_out = make_conv(quant, channels, channels, 1)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        _, _, h, w = x.shape
        residual = x
        y = self.proj_in(group_norm_f32(self.norm, x).to(self.norm.weight.dtype))
        y = nchw_to_tokens(y)
        for block in self.transformer_blocks:
            y = block(y, context)
        return self.proj_out(tokens_to_nchw(y, h, w)) + residual


class Downsample2D(nn.Module):
    """Stride-2 conv after the asymmetric (0, 1) padding diffusers uses."""

    def __init__(self, in_channels: int, out_channels: int, quant=False):
        super().__init__()
        self.conv = make_conv(quant, in_channels, out_channels, 3, stride=2)

    def forward(self, x: torch.Tensor, per_sample: bool = False) -> torch.Tensor:
        return run_conv(self.conv, F.pad(x, (0, 1, 0, 1)), per_sample)


class Upsample2D(nn.Module):
    """Nearest-neighbour 2x upsample + conv."""

    def __init__(self, in_channels: int, out_channels: int, quant=False):
        super().__init__()
        self.conv = make_conv(quant, in_channels, out_channels, 3, padding=1)

    def forward(self, x: torch.Tensor, per_sample: bool = False) -> torch.Tensor:
        return run_conv(self.conv, F.interpolate(x, scale_factor=2.0, mode="nearest"), per_sample)


class VaeAttention(nn.Module):
    """Single-head self-attention block of the VAE mid blocks (NCHW)."""

    def __init__(self, channels: int, groups: int = 32, quant=False):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, channels, eps=1e-6)
        self.to_q = make_dense(quant, channels, channels)
        self.to_k = make_dense(quant, channels, channels)
        self.to_v = make_dense(quant, channels, channels)
        self.to_out = nn.ModuleList([make_dense(quant, channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        residual = x
        t = nchw_to_tokens(group_norm_f32(self.group_norm, x)).to(self.group_norm.weight.dtype)
        q = self.to_q(t).reshape(b, h * w, 1, c)
        k = self.to_k(t).reshape(b, h * w, 1, c)
        v = self.to_v(t).reshape(b, h * w, 1, c)
        out = self.to_out[0](attention_op(q, k, v).reshape(b, h * w, c))
        return tokens_to_nchw(out, h, w) + residual
