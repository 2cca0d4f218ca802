"""SD3's MMDiT (diffusers ``SD3Transformer2DModel``): Stable Diffusion 3.5
Large's rectified-flow denoiser.

The blocks are :class:`consolver_torch.models.flux.DoubleStreamBlock`, whose
equations are SD3's: adaLN-Zero modulation of each stream (LayerNorm without
scale or bias, eps 1e-6), separate q/k/v, output and tanh-GELU MLP weights
per stream, RMS q/k norms, and one joint attention over the image and text
tokens (head dim 64 at full width: kernel #1 on the card).  SD3 runs them
without RoPE, and its last block is ``context_pre_only``.  Around them:

  * ``pos_embed_proj``: the 2x2 patch embedding (diffusers'
    ``pos_embed.proj`` convolution, kept as the linear map of
    :func:`~consolver_torch.models.flux.pack_latents`' channel-major
    patches, which its kernel flattens to);
  * ``pos_embed``: the 2-D sin-cos table of diffusers' ``PatchEmbed``
    (``pos_embed_max_size`` x ``pos_embed_max_size`` positions at
    ``base_size = sample_size / patch_size``), a buffer in the model's dtype
    that a hub checkpoint's ``pos_embed.pos_embed`` fills; each call adds its
    centre crop to the latent's patches, and the sum is rounded to the
    model's dtype, as diffusers does;
  * ``timestep_embedder`` (``Timesteps(256, flip_sin_to_cos)`` then an MLP)
    plus ``text_embedder`` (the pooled CLIP vector through an MLP), the
    conditioning vector of every modulation;
  * ``context_embedder`` (T5 width -> hidden);
  * ``norm_out_linear`` (scale, shift) and ``proj_out`` (in f32, as FLUX's),
    whose features are (row, column, channel) of each patch.

Call: latents NHWC ``[B, H, W, in_channels]``, context ``[B, S_txt,
joint_attention_dim]``, pooled ``[B, pooled_projection_dim]``, timestep
``[B]`` in train units (sigma * 1000) -> velocity NHWC ``[B, H, W,
out_channels]`` in f32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from consolver_torch.device import resolve_device
from consolver_torch.kernels.quant import cast_float_layers
from consolver_torch.models.flux import DoubleStreamBlock, MLPEmbedder, _layer_norm, pack_latents
from consolver_torch.models.layers import timestep_embedding


@dataclasses.dataclass(frozen=True)
class MMDiTConfig:
    in_channels: int = 16
    out_channels: int = 16
    patch_size: int = 2
    hidden_size: int = 2432  # num_heads x 64; caption_projection_dim is the same
    num_heads: int = 38
    num_layers: int = 38
    joint_attention_dim: int = 4096  # T5 features (the CLIP states zero-padded to it)
    pooled_projection_dim: int = 2048  # CLIP-L + bigG pooled
    pos_embed_max_size: int = 192
    sample_size: int = 128  # the latent side the position table is centred on
    mlp_ratio: float = 4.0
    # W8A8 int8 for the blocks' attention, MLP and modulation projections
    # (kernels/quant.py), as FluxConfig.quant_int8
    quant_int8: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def quant_mode(self) -> bool:
        """The ``make_dense`` policy of the blocks."""
        return self.quant_int8

    @classmethod
    def sd35_large(cls) -> "MMDiTConfig":
        """``stabilityai/stable-diffusion-3.5-large`` ``transformer/config.json``."""
        return cls()

    @classmethod
    def tiny(cls) -> "MMDiTConfig":
        return cls(hidden_size=48, num_heads=2, num_layers=2, joint_attention_dim=32,
                   pooled_projection_dim=24, pos_embed_max_size=8, sample_size=8)


def sincos_pos_embed(dim: int, grid_size: int, base_size: int) -> np.ndarray:
    """diffusers' ``get_2d_sincos_pos_embed(dim, grid_size, base_size)`` in
    float64: ``[grid_size**2, dim]``, row-major positions; the first half of
    the channels encodes the column, the second the row, each as
    ``[sin, cos]`` of ``pos * 10000**(-i / (dim / 4))`` with ``pos = index /
    (grid_size / base_size)``."""
    pos = np.arange(grid_size, dtype=np.float64) / (grid_size / base_size)
    omega = 1.0 / 10000 ** (np.arange(dim // 4, dtype=np.float64) / (dim / 4))

    def axis(p):
        out = np.outer(p, omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    cols = np.tile(pos, grid_size)
    rows = np.repeat(pos, grid_size)
    return np.concatenate([axis(cols), axis(rows)], axis=1)


class SD3Transformer(nn.Module):
    """The MMDiT of SD3 (module docstring)."""

    def __init__(self, cfg: MMDiTConfig, device=None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if cfg.patch_size != 2:
            raise ValueError("the MMDiT packs 2x2 patches (pack_latents)")
        self.cfg = cfg
        h, p = cfg.hidden_size, cfg.patch_size
        device = resolve_device(device)
        with torch.device(device):
            self.pos_embed_proj = nn.Linear(cfg.in_channels * p * p, h)
            self.register_buffer("pos_embed", torch.empty(cfg.pos_embed_max_size ** 2, h))
            self.timestep_embedder = MLPEmbedder(256, h)
            self.text_embedder = MLPEmbedder(cfg.pooled_projection_dim, h)
            self.context_embedder = nn.Linear(cfg.joint_attention_dim, h)
            self.transformer_blocks = nn.ModuleList(
                [DoubleStreamBlock(cfg, context_pre_only=i == cfg.num_layers - 1)
                 for i in range(cfg.num_layers)])
            self.norm_out_linear = nn.Linear(h, 2 * h)
            self.proj_out = nn.Linear(h, p * p * cfg.out_channels)
        if device.type != "meta":
            self.init_pos_embed_()
        if dtype is not None:
            cast_float_layers(self, dtype)

    @torch.no_grad()
    def init_pos_embed_(self) -> "SD3Transformer":
        """Fill the position table from its recipe (a model built on
        ``meta`` and moved with ``to_empty`` holds no table until this or a
        checkpoint fills it)."""
        cfg = self.cfg
        table = sincos_pos_embed(cfg.hidden_size, cfg.pos_embed_max_size,
                                 cfg.sample_size // cfg.patch_size)
        self.pos_embed.copy_(torch.from_numpy(table))
        return self

    def cropped_pos_embed(self, h: int, w: int) -> torch.Tensor:
        """The table's centre ``h x w`` patches, ``[h * w, hidden]``."""
        m = self.cfg.pos_embed_max_size
        if h > m or w > m:
            raise ValueError(f"{h}x{w} patches exceed the {m}x{m} position table")
        top, left = (m - h) // 2, (m - w) // 2
        table = self.pos_embed.reshape(m, m, -1)[top:top + h, left:left + w]
        return table.reshape(h * w, -1)

    def forward(self, latents, context, pooled, timestep):
        cfg = self.cfg
        dtype = self.pos_embed_proj.weight.dtype
        b, height, width, _ = latents.shape
        p = cfg.patch_size
        x = self.pos_embed_proj(pack_latents(latents).to(dtype))
        x = (x + self.cropped_pos_embed(height // p, width // p)).to(dtype)
        txt = self.context_embedder(context.to(dtype))
        vec = self.timestep_embedder(timestep_embedding(timestep.float(), 256).to(dtype))
        vec = vec + self.text_embedder(pooled.to(dtype))
        for block in self.transformer_blocks:
            x, txt = block(x, txt, vec, None, None)

        scale, shift = self.norm_out_linear(F.silu(vec)).chunk(2, dim=-1)
        x = _layer_norm(x).to(dtype) * (1 + scale[:, None, :]) + shift[:, None, :]
        out = F.linear(x.float(), self.proj_out.weight.float(), self.proj_out.bias.float())
        out = out.reshape(b, height // p, width // p, p, p, cfg.out_channels)
        return out.permute(0, 1, 3, 2, 4, 5).reshape(b, height, width, cfg.out_channels)
