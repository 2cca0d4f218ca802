"""CLIP text encoder (SD-1.5's ViT-L/14 text tower, and SD3's CLIP-L and
OpenCLIP bigG/14 towers).

Port of ``consolver_tpu/models/clip_text.py``: quick_gelu, learned positions,
causal self-attention through :func:`consolver_torch.kernels.attention.attention`
(``is_causal=True`` takes the plain masked path), and a final LayerNorm whose
f32 output is the context the UNet conditions on.  Attribute names match the
JAX module names (``layers.0.mlp_fc1``), which
``consolver_tpu.models.convert.convert_clip_text`` reads as they are.

SD3 adds three options, none of which changes the SD-1.5 or FLUX path:
:class:`ClipTextProjConfig`'s ``hidden_act="gelu"`` (bigG's exact GELU) and
``projection_dim`` (transformers' ``CLIPTextModelWithProjection``: a
bias-free ``text_projection`` of the final-LayerNorm EOS state), and
``forward(..., penultimate=True)`` (the residual stream before the last
layer, ``hidden_states[-2]``).
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional

import torch
from torch import nn

from consolver_torch.device import resolve_device
from consolver_torch.kernels.attention import attention as attention_op
from consolver_torch.models.layers import layer_norm_f32


@dataclasses.dataclass(frozen=True)
class ClipTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    # fields of ClipTextProjConfig; constants here, so that this config's
    # fields (its sidecar) stay the JAX package's
    hidden_act: ClassVar[str] = "quick_gelu"
    projection_dim: ClassVar[int] = 0

    @classmethod
    def sd15(cls) -> "ClipTextConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "ClipTextConfig":
        return cls(
            vocab_size=1000, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_position_embeddings=77,
        )


@dataclasses.dataclass(frozen=True)
class ClipTextProjConfig(ClipTextConfig):
    """transformers' ``CLIPTextModelWithProjection`` tower (SD3's CLIP-L and
    bigG): the activation, and the width of a bias-free ``text_projection``
    of the pooled state."""

    hidden_act: str = "quick_gelu"  # or "gelu" (exact, OpenCLIP bigG)
    projection_dim: int = 768

    @classmethod
    def sd3_clip_l(cls) -> "ClipTextProjConfig":
        """SD3's CLIP-L/14 (``text_encoder``): SD-1.5's tower with its
        768-wide projection."""
        return cls()

    @classmethod
    def openclip_bigg(cls) -> "ClipTextProjConfig":
        """OpenCLIP ViT-bigG/14's text tower (SD3's ``text_encoder_2``)."""
        return cls(hidden_size=1280, num_layers=32, num_heads=20, intermediate_size=5120,
                   hidden_act="gelu", projection_dim=1280)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


ACTIVATIONS = {"quick_gelu": quick_gelu, "gelu": torch.nn.functional.gelu}


class ClipAttention(nn.Module):
    def __init__(self, cfg: ClipTextConfig):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.q_proj = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.k_proj = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.v_proj = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.out_proj = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, c = x.shape
        shape = (b, s, self.num_heads, c // self.num_heads)
        q = self.q_proj(x).reshape(shape)
        k = self.k_proj(x).reshape(shape)
        v = self.v_proj(x).reshape(shape)
        return self.out_proj(attention_op(q, k, v, is_causal=True).reshape(b, s, c))


class ClipEncoderLayer(nn.Module):
    def __init__(self, cfg: ClipTextConfig):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.self_attn = ClipAttention(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.mlp_fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.mlp_fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.act = ACTIVATIONS[cfg.hidden_act]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.mlp_fc1.weight.dtype
        x = x + self.self_attn(layer_norm_f32(self.layer_norm1, x).to(dtype))
        h = layer_norm_f32(self.layer_norm2, x).to(dtype)
        return x + self.mlp_fc2(self.act(self.mlp_fc1(h)))


class ClipTextEncoder(nn.Module):
    """input_ids ``[B, S]`` -> the final-LayerNorm last hidden state ``[B, S,
    hidden]`` in f32 (SD-1.5's context), or with ``penultimate=True`` the
    residual stream that enters the last layer, without a LayerNorm, in the
    model's dtype (SD3's context).  ``return_pooled=True`` also returns the
    f32 pooled state: the final-LayerNorm state of the EOS token (argmax id;
    FLUX's pooled vector), through ``text_projection`` where the config has
    a ``projection_dim`` (SD3's)."""

    def __init__(self, cfg: ClipTextConfig, device=None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        with torch.device(resolve_device(device)):
            self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
            self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
            self.layers = nn.ModuleList([ClipEncoderLayer(cfg) for _ in range(cfg.num_layers)])
            self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
            if cfg.projection_dim:
                self.text_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False)
        if dtype is not None:
            self.to(dtype)

    def forward(self, input_ids: torch.Tensor, return_pooled: bool = False,
                penultimate: bool = False):
        """The final-LayerNorm last state (f32; SD-1.5), or with
        ``penultimate`` the stream entering the last layer (model dtype;
        SD3); with ``return_pooled`` also the pooled state (f32; through
        ``text_projection`` where the config has one)."""
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = self.token_embedding(input_ids) + self.position_embedding(pos)[None]
        hidden = None
        for i, layer in enumerate(self.layers):
            if penultimate and i == len(self.layers) - 1:
                hidden = x
            x = layer(x)
        x = layer_norm_f32(self.final_layer_norm, x)
        if hidden is None:
            hidden = x
        if not return_pooled:
            return hidden
        eos_idx = input_ids.argmax(dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eos_idx]
        if self.cfg.projection_dim:
            pooled = self.text_projection(pooled.to(self.text_projection.weight.dtype)).float()
        return hidden, pooled
