"""CLIP text encoder (SD-1.5's ViT-L/14 text tower).

Port of ``consolver_tpu/models/clip_text.py``: quick_gelu, learned positions,
causal self-attention through :func:`consolver_torch.kernels.attention.attention`
(``is_causal=True`` takes the plain masked path), and a final LayerNorm whose
f32 output is the context the UNet conditions on.  Attribute names match the
JAX module names (``layers.0.mlp_fc1``), which
``consolver_tpu.models.convert.convert_clip_text`` reads as they are.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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

    @classmethod
    def sd15(cls) -> "ClipTextConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "ClipTextConfig":
        return cls(
            vocab_size=1000, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_position_embeddings=77,
        )


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.mlp_fc1.weight.dtype
        x = x + self.self_attn(layer_norm_f32(self.layer_norm1, x).to(dtype))
        h = layer_norm_f32(self.layer_norm2, x).to(dtype)
        return x + self.mlp_fc2(quick_gelu(self.mlp_fc1(h)))


class ClipTextEncoder(nn.Module):
    """input_ids ``[B, S]`` -> last hidden state ``[B, S, hidden]`` (f32);
    ``return_pooled=True`` also returns the EOS-token state (argmax id)."""

    def __init__(self, cfg: ClipTextConfig, device=None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        with torch.device(resolve_device(device)):
            self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
            self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
            self.layers = nn.ModuleList([ClipEncoderLayer(cfg) for _ in range(cfg.num_layers)])
            self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        if dtype is not None:
            self.to(dtype)

    def forward(self, input_ids: torch.Tensor, return_pooled: bool = False):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = self.token_embedding(input_ids) + self.position_embedding(pos)[None]
        for layer in self.layers:
            x = layer(x)
        x = layer_norm_f32(self.final_layer_norm, x)
        if not return_pooled:
            return x
        eos_idx = input_ids.argmax(dim=-1)
        return x, x[torch.arange(x.shape[0], device=x.device), eos_idx]
