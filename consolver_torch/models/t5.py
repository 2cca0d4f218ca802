"""T5 encoder (v1.1 / XXL class): the FLUX text encoder.

Port of ``consolver_tpu/models/t5.py``: RMS norms without bias (pre-norm),
one relative-position bias table shared by every layer, gated-GELU
feed-forward (``wi_0`` through a tanh GELU, times ``wi_1``, then ``wo``).
Attention is unscaled: q is multiplied by ``sqrt(d_kv)`` before the standard
``1/sqrt(d_kv)`` attention, as the JAX package does, and the position bias
enters :func:`consolver_torch.kernels.attention.xla_attention` as an additive
bias (the plain path).  Module names follow the JAX module names.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from consolver_torch.device import resolve_device
from consolver_torch.kernels.attention import xla_attention
from consolver_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6

    @classmethod
    def xxl(cls) -> "T5Config":
        return cls()

    @classmethod
    def tiny(cls) -> "T5Config":
        return cls(vocab_size=512, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4)


def relative_position_buckets(
    qlen: int, klen: int, num_buckets: int = 32, max_distance: int = 128
) -> np.ndarray:
    """Bidirectional T5 relative-position buckets ``[qlen, klen]``."""
    relative_position = np.arange(klen)[None, :] - np.arange(qlen)[:, None]
    nb = num_buckets // 2
    ret = (relative_position > 0).astype(np.int64) * nb
    n = np.abs(relative_position)
    max_exact = nb // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        np.log(n.clip(1) / max_exact) / np.log(max_distance / max_exact) * (nb - max_exact)
    ).astype(np.int64)
    val_if_large = np.minimum(val_if_large, nb - 1)
    return ret + np.where(is_small, n, val_if_large)


class T5LayerNorm(nn.Module):
    """RMS norm in f32 (no mean subtraction, no bias), times a scale."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        xf = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + self.eps)
        return (xf * self.weight).to(self.weight.dtype)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.num_heads, self.d_kv = cfg.num_heads, cfg.d_kv
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)

    def forward(self, x: torch.Tensor, position_bias: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        shape = (b, s, self.num_heads, self.d_kv)
        q = self.q(x).reshape(shape) * (self.d_kv**0.5)
        k = self.k(x).reshape(shape)
        v = self.v(x).reshape(shape)
        out = xla_attention(q, k, v, bias=position_bias)
        return self.o(out.reshape(b, s, self.num_heads * self.d_kv))


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.ln_attn = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)
        self.attention = T5Attention(cfg)
        self.ln_ff = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, x: torch.Tensor, position_bias: torch.Tensor) -> torch.Tensor:
        x = x + self.attention(self.ln_attn(x), position_bias)
        h = self.ln_ff(x)
        return x + self.wo(F.gelu(self.wi_0(h), approximate="tanh") * self.wi_1(h))


class T5Encoder(nn.Module):
    """input_ids ``[B, S]`` -> hidden states ``[B, S, d_model]`` in the
    weights' dtype."""

    def __init__(self, cfg: T5Config, device=None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        with torch.device(resolve_device(device)):
            self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
            self.relative_attention_bias = nn.Embedding(
                cfg.relative_attention_num_buckets, cfg.num_heads)
            self.block = nn.ModuleList([T5Block(cfg) for _ in range(cfg.num_layers)])
            self.final_layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)
        if dtype is not None:
            self.to(dtype)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dtype = self.final_layer_norm.weight.dtype
        x = self.shared(input_ids).to(dtype)
        s = input_ids.shape[1]
        buckets = profiling.to_device(
            relative_position_buckets(s, s, cfg.relative_attention_num_buckets,
                                      cfg.relative_attention_max_distance),
            input_ids.device,
        )
        position_bias = self.relative_attention_bias(buckets).permute(2, 0, 1)[None].to(dtype)
        for block in self.block:
            x = block(x, position_bias)
        return self.final_layer_norm(x)
