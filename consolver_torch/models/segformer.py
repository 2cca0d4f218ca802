"""SegFormer-b4 (MiT encoder + all-MLP decode head): the ``segmentation``
reward's backbone.

Port of ``consolver_tpu/models/segformer.py``: overlapping patch embeddings,
efficient self-attention with sequence reduction (a ``sr x sr`` stride-sr
conv and a LayerNorm shrink the keys to ``Sq / sr^2``), Mix-FFN (dense,
depthwise 3x3, the EXACT GELU, dense), per-stage LayerNorms, and the decode
head: a dense layer per stage, a bilinear upsample to stage 0's grid, the
1x1 fuse conv, an inference BatchNorm (stored statistics, f32), ReLU and an
f32 classifier.  LayerNorms run in f32 and are cast to the model dtype, the
stage norms' outputs stay f32, as in the JAX module.

Key names are transformers ``SegformerForSemanticSegmentation``'s
(``segformer.encoder.patch_embeddings.N``, ``segformer.encoder.block.N.M``
with ``attention.self.{query,key,value,sr,layer_norm}``,
``attention.output.dense``, ``mlp.{dense1,dwconv.dwconv,dense2}``;
``segformer.encoder.layer_norm.N``; ``decode_head.{linear_c.N.proj,
linear_fuse, batch_norm, classifier}``), which ``convert_segformer`` reads.
The BatchNorm's statistics are buffers.  Public calls are NHWC; the convs
run NCHW, the tokens are row-major over the grid.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from consolver_torch.device import resolve_device
from consolver_torch.kernels.attention import attention as attention_op
from consolver_torch.models.layers import (
    batch_norm_f32,
    layer_norm_f32,
    nchw_to_tokens,
    tokens_to_nchw,
)
from consolver_torch.models.vit import IMAGENET_MEAN, IMAGENET_STD, container, preprocess
from consolver_torch.utils.resize import resize

# ``consolver_tpu/models/segformer.py::convert_segformer`` (:208-240)
RENAMES = (
    (r"^segformer\.encoder\.patch_embeddings\.(\d+)\.proj\.", r"patch_embeddings_\1_proj."),
    (r"^segformer\.encoder\.patch_embeddings\.(\d+)\.layer_norm\.", r"patch_embeddings_\1_norm."),
    (r"^segformer\.encoder\.block\.(\d+)\.(\d+)\.", r"block_\1_\2."),
    (r"^segformer\.encoder\.layer_norm\.(\d+)\.", r"stage_norm_\1."),
    (r"\.attention\.self\.query\.", ".attention.query."),
    (r"\.attention\.self\.key\.", ".attention.key."),
    (r"\.attention\.self\.value\.", ".attention.value."),
    (r"\.attention\.self\.sr\.", ".attention.sr."),
    (r"\.attention\.self\.layer_norm\.", ".attention.sr_norm."),
    (r"\.attention\.output\.dense\.", ".attention.out."),
    (r"\.mlp\.dense1\.", ".mlp.dense1."),
    (r"\.mlp\.dwconv\.dwconv\.", ".mlp.dwconv."),
    (r"\.mlp\.dense2\.", ".mlp.dense2."),
    (r"^decode_head\.linear_c\.(\d+)\.proj\.", r"linear_c_\1."),
    (r"^decode_head\.linear_fuse\.", "linear_fuse."),
    (r"^decode_head\.batch_norm\.weight$", "batch_norm.scale"),
    (r"^decode_head\.batch_norm\.bias$", "batch_norm.bias"),
    (r"^decode_head\.batch_norm\.running_mean$", "batch_norm.mean"),
    (r"^decode_head\.batch_norm\.running_var$", "batch_norm.var"),
    (r"^decode_head\.classifier\.", "classifier."),
)


@dataclasses.dataclass(frozen=True)
class SegformerConfig:
    num_channels: int = 3
    hidden_sizes: Tuple[int, ...] = (64, 128, 320, 512)
    depths: Tuple[int, ...] = (3, 8, 27, 3)  # b4
    num_heads: Tuple[int, ...] = (1, 2, 5, 8)
    patch_sizes: Tuple[int, ...] = (7, 3, 3, 3)
    strides: Tuple[int, ...] = (4, 2, 2, 2)
    sr_ratios: Tuple[int, ...] = (8, 4, 2, 1)
    mlp_ratios: Tuple[int, ...] = (4, 4, 4, 4)
    decoder_hidden_size: int = 768
    num_labels: int = 150  # ADE20k
    ln_eps: float = 1e-5  # all torch nn.LayerNorm defaults in segformer
    bn_eps: float = 1e-5

    @classmethod
    def b4_ade(cls) -> "SegformerConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "SegformerConfig":
        return cls(
            hidden_sizes=(8, 16), depths=(1, 1), num_heads=(1, 2),
            patch_sizes=(7, 3), strides=(4, 2), sr_ratios=(2, 1),
            mlp_ratios=(2, 2), decoder_hidden_size=16, num_labels=5,
        )

    @property
    def num_stages(self) -> int:
        return len(self.hidden_sizes)


class _EfficientAttention(nn.Module):
    def __init__(self, hidden: int, heads: int, sr_ratio: int, ln_eps: float):
        super().__init__()
        self.heads = heads
        self.self = container(query=nn.Linear(hidden, hidden), key=nn.Linear(hidden, hidden),
                              value=nn.Linear(hidden, hidden))
        if sr_ratio > 1:
            self.self.sr = nn.Conv2d(hidden, hidden, sr_ratio, stride=sr_ratio)
            self.self.layer_norm = nn.LayerNorm(hidden, eps=ln_eps)
        self.output = container(dense=nn.Linear(hidden, hidden))

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        attn = self.self
        b, s, hidden = x.shape
        head_dim = hidden // self.heads
        kv_in = x
        if hasattr(attn, "sr"):
            kv_in = nchw_to_tokens(attn.sr(tokens_to_nchw(x, *hw)))
            kv_in = layer_norm_f32(attn.layer_norm, kv_in).to(x.dtype)
        sk = kv_in.shape[1]
        out = attention_op(
            attn.query(x).reshape(b, s, self.heads, head_dim),
            attn.key(kv_in).reshape(b, sk, self.heads, head_dim),
            attn.value(kv_in).reshape(b, sk, self.heads, head_dim),
        ).reshape(b, s, hidden)
        return self.output.dense(out)


class _MixFFN(nn.Module):
    def __init__(self, hidden: int, mlp_hidden: int):
        super().__init__()
        self.dense1 = nn.Linear(hidden, mlp_hidden)
        self.dwconv = container(dwconv=nn.Conv2d(mlp_hidden, mlp_hidden, 3, padding=1,
                                                 groups=mlp_hidden))
        self.dense2 = nn.Linear(mlp_hidden, hidden)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        x = self.dwconv.dwconv(tokens_to_nchw(self.dense1(x), *hw))
        return self.dense2(F.gelu(nchw_to_tokens(x)))


class _SegformerLayer(nn.Module):
    def __init__(self, cfg: SegformerConfig, stage: int):
        super().__init__()
        hidden = cfg.hidden_sizes[stage]
        self.layer_norm_1 = nn.LayerNorm(hidden, eps=cfg.ln_eps)
        self.attention = _EfficientAttention(hidden, cfg.num_heads[stage], cfg.sr_ratios[stage],
                                              cfg.ln_eps)
        self.layer_norm_2 = nn.LayerNorm(hidden, eps=cfg.ln_eps)
        self.mlp = _MixFFN(hidden, int(hidden * cfg.mlp_ratios[stage]))

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        dtype = self.mlp.dense1.weight.dtype
        x = x + self.attention(layer_norm_f32(self.layer_norm_1, x).to(dtype), hw)
        return x + self.mlp(layer_norm_f32(self.layer_norm_2, x).to(dtype), hw)


class Segformer(nn.Module):
    """pixel_values NHWC (ImageNet-normalised) -> f32 logits
    ``[B, H/4, W/4, num_labels]``."""

    jax_renames = RENAMES

    def __init__(self, cfg: SegformerConfig, device=None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        dec = cfg.decoder_hidden_size
        with torch.device(resolve_device(device)):
            embeds, blocks, norms = [], [], []
            in_ch = cfg.num_channels
            for i, hidden in enumerate(cfg.hidden_sizes):
                patch = cfg.patch_sizes[i]
                embeds.append(container(
                    proj=nn.Conv2d(in_ch, hidden, patch, stride=cfg.strides[i], padding=patch // 2),
                    layer_norm=nn.LayerNorm(hidden, eps=1e-5)))
                blocks.append(nn.ModuleList([_SegformerLayer(cfg, i) for _ in range(cfg.depths[i])]))
                norms.append(nn.LayerNorm(hidden, eps=1e-5))
                in_ch = hidden
            encoder = container(patch_embeddings=nn.ModuleList(embeds), block=nn.ModuleList(blocks),
                                layer_norm=nn.ModuleList(norms))
            self.segformer = container(encoder=encoder)
            self.decode_head = container(
                linear_c=nn.ModuleList([container(proj=nn.Linear(h, dec)) for h in cfg.hidden_sizes]),
                linear_fuse=nn.Conv2d(dec * cfg.num_stages, dec, 1, bias=False),
                batch_norm=nn.BatchNorm2d(dec, eps=cfg.bn_eps),
                classifier=nn.Conv2d(dec, cfg.num_labels, 1),
            )
        if dtype is not None:
            self.to(dtype)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        cfg, encoder, head = self.cfg, self.segformer.encoder, self.decode_head
        dtype = head.linear_fuse.weight.dtype
        x = pixel_values.to(dtype).permute(0, 3, 1, 2)
        stage_feats = []
        for embed, layers, norm in zip(encoder.patch_embeddings, encoder.block, encoder.layer_norm):
            grid = embed.proj(x.to(dtype))
            hw = tuple(grid.shape[2:])
            tokens = layer_norm_f32(embed.layer_norm, nchw_to_tokens(grid)).to(dtype)
            for layer in layers:
                tokens = layer(tokens, hw)
            x = tokens_to_nchw(layer_norm_f32(norm, tokens), *hw)  # f32
            stage_feats.append((x, hw))

        target = stage_feats[0][1]
        ups = []
        for (feat, hw), linear in zip(stage_feats, head.linear_c):
            y = tokens_to_nchw(linear.proj(nchw_to_tokens(feat).to(dtype)), *hw)
            ups.append(resize(y, (y.shape[0], y.shape[1], *target), "linear"))
        fused = head.linear_fuse(torch.cat(ups[::-1], dim=1))
        fused = F.relu(batch_norm_f32(head.batch_norm, fused)).to(dtype)
        logits = F.conv2d(fused.float(), head.classifier.weight.float(),
                          head.classifier.bias.float())
        return logits.permute(0, 2, 3, 1)


def make_segment_fn(model: Segformer):
    """``RewardModel.segment``: images ``[B, H, W, 3]`` in [0, 1] -> argmax
    masks ``[B, H/4, W/4]`` at the logits' resolution (the reference scores
    pixel accuracy there, reward_model.py:458-471), after resizing the
    whole image to 512."""

    def segment(images: torch.Tensor) -> torch.Tensor:
        logits = model(preprocess(images, 512, IMAGENET_MEAN, IMAGENET_STD, resize_to=None))
        return logits.argmax(dim=-1)

    return segment
