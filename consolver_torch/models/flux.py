"""FLUX-class rectified-flow DiT: double-stream (MMDiT) and single-stream
blocks, with the Kontext latent packing and RoPE id helpers.

Port of ``consolver_tpu/models/flux.py``.  Module and parameter names follow
the JAX module names (``transformer_blocks.0.attn_to_out_0``,
``attn_norm_q.weight`` for ``QKNorm.scale``), so
:func:`consolver_torch.models.convert.load_jax_params` carries a JAX tree
across.  Every joint attention goes through
:func:`consolver_torch.kernels.attention.attention` (head dim 128 at full
width: the flash kernel on the card).  :class:`DoubleStreamBlock` is also
SD3's MMDiT block (``models/mmdit.py``): head dim 64, no RoPE, and a
``context_pre_only`` last block.

Numerics kept from the JAX package:
  * LayerNorms run in f32, eps 1e-6, without scale or bias;
  * ``QKNorm`` is an RMS norm in f32, eps 1e-6, times a learned scale;
  * RoPE rotates interleaved pairs in f32;
  * the GELUs are tanh-approximated;
  * block modulations split as (shift, scale, gate, ...), the final
    ``norm_out_linear`` as (scale, shift);
  * ``proj_out`` computes in f32;
  * under a tensor-parallel split (``consolver_torch/dist/tp.py``) a block
    runs ``num_heads // tp`` heads, taken from its projections' widths.
  * the guidance embedding is ``timestep_embedding(guidance * 1000)``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from consolver_torch.device import resolve_device
from consolver_torch.dist.tp import row_parallel_pair
from consolver_torch.kernels.attention import attention as attention_op
from consolver_torch.kernels.quant import cast_float_layers
from consolver_torch.models.layers import TimestepEmbedding, make_dense, timestep_embedding


@dataclasses.dataclass(frozen=True)
class FluxConfig:
    in_channels: int = 64  # 2x2-packed 16-channel latents
    hidden_size: int = 3072
    num_heads: int = 24
    num_double_blocks: int = 19
    num_single_blocks: int = 38
    joint_text_dim: int = 4096  # T5 features
    pooled_text_dim: int = 768  # CLIP pooled
    axes_dims: Tuple[int, ...] = (16, 56, 56)  # RoPE dims per id axis
    guidance_embeds: bool = True
    mlp_ratio: float = 4.0
    theta: int = 10000
    # W8A8 int8 for the stream blocks' attention, FF and modulation
    # projections (kernels/quant.py); the embedders and the final norm / proj
    # stay float.  quant_int4 packs the same projections to 4 bits (W4A16,
    # group-128 scales): a memory configuration; it takes precedence.
    quant_int8: bool = False
    quant_int4: bool = False

    @property
    def head_dim(self) -> int:
        """128 at FLUX's width.  ``axes_dims`` must sum to it (RoPE rotates
        every channel); the attention kernel itself takes any head dim up to
        512."""
        return self.hidden_size // self.num_heads

    @property
    def quant_mode(self):
        """The ``make_dense`` policy: ``"int4"``, ``True`` (int8) or ``False``."""
        return "int4" if self.quant_int4 else self.quant_int8

    @classmethod
    def flux_kontext(cls) -> "FluxConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "FluxConfig":
        return cls(
            in_channels=16,
            hidden_size=48,
            num_heads=2,
            num_double_blocks=2,
            num_single_blocks=2,
            joint_text_dim=32,
            pooled_text_dim=24,
            axes_dims=(8, 8, 8),
        )


# ---------------------------------------------------------------------------
# Latent packing and position ids
# ---------------------------------------------------------------------------


def pack_latents(latents: torch.Tensor) -> torch.Tensor:
    """``[B, H, W, C]`` -> ``[B, (H/2)(W/2), 4C]`` 2x2 patches, features
    channel-major (index ``c*4 + dy*2 + dx``)."""
    b, h, w, c = latents.shape
    x = latents.reshape(b, h // 2, 2, w // 2, 2, c)
    x = x.permute(0, 1, 3, 5, 2, 4)  # (b, h/2, w/2, c, dy, dx)
    return x.reshape(b, (h // 2) * (w // 2), 4 * c)


def unpack_latents(packed: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """``[B, (H/2)(W/2), 4C]`` -> ``[B, H, W, C]``."""
    b, _, c4 = packed.shape
    c = c4 // 4
    x = packed.reshape(b, height // 2, width // 2, c, 2, 2)
    x = x.permute(0, 1, 4, 2, 5, 3)  # (b, h/2, dy, w/2, dx, c)
    return x.reshape(b, height, width, c)


def latent_image_ids(height: int, width: int, offset: float = 0.0, device=None) -> torch.Tensor:
    """``[(H/2)(W/2), 3]`` ids (t, row, col); the reference image's tokens
    take ``offset=1``."""
    h, w = height // 2, width // 2
    ids = torch.zeros((h, w, 3), dtype=torch.float32, device=device)
    ids[..., 0] = offset
    ids[..., 1] += torch.arange(h, dtype=torch.float32, device=device)[:, None]
    ids[..., 2] += torch.arange(w, dtype=torch.float32, device=device)[None, :]
    return ids.reshape(h * w, 3)


def rope_freqs(ids: torch.Tensor, axes_dims: Tuple[int, ...], theta: int = 10000):
    """ids ``[S, 3]`` -> (cos, sin), each ``[S, head_dim / 2]``, the axes
    concatenated."""
    outs_cos, outs_sin = [], []
    for axis, dim in enumerate(axes_dims):
        scale = torch.arange(0, dim, 2, dtype=torch.float32, device=ids.device) / dim
        omega = 1.0 / (theta**scale)
        out = ids[:, axis : axis + 1].float() * omega[None, :]
        outs_cos.append(torch.cos(out))
        outs_sin.append(torch.sin(out))
    return torch.cat(outs_cos, dim=-1), torch.cat(outs_sin, dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved pairs in f32.  x ``[B, S, H, D]``; cos/sin ``[S, D/2]``."""
    b, s, h, d = x.shape
    xf = x.float().reshape(b, s, h, d // 2, 2)
    x0, x1 = xf[..., 0], xf[..., 1]
    c = cos[None, :, None, :]
    si = sin[None, :, None, :]
    out = torch.stack([x0 * c - x1 * si, x0 * si + x1 * c], dim=-1)
    return out.reshape(b, s, h, d).to(x.dtype)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class MLPEmbedder(TimestepEmbedding):
    """``linear_1`` -> SiLU -> ``linear_2``."""


class QKNorm(nn.Module):
    """Per-head RMS norm of q or k in f32 (eps 1e-6), times a learned scale."""

    def __init__(self, head_dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(head_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        normed = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + 1e-6)
        return (normed * self.weight).to(x.dtype)


def _layer_norm(x: torch.Tensor) -> torch.Tensor:
    """LayerNorm without scale or bias, in f32, eps 1e-6."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=1e-6)


def _modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * (1 + scale[:, None, :]) + shift[:, None, :]


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class DoubleStreamBlock(nn.Module):
    """Image and text streams with their own weights, one joint attention
    (the MMDiT block of FLUX and SD3).

    ``cfg`` is any config with ``hidden_size``, ``head_dim``, ``mlp_ratio``
    and ``quant_mode`` (:class:`FluxConfig`, ``models/mmdit.MMDiTConfig``).
    ``context_pre_only`` (SD3's last block): the text stream only feeds the
    joint attention's keys and values, its modulation is a 2-way (scale,
    shift) ``AdaLayerNormContinuous``, and it has no output projection and
    no MLP; the block returns ``(img, None)``."""

    def __init__(self, cfg, context_pre_only: bool = False):
        super().__init__()
        h, hd = cfg.hidden_size, cfg.head_dim
        mlp_h = int(h * cfg.mlp_ratio)
        q = cfg.quant_mode
        self.head_dim = hd
        self.context_pre_only = context_pre_only
        self.norm1_linear = make_dense(q, h, 6 * h)
        self.norm1_context_linear = make_dense(q, h, (2 if context_pre_only else 6) * h)
        for prefix in ("attn_to_", "attn_add_"):
            for name in "qkv":
                setattr(self, prefix + name, make_dense(q, h, h))
        self.attn_norm_q = QKNorm(hd)
        self.attn_norm_k = QKNorm(hd)
        self.attn_norm_added_q = QKNorm(hd)
        self.attn_norm_added_k = QKNorm(hd)
        self.attn_to_out_0 = make_dense(q, h, h)
        if not context_pre_only:
            self.attn_to_add_out = make_dense(q, h, h)
        self.ff_net_0_proj = make_dense(q, h, mlp_h)
        self.ff_net_2 = make_dense(q, mlp_h, h)
        if not context_pre_only:
            self.ff_context_net_0_proj = make_dense(q, h, mlp_h)
            self.ff_context_net_2 = make_dense(q, mlp_h, h)

    def _qkv(self, x: torch.Tensor, prefix: str):
        # heads from the projection's width: num_heads // tp under a TP split
        b, s = x.shape[:2]
        return tuple(getattr(self, prefix + name)(x).reshape(b, s, -1, self.head_dim)
                     for name in "qkv")

    def forward(self, img, txt, vec, cos, sin):
        """``cos`` / ``sin`` None: no RoPE (SD3)."""
        dtype = self.attn_norm_q.weight.dtype
        b, s_txt = img.shape[0], txt.shape[1]
        i_shift_a, i_scale_a, i_gate_a, i_shift_m, i_scale_m, i_gate_m = (
            self.norm1_linear(F.silu(vec)).chunk(6, dim=-1))
        if self.context_pre_only:
            t_scale_a, t_shift_a = self.norm1_context_linear(F.silu(vec)).chunk(2, dim=-1)
        else:
            t_shift_a, t_scale_a, t_gate_a, t_shift_m, t_scale_m, t_gate_m = (
                self.norm1_context_linear(F.silu(vec)).chunk(6, dim=-1))

        img_n = _modulate(_layer_norm(img).to(dtype), i_shift_a, i_scale_a)
        txt_n = _modulate(_layer_norm(txt).to(dtype), t_shift_a, t_scale_a)
        iq, ik, iv = self._qkv(img_n, "attn_to_")
        tq, tk, tv = self._qkv(txt_n, "attn_add_")
        q = torch.cat([self.attn_norm_added_q(tq), self.attn_norm_q(iq)], dim=1)
        k = torch.cat([self.attn_norm_added_k(tk), self.attn_norm_k(ik)], dim=1)
        v = torch.cat([tv, iv], dim=1)
        if cos is not None:
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        out = attention_op(q, k, v)
        out = out.reshape(b, q.shape[1], -1)
        txt_attn, img_attn = out[:, :s_txt], out[:, s_txt:]
        if self.context_pre_only:
            img = img + i_gate_a[:, None, :] * self.attn_to_out_0(img_attn)
            img_m = _modulate(_layer_norm(img).to(dtype), i_shift_m, i_scale_m)
            img_out = self.ff_net_2(_gelu(self.ff_net_0_proj(img_m)))
            return img + i_gate_m[:, None, :] * img_out, None

        # under TP each pair of row-parallel projections sums in one all_reduce
        img_out, txt_out = row_parallel_pair(self.attn_to_out_0, img_attn,
                                             self.attn_to_add_out, txt_attn)
        img = img + i_gate_a[:, None, :] * img_out
        txt = txt + t_gate_a[:, None, :] * txt_out

        img_m = _modulate(_layer_norm(img).to(dtype), i_shift_m, i_scale_m)
        txt_m = _modulate(_layer_norm(txt).to(dtype), t_shift_m, t_scale_m)
        img_out, txt_out = row_parallel_pair(
            self.ff_net_2, _gelu(self.ff_net_0_proj(img_m)),
            self.ff_context_net_2, _gelu(self.ff_context_net_0_proj(txt_m)))
        return img + i_gate_m[:, None, :] * img_out, txt + t_gate_m[:, None, :] * txt_out


class SingleStreamBlock(nn.Module):
    """One stream over the joint tokens: attention and MLP in parallel."""

    def __init__(self, cfg: FluxConfig):
        super().__init__()
        h, hd = cfg.hidden_size, cfg.head_dim
        mlp_h = int(h * cfg.mlp_ratio)
        q = cfg.quant_mode
        self.head_dim = hd
        self.norm_linear = make_dense(q, h, 3 * h)
        self.attn_to_q = make_dense(q, h, h)
        self.attn_to_k = make_dense(q, h, h)
        self.attn_to_v = make_dense(q, h, h)
        self.attn_norm_q = QKNorm(hd)
        self.attn_norm_k = QKNorm(hd)
        self.proj_mlp = make_dense(q, h, mlp_h)
        self.proj_out = make_dense(q, h + mlp_h, h)
        self.proj_out.tp_parts = (h, mlp_h)  # reads [attn | mlp]: a TP split slices each

    def forward(self, x, vec, cos, sin):
        dtype = self.attn_norm_q.weight.dtype
        b, s, _ = x.shape
        shape = (b, s, -1, self.head_dim)  # num_heads // tp heads under a TP split
        shift, scale, gate = self.norm_linear(F.silu(vec)).chunk(3, dim=-1)
        x_n = _modulate(_layer_norm(x).to(dtype), shift, scale)
        q = self.attn_norm_q(self.attn_to_q(x_n).reshape(shape))
        k = self.attn_norm_k(self.attn_to_k(x_n).reshape(shape))
        v = self.attn_to_v(x_n).reshape(shape)
        attn = attention_op(apply_rope(q, cos, sin), apply_rope(k, cos, sin), v).reshape(b, s, -1)
        mlp = _gelu(self.proj_mlp(x_n))
        return x + gate[:, None, :] * self.proj_out(torch.cat([attn, mlp], dim=-1))


class FluxTransformer(nn.Module):
    """Call: (packed image tokens ``[B, S_img, in_ch]``, T5 tokens
    ``[B, S_txt, joint_dim]``, CLIP pooled ``[B, pooled_dim]``, timestep
    ``[B]`` in train units (sigma * 1000), guidance ``[B]``, img_ids
    ``[S_img, 3]``, txt_ids ``[S_txt, 3]``) -> velocity ``[B, S_img, in_ch]``
    in f32."""

    def __init__(self, cfg: FluxConfig, device=None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        with torch.device(resolve_device(device)):
            self.x_embedder = nn.Linear(cfg.in_channels, h)
            self.context_embedder = nn.Linear(cfg.joint_text_dim, h)
            self.timestep_embedder = MLPEmbedder(256, h)
            if cfg.guidance_embeds:
                self.guidance_embedder = MLPEmbedder(256, h)
            self.text_embedder = MLPEmbedder(cfg.pooled_text_dim, h)
            self.transformer_blocks = nn.ModuleList(
                [DoubleStreamBlock(cfg) for _ in range(cfg.num_double_blocks)])
            self.single_transformer_blocks = nn.ModuleList(
                [SingleStreamBlock(cfg) for _ in range(cfg.num_single_blocks)])
            self.norm_out_linear = nn.Linear(h, 2 * h)
            self.proj_out = nn.Linear(h, cfg.in_channels)
        if dtype is not None:
            cast_float_layers(self, dtype)

    def forward(self, img, txt, pooled, timestep, guidance, img_ids, txt_ids):
        cfg = self.cfg
        dtype = self.x_embedder.weight.dtype
        img = self.x_embedder(img.to(dtype))
        txt = self.context_embedder(txt.to(dtype))

        vec = self.timestep_embedder(timestep_embedding(timestep.float(), 256).to(dtype))
        if cfg.guidance_embeds:
            g_emb = timestep_embedding(guidance.float() * 1000.0, 256).to(dtype)
            vec = vec + self.guidance_embedder(g_emb)
        vec = vec + self.text_embedder(pooled.to(dtype))

        cos, sin = rope_freqs(torch.cat([txt_ids, img_ids], dim=0), cfg.axes_dims, cfg.theta)
        for block in self.transformer_blocks:
            img, txt = block(img, txt, vec, cos, sin)
        x = torch.cat([txt, img], dim=1)
        for block in self.single_transformer_blocks:
            x = block(x, vec, cos, sin)
        x = x[:, txt.shape[1]:]

        scale, shift = self.norm_out_linear(F.silu(vec)).chunk(2, dim=-1)
        x = _layer_norm(x).to(dtype)
        x = x * (1 + scale[:, None, :]) + shift[:, None, :]
        if isinstance(self.proj_out, nn.Linear):
            return F.linear(x.float(), self.proj_out.weight.float(), self.proj_out.bias.float())
        return self.proj_out(x.float())  # a TP split computes in its input's dtype
