"""Attention dispatch: the one site every model's attention goes through.

Port of ``consolver_tpu/kernels/attention.py``.  Layout: q ``[B, Sq, H, D]``,
k/v ``[B, Sk, H, D]`` -> out ``[B, Sq, H, D]``.

  ===========================  ======  =====================================
  call                         device  goes to
  ===========================  ======  =====================================
  unmasked, non-causal, bf16   CUDA    the flash kernel's tensor-core route:
    padded width 64, 80 or 128         design H (wgmma + TMA)
    (48 past 128 keys), rows
    16-byte aligned
    other widths up to 160,            design A (mma.sync)
    or rows not aligned
    head dim 161-512                   design B (mma.sync, split columns)
  unmasked, non-causal, f32    CUDA    the flash kernel's FMA route
  / f16
  unmasked, non-causal         CPU     its plain version
  causal or masked             any     :func:`xla_attention`
  additive bias (T5 position)  any     :func:`xla_attention` direct
  ===========================  ======  =====================================

Every FLUX joint attention (d = 128, 24 heads, 8704 tokens for a 1024^2
edit), SD3.5's joint attention (d = 64, 38 heads, 4429 tokens), the d = 64
reward / eval backbones and the SD-1.5 UNet's level-0 self-attention and
level-1 attention (head dims 40 and 80) take design H; the UNet's level-0
cross-attention (77 keys) and its d = 160 levels design A; both VAEs' mid
attention (d = 512) design B (``flash_attention.mma_design``).  All of
them are unmasked and go to the kernel on the card.  CLIP's causal
attention and T5's position-biased attention (which calls
:func:`xla_attention` itself) take the plain path.  A CUDA call the kernel
cannot take (head dim > 512, a dtype other than bf16/f16/f32) raises;
nothing falls back.
"""

from __future__ import annotations

from typing import Optional

import torch

from consolver_torch.kernels.flash_attention import flash_attention


def xla_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    is_causal: bool = False,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain attention with the JAX package's XLA semantics: f32 logits
    (scaled by ``1/sqrt(d)``, plus ``bias``) and softmax, probabilities cast
    to the input dtype, then ``p @ v``.

    ``mask`` is boolean, broadcastable to ``[B, H, Sq, Sk]``, True = keep;
    ``bias`` is additive, broadcastable to ``[B, H, Sq, Sk]``.
    """
    scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    keep = None
    if mask is not None:
        keep = mask.to(torch.bool)
    if is_causal:
        sq, sk = q.shape[1], k.shape[1]
        causal = torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril()
        keep = causal if keep is None else keep & causal
    if keep is not None:
        logits = logits.masked_fill(~keep, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(k.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    is_causal: bool = False,
) -> torch.Tensor:
    if mask is None and not is_causal:
        return flash_attention(q, k, v)
    return xla_attention(q, k, v, mask=mask, is_causal=is_causal)
