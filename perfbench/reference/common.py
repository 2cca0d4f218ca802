"""Pieces the plain references share: the hash tokenizer the served
deployments are configured with, the noise a request seed stands for, the
image resize, float-to-uint8 rounding and the f32 building blocks.

Plain PyTorch and NumPy, in float32 with TF32 off.  Nothing here imports
the program: every formula is written down again from the published
description (diffusers, the FLUX and T5 papers) and from the served
deployment's stated settings.
"""

from __future__ import annotations

import hashlib
import math
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def exact_f32() -> None:
    """float32 matmuls and convolutions without TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# --------------------------------------------------------------- tokens
def hash_ids(texts: Sequence[str], max_length: int, vocab_size: int,
             hash_vocab: int = 49408, bos: int = 1, eos: int = 2) -> np.ndarray:
    """The deployments' tokenizer: BOS, then each whitespace-separated word as
    ``3 + (first 4 bytes of its SHA-1, little-endian) mod (hash_vocab - 3)``,
    then EOS, zero-padded and truncated to ``max_length``; ids wrap into the
    encoder's ``vocab_size``."""
    ids = np.zeros((len(texts), max_length), np.int64)
    for i, text in enumerate(texts):
        words = [3 + int.from_bytes(hashlib.sha1(w.encode()).digest()[:4], "little")
                 % (hash_vocab - 3) for w in text.split()]
        toks = [bos] + words[:max_length - 2] + [eos]
        ids[i, :len(toks)] = toks
    return ids % vocab_size


# ---------------------------------------------------------------- noise
def seed_noise(seeds: Sequence[int], shape) -> torch.Tensor:
    """A request's starting noise: ``torch.randn(shape)`` on the CPU from a
    generator seeded with the request's seed (the serving API's contract:
    the same seed, the same noise, on any device)."""
    return torch.stack([torch.randn(shape, generator=torch.Generator().manual_seed(int(s)))
                        for s in seeds])


def to_uint8(images01: torch.Tensor) -> np.ndarray:
    """[0, 1] floats -> uint8, rounding half to even."""
    return torch.round(images01.clamp(0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()


# --------------------------------------------------------------- resize
def _lanczos(x: float) -> float:
    def sinc(v):
        if v == 0.0:
            return 1.0
        v *= math.pi
        return math.sin(v) / v
    return sinc(x) * sinc(x / 3.0) if -3.0 <= x < 3.0 else 0.0


def _coeffs(in_size: int, out_size: int) -> np.ndarray:
    """The imaging library's fixed-point Lanczos coefficients, ``[out, in]``
    int64 with 22 fractional bits (its 8-bit resampler)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 3.0 * filterscale
    k = np.zeros((out_size, in_size), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        w = [_lanczos((x + xmin - center + 0.5) / filterscale) for x in range(xmax - xmin)]
        total = sum(w)
        for x, wx in enumerate(w):
            v = wx / total if total != 0.0 else 0.0
            k[xx, xmin + x] = int(0.5 + v * (1 << 22)) if v >= 0 else int(-0.5 + v * (1 << 22))
    return k


def _resample(img: np.ndarray, k: np.ndarray, axis: int) -> np.ndarray:
    x = np.ascontiguousarray(np.moveaxis(img, axis, -1), dtype=np.float64)
    # integer sums below 2**53 are exact in float64, and BLAS computes them
    sums = x.reshape(-1, x.shape[-1]) @ k.T.astype(np.float64)
    out = (np.rint(sums).astype(np.int64) + (1 << 21)) >> 22
    out = np.clip(out, 0, 255).astype(np.uint8).reshape(x.shape[:-1] + (k.shape[0],))
    return np.moveaxis(out, -1, axis)


def lanczos_resize(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``[H, W, 3]`` uint8 -> ``[height, width, 3]`` uint8: Lanczos-3,
    horizontal pass first, each pass rounded to uint8; an axis whose size
    does not change is left alone."""
    h, w = img.shape[:2]
    if width != w:
        img = _resample(img, _coeffs(w, width), 1)
    if height != h:
        img = _resample(img, _coeffs(h, height), 0)
    return img


def center_crop_resize(img: np.ndarray, size: int) -> np.ndarray:
    """Scale the short side to ``size`` (Lanczos), crop the centre;
    returns ``[size, size, 3]`` float32 in [0, 1]."""
    h, w = img.shape[:2]
    scale = size / min(w, h)
    img = lanczos_resize(img, round(w * scale), round(h * scale))
    h, w = img.shape[:2]
    left, top = (w - size) // 2, (h - size) // 2
    return img[top:top + size, left:left + size].astype(np.float32) / 255.0


# ------------------------------------------------------------ f32 blocks
def linear(W, prefix: str, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
    return F.linear(x, W(prefix + ".weight"), W(prefix + ".bias") if bias else None)


def conv(W, prefix: str, x: torch.Tensor, stride: int = 1, padding: int = 0) -> torch.Tensor:
    return F.conv2d(x, W(prefix + ".weight"), W(prefix + ".bias"), stride, padding)


def group_norm(W, prefix: str, x: torch.Tensor, groups: int, eps: float) -> torch.Tensor:
    return F.group_norm(x, groups, W(prefix + ".weight"), W(prefix + ".bias"), eps)


def layer_norm(W, prefix: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), W(prefix + ".weight"), W(prefix + ".bias"), eps)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False,
              bias: torch.Tensor = None, heads_per_chunk: int = 0) -> torch.Tensor:
    """softmax(q k^T / sqrt(d) + bias) v over ``[B, S, H, D]``, in chunks of
    heads so that the ``[B, h, Sq, Sk]`` scores fit."""
    b, sq, h, d = q.shape
    chunk = heads_per_chunk or h
    outs: List[torch.Tensor] = []
    for i in range(0, h, chunk):
        qs, ks, vs = (t[:, :, i:i + chunk].transpose(1, 2) for t in (q, k, v))
        s = qs @ ks.transpose(-1, -2) / math.sqrt(d)
        if bias is not None:
            s = s + bias[:, i:i + chunk]
        if causal:
            mask = torch.ones(sq, ks.shape[2], dtype=torch.bool, device=q.device).tril()
            s = s.masked_fill(~mask, float("-inf"))
        outs.append((s.softmax(-1) @ vs).transpose(1, 2))
        del s
    return torch.cat(outs, dim=2)


def timestep_embedding(t: torch.Tensor, dim: int, flip_sin_to_cos: bool = True,
                       shift: float = 0.0, max_period: float = 10000.0) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                           device=t.device) / (half - shift))
    args = t.float()[:, None] * freqs[None]
    sin, cos = torch.sin(args), torch.cos(args)
    return torch.cat([cos, sin], -1) if flip_sin_to_cos else torch.cat([sin, cos], -1)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------- policy
def policy_probs(W, x: torch.Tensor, action_dims: int, num_actions: int,
                 temperature: float) -> torch.Tensor:
    """The FactorNet MLP (``fc0``, ``fc1``, ``head``, ReLU) on its inputs:
    ``[B, action_dims, num_actions]`` probabilities."""
    h = F.relu(linear(W, "fc0", x))
    h = F.relu(linear(W, "fc1", h))
    logits = linear(W, "head", h).reshape(-1, action_dims, num_actions)
    return torch.softmax(logits / temperature, dim=-1)


def lmm_coefficients(raw: torch.Tensor, num_ets: int, order_dim: int) -> torch.Tensor:
    """ConsistencySolver's linear-multistep weights from the order actions
    ``[B, order_dim - 1]``: append the last action, add 1 to the first; with
    more than one output in the history, the last valid weight closes the
    sum to 1; weights past the history are zero."""
    base = torch.cat([raw, raw[:, -1:]], dim=1)
    base[:, 0] += 1.0
    coeffs = torch.zeros_like(base)
    if num_ets == 1:
        coeffs[:, 0] = 1.0  # the first step takes the model output as it is
        return coeffs
    coeffs[:, :num_ets - 1] = base[:, :num_ets - 1]
    coeffs[:, num_ets - 1] = 1.0 - base[:, :num_ets - 1].sum(dim=1)
    return coeffs
