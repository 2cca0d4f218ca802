"""Image resizing with the JAX package's semantics (``jax.image.resize`` and
``jax.image.scale_and_translate``), on tensors of any layout.

The JAX backbones resize with ``jax.image.resize`` (``"linear"`` or
``"cubic"``, antialiased) and Depth-Anything's neck with
``scale_and_translate`` at align-corners scales (``resize_align_corners``).
``F.interpolate`` is not the same function: its bicubic uses the cubic
coefficient a = -0.75 where JAX uses Keys' a = -0.5, and its antialias
filter differs.  So each resized axis gets an ``[in, out]`` weight matrix
built on the host as ``jax/_src/image/scale.py::compute_weight_mat`` builds
it, in float32:

  * the sample point of output ``j`` is ``(j + 0.5 - t) / s - 0.5`` for
    scale ``s`` and translation ``t``;
  * the kernel (triangle, or Keys cubic) is stretched by ``max(1 / s, 1)``
    when antialiasing, so a downscale low-pass filters;
  * each output's weights are divided by their sum (zero where the sum is
    within 1000 float32 epsilons of 0), and outputs whose sample point lies
    outside the input keep no weight.

Each matrix is applied as one contraction, axis after axis, in the input's
dtype (JAX casts the matrices to it too).  An axis whose size does not
change is left alone, so a same-size resize is the identity.

:func:`lanczos_resize` and :func:`bilinear_resize` are the other family: the
8-bit resample of the imaging library the JAX package's data and VLM tools
call, on uint8 numpy images, bit for bit.  The filter's support grows with
the downscale factor (so a shrink is antialiased), each output's weights are
normalised to sum to one and quantised to 22 fraction bits, the horizontal
pass runs first, and each pass rounds to 8 bits.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch

_F32 = np.float32


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(_F32(0), _F32(1) - np.abs(x))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel with a = -0.5."""
    out = ((_F32(1.5) * x - _F32(2.5)) * x) * x + _F32(1)
    out = np.where(x >= 1, ((_F32(-0.5) * x + _F32(2.5)) * x - _F32(4)) * x + _F32(2), out)
    return np.where(x >= 2, _F32(0), out).astype(_F32)


_KERNELS = {"linear": _triangle, "cubic": _keys_cubic}


@functools.lru_cache(maxsize=128)
def weight_matrix(in_size: int, out_size: int, inv_scale: float, translation: float,
                  method: str, antialias: bool) -> np.ndarray:
    """The ``[in_size, out_size]`` float32 weights of one axis.
    ``inv_scale`` is ``1 / scale`` as float32 (``resize`` divides in double
    and rounds once, ``scale_and_translate`` divides in float32, as JAX
    does)."""
    if method not in _KERNELS:
        raise ValueError(f"resize method {method!r}; one of {sorted(_KERNELS)}")
    inv = _F32(inv_scale)
    kernel_scale = np.maximum(inv, _F32(1)) if antialias else _F32(1)
    sample = (np.arange(out_size, dtype=_F32) + _F32(0.5)) * inv - _F32(translation) * inv - _F32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=_F32)[:, None]) / kernel_scale
    weights = _KERNELS[method](x.astype(_F32))
    total = weights.sum(axis=0, keepdims=True, dtype=_F32)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, _F32(1)), _F32(0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    out = np.where(inside[None, :], weights, _F32(0)).astype(_F32)
    out.flags.writeable = False  # cached and shared by every caller
    return out


def _contract(x: torch.Tensor, weights: np.ndarray, axis: int) -> torch.Tensor:
    w = torch.tensor(weights, device=x.device, dtype=x.dtype)  # a copy: the cache's stays
    return torch.movedim(torch.tensordot(x, w, dims=([axis], [0])), -1, axis)


def scale_and_translate(x: torch.Tensor, shape: Sequence[int], spatial_dims: Sequence[int],
                        scale: Sequence[float], translation: Sequence[float],
                        method: str = "linear", antialias: bool = True) -> torch.Tensor:
    """``jax.image.scale_and_translate``: output ``j`` along ``spatial_dims[i]``
    samples the input at ``(j + 0.5 - translation[i]) / scale[i] - 0.5``.
    Scales and translations are float32, as JAX promotes them."""
    if not x.is_floating_point():
        x = x.float()
    for d, s, t in zip(spatial_dims, scale, translation):
        inv = _F32(1) / _F32(s)
        x = _contract(x, weight_matrix(x.shape[d], shape[d], float(inv), float(_F32(t)), method,
                                       antialias), d)
    return x


def resize(x: torch.Tensor, shape: Sequence[int], method: str = "linear",
           antialias: bool = True) -> torch.Tensor:
    """``jax.image.resize``: every axis whose size changes is resampled
    (scale ``out / in``, no translation); the others are left alone."""
    if len(shape) != x.ndim:
        raise ValueError(f"resize to {tuple(shape)} from a {x.ndim}-d tensor")
    if not x.is_floating_point():
        x = x.float()
    for d in range(x.ndim):
        if x.shape[d] != shape[d]:
            inv = float(_F32(1.0 / (shape[d] / x.shape[d])))
            x = _contract(x, weight_matrix(x.shape[d], shape[d], inv, 0.0, method, antialias), d)
    return x


def resize_align_corners(x: torch.Tensor, size: Tuple[int, int],
                         axes: Tuple[int, int] = (1, 2)) -> torch.Tensor:
    """Bilinear resize of ``axes`` (NHWC's by default) with torch's
    ``align_corners=True`` sampling, no antialias: output ``j`` reads input
    ``j * (in - 1) / (out - 1)`` (Depth-Anything's neck and head)."""
    shape = list(x.shape)
    scales, translations = [], []
    for axis, out in zip(axes, size):
        s = (out - 1) / max(x.shape[axis] - 1, 1)
        shape[axis] = out
        scales.append(s)
        translations.append(0.5 - 0.5 * s)  # the input is read at out / s
    return scale_and_translate(x, shape, axes, scales, translations, "linear", antialias=False)


# -- the imaging library's 8-bit resample ------------------------------------

_PRECISION_BITS = 32 - 8 - 2


def _lanczos(x: float) -> float:
    def sinc(v):
        if v == 0.0:
            return 1.0
        v = v * math.pi
        return math.sin(v) / v

    return sinc(x) * sinc(x / 3) if -3.0 <= x < 3.0 else 0.0


def _bilinear(x: float) -> float:
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


# name -> (filter, support)
_FILTERS = {"lanczos": (_lanczos, 3.0), "bilinear": (_bilinear, 1.0)}


def _coefficients(in_size: int, out_size: int, kind: str):
    """Per output index: the first input index and the fixed-point weights
    ``[out_size, taps]`` (zero past each output's own window)."""
    kernel, base_support = _FILTERS[kind]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = base_support * filterscale
    ss = 1.0 / filterscale
    taps = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, taps), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [kernel((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        total = sum(w)
        for x, wx in enumerate(w):
            wx = wx / total if total != 0.0 else wx
            # round half away from zero, as C's (int)(w * 2^22 +- 0.5)
            weights[xx, x] = int(wx * (1 << _PRECISION_BITS) + (0.5 if wx >= 0 else -0.5))
        first[xx] = xmin
    return first, weights


def _resample_axis(img: np.ndarray, out_size: int, axis: int, kind: str) -> np.ndarray:
    """One 8-bit resampling pass along ``axis`` (0 = rows, 1 = columns)."""
    in_size = img.shape[axis]
    first, weights = _coefficients(in_size, out_size, kind)
    # 32-bit sums, as the library's: 255 * (sum of the positive weights, at
    # most about 1.1 * 2^22) stays below 2^31
    acc = np.full(img.shape[:axis] + (out_size,) + img.shape[axis + 1:],
                  1 << (_PRECISION_BITS - 1), np.int32)
    src = img.astype(np.int32)
    for k in range(weights.shape[1]):
        idx = np.minimum(first + k, in_size - 1)  # weight 0 past the window
        w = weights[:, k].astype(np.int32).reshape((-1,) + (1,) * (img.ndim - axis - 1))
        acc += np.take(src, idx, axis=axis) * w
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def _pil_resize(image: np.ndarray, width: int, height: int, kind: str) -> np.ndarray:
    out = image
    if width != image.shape[1]:
        out = _resample_axis(out, width, axis=1, kind=kind)
    if height != image.shape[0]:
        out = _resample_axis(out, height, axis=0, kind=kind)
    return out


def lanczos_resize(image: np.ndarray, width: int, height: int) -> np.ndarray:
    """``[H, W, C]`` uint8 -> ``[height, width, C]`` uint8 with the imaging
    library's ``LANCZOS``; an axis whose size does not change is not
    resampled."""
    return _pil_resize(image, width, height, "lanczos")


def bilinear_resize(image: np.ndarray, width: int, height: int) -> np.ndarray:
    """``[H, W, C]`` uint8 -> ``[height, width, C]`` uint8 with the imaging
    library's ``BILINEAR`` (a triangle filter, antialiased when it
    shrinks)."""
    return _pil_resize(image, width, height, "bilinear")
