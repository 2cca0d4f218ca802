"""W8A8 int8 and W4A16 int4 layers of the serving and rollout path.

Port of ``consolver_tpu/kernels/quant.py``, whose scheme it keeps:

  * weights: static symmetric per-output-channel int8, ``scale = max(amax,
    1e-8) / 127`` (quantized once, by :func:`quantize_like`);
  * activations: dynamic symmetric int8, one scale per token for the dense
    layers and one per SAMPLE for the convolutions.  No scale reduces over
    the batch, so a request's output does not depend on its batch-mates
    (the serving determinism contract);
  * int32 accumulation, dequantized as ``y * (act_scale * weight_scale)``,
    plus the f32 bias, then cast to the module's compute dtype;
  * int4 (W4A16): symmetric int4 in [-7, 7] with one scale per group of 128
    input rows (one group when 128 does not divide the input width), two
    nibbles per byte along the input axis; the kernel is dequantized to the
    compute dtype right before an ordinary matmul.

The integer products are large matrix products, which the JAX package leaves
to XLA outside any Pallas kernel.  On the card they are cuBLASLt's int8 GEMM
(``torch._int_mm``, int32 accumulators); on the CPU their plain version
(:func:`int_mm_reference`, f64 products of int8 values, exact) computes the
same int32.  The quantization and dequantization are plain elementwise torch
ops, as are :func:`int8_attention` (wired into no model, as in JAX) and the
int4 unpacking.

Layouts.  :class:`Int8Linear` keeps its kernel ``[out, in]`` int8 (the
``_int_mm`` right operand is its transposed view, the column-major layout
cuBLASLt's int8 GEMM takes); :class:`Int8Conv2d` keeps ``[out, kh, kw, in]``
int8, whose rows are the ``(kh, kw, in)`` columns of its im2col.  The
convolution runs NHWC inside, on an im2col made of int8 views (there is no
int8 ``unfold``); :class:`Int8Conv2d` takes and returns the port's NCHW.
:class:`Int4Linear` keeps the JAX layout, ``kernel_packed`` uint8
``[in // 2, out]`` and ``kernel_scale`` ``[groups, out]``.

Rounding follows the JAX package as it runs: the weights are quantized by
eager JAX calls (a true division by 127 or 7), the activations inside jitted
programs, where XLA turns the division of ``amax`` by the constant 127 into
a multiply by its f32 reciprocal.  Both round half to even.
"""

from __future__ import annotations

import itertools
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

INV127 = float(np.float32(1.0 / 127.0))
INT4_GROUP_SIZE = 128
IM2COL_BYTES = 1 << 30  # an int8 convolution's im2col runs in sample chunks of at most this
MIN_INT_MM_ROWS = 17  # torch._int_mm on CUDA takes more than 16 rows


# ---------------------------------------------------------------------------
# int8 (W8A8)
# ---------------------------------------------------------------------------


def quantize_weight(w: torch.Tensor, out_axis: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8: returns (w_int8, scale f32 [out])."""
    w = w.float()
    out_axis %= w.ndim
    reduce_axes = tuple(a for a in range(w.ndim) if a != out_axis)
    scale = w.abs().amax(dim=reduce_axes).clamp_min(1e-8) / 127.0
    shape = [1] * w.ndim
    shape[out_axis] = -1
    wq = torch.clamp(torch.round(w / scale.reshape(shape)), -127, 127).to(torch.int8)
    return wq, scale


def _quantize_act(x: torch.Tensor, per_token: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric activation quant; the scale keeps its reduced axes
    (size 1) so that it broadcasts.  ``per_token``: one scale per row of the
    last axis; else one per sample (every axis but the first).  Never one
    for the whole tensor: a row's rounding would then depend on its
    batch-mates."""
    x32 = x.float()
    dims = -1 if per_token else tuple(range(1, x32.ndim))
    scale = x32.abs().amax(dim=dims, keepdim=True).clamp_min(1e-8) * INV127
    return torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8), scale


def int_mm_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`int_mm`: ``a [M, K] @ b[N, K].T`` of int8 as
    f64 products, exact (every partial sum is an integer below 127^2 K <
    2^53), returned as int32."""
    return (a.double() @ b.double().t()).to(torch.int32)


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [M, K] int8 @ b [N, K].T int8`` -> int32 ``[M, N]``.  On the card
    cuBLASLt's int8 GEMM (``torch._int_mm``; K and N multiples of 8, checked
    when the weights are quantized; fewer than 17 rows are padded with
    zeros); on the CPU :func:`int_mm_reference`."""
    if not a.is_cuda:
        return int_mm_reference(a, b)
    m = a.shape[0]
    a = a.contiguous()
    if m < MIN_INT_MM_ROWS:
        a = F.pad(a, (0, 0, 0, MIN_INT_MM_ROWS - m))
    int_mm.launches += 1
    return torch._int_mm(a, b.t())[:m]


int_mm.launches = 0


def check_int8_gemm_dims(k: int, n: int, what: str) -> None:
    """cuBLASLt's int8 GEMM takes K and N in multiples of 8."""
    if k % 8 or n % 8:
        raise ValueError(f"{what}: the int8 GEMM needs its K ({k}) and N ({n}) in multiples of 8")


def _dequantize(acc: torch.Tensor, a_scale: torch.Tensor, kernel_scale: torch.Tensor,
                bias: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """``acc * (a_scale * kernel_scale) + bias`` in f32 (the JAX order: the two
    scales multiply first), cast to ``dtype``."""
    y = acc.float() * (a_scale * kernel_scale)
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def int8_dense(x: torch.Tensor, kernel_q: torch.Tensor, kernel_scale: torch.Tensor,
               bias: Optional[torch.Tensor] = None, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``y = dequant(quant(x) @ kernel_q.T) + bias`` with per-token
    activation scales; ``kernel_q`` int8 ``[out, in]``."""
    lead = x.shape[:-1]
    xq, a_scale = _quantize_act(x.reshape(-1, x.shape[-1]), per_token=True)
    y = _dequantize(int_mm(xq, kernel_q), a_scale, kernel_scale, bias, dtype)
    return y.reshape(*lead, kernel_q.shape[0])


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_pads(padding: Union[str, int], kh: int, kw: int, h: int, w: int,
              strides: Tuple[int, int]) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """``"SAME"``, ``"VALID"`` or an int as the (height, width) pads, with
    the JAX conv's meanings."""
    if padding == "SAME":
        return _same_pads(h, kh, strides[0]), _same_pads(w, kw, strides[1])
    if padding == "VALID":
        return (0, 0), (0, 0)
    return (padding, padding), (padding, padding)


def im2col_int8(xq: torch.Tensor, kh: int, kw: int, strides: Tuple[int, int],
                pads: Tuple[Tuple[int, int], Tuple[int, int]]) -> torch.Tensor:
    """NHWC int8 ``[B, H, W, C]`` -> patches ``[B * Ho * Wo, kh * kw * C]``,
    columns in ``(kh, kw, c)`` order (the HWIO kernel's rows): one strided
    view of the padded input, copied once."""
    (top, bottom), (left, right) = pads
    xp = F.pad(xq.contiguous(), (0, 0, left, right, top, bottom))
    b, hp, wp, c = xp.shape
    sh, sw = strides
    ho, wo = (hp - kh) // sh + 1, (wp - kw) // sw + 1
    if (kh, kw, sh, sw) == (1, 1, 1, 1):
        return xp.reshape(b * ho * wo, c)
    view = xp.as_strided((b, ho, wo, kh, kw, c),
                         (hp * wp * c, sh * wp * c, sw * c, wp * c, c, 1))
    return view.reshape(b * ho * wo, kh * kw * c)


def int8_conv(x: torch.Tensor, kernel_q: torch.Tensor, kernel_scale: torch.Tensor,
              bias: Optional[torch.Tensor] = None, strides: Tuple[int, int] = (1, 1),
              padding="SAME", dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """NHWC int8 convolution with one activation scale per sample.

    ``x`` ``[B, H, W, C]``; ``kernel_q`` int8 ``[out, kh, kw, in]``,
    ``kernel_scale`` f32 ``[out]``; ``padding`` as :func:`conv_pads`.
    Returns NHWC ``[B, Ho, Wo, out]``.  The JAX version pads the channels to
    a multiple of 128 for the TPU's lanes; zero channels add nothing, so the
    port does not."""
    out_ch, kh, kw, _ = kernel_q.shape
    b, h, w, c = x.shape
    xq, a_scale = _quantize_act(x, per_token=False)
    pads = conv_pads(padding, kh, kw, h, w, strides)
    kernel2d = kernel_q.reshape(out_ch, kh * kw * c)
    per_sample = kh * kw * c * (h + sum(pads[0])) * (w + sum(pads[1]))
    chunk = max(1, IM2COL_BYTES // per_sample)
    acc = torch.cat([int_mm(im2col_int8(part, kh, kw, strides, pads), kernel2d)
                     for part in xq.split(chunk)])
    ho, wo = (h + sum(pads[0]) - kh) // strides[0] + 1, (w + sum(pads[1]) - kw) // strides[1] + 1
    y = _dequantize(acc.reshape(b, ho * wo, out_ch), a_scale.reshape(b, 1, 1), kernel_scale,
                    bias, dtype)
    return y.reshape(b, ho, wo, out_ch)


class Int8Linear(nn.Module):
    """``nn.Linear`` with an int8 kernel ``[out, in]``, an f32
    ``kernel_scale [out]`` and an f32 ``bias``; it computes in, and returns,
    its input's dtype."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("kernel", torch.zeros((out_features, in_features), dtype=torch.int8))
        self.register_buffer("kernel_scale", torch.ones(out_features))
        self.register_buffer("bias", torch.zeros(out_features) if bias else None)

    def quantized_from(self, linear: nn.Linear) -> dict:
        check_int8_gemm_dims(linear.in_features, linear.out_features, "int8 dense")
        kernel, scale = quantize_weight(linear.weight, out_axis=0)
        return _with_bias({"kernel": kernel, "kernel_scale": scale}, linear.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_dense(x, self.kernel, self.kernel_scale, self.bias, dtype=x.dtype)


class Int8Conv2d(nn.Module):
    """``nn.Conv2d`` (NCHW, square kernel, int padding) with an int8 kernel
    ``[out, kh, kw, in]``, an f32 ``kernel_scale [out]`` and an f32 ``bias``;
    it returns its input's dtype (an NCHW view of an NHWC result)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bias: bool = True):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.register_buffer("kernel", torch.zeros(
            (out_channels, kernel_size, kernel_size, in_channels), dtype=torch.int8))
        self.register_buffer("kernel_scale", torch.ones(out_channels))
        self.register_buffer("bias", torch.zeros(out_channels) if bias else None)

    def quantized_from(self, conv: nn.Conv2d) -> dict:
        kh, kw = conv.kernel_size
        check_int8_gemm_dims(kh * kw * conv.in_channels, conv.out_channels, "int8 conv")
        kernel, scale = quantize_weight(conv.weight, out_axis=0)
        return _with_bias({"kernel": kernel.permute(0, 2, 3, 1).contiguous(),
                           "kernel_scale": scale}, conv.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.stride
        y = int8_conv(x.permute(0, 2, 3, 1), self.kernel, self.kernel_scale, self.bias,
                      strides=(s, s), padding=self.padding, dtype=x.dtype)
        return y.permute(0, 3, 1, 2)


def int8_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Int8 ``q kᵀ`` and ``p v`` with an f32 softmax between them; q
    ``[B, Sq, H, D]``, k / v ``[B, Sk, H, D]``.  q / k per token, the
    probabilities per row, v per (sample, head, channel) over the keys.  A
    plain function wired into no model (the models keep attention on the
    bf16 flash kernel), as in the JAX package."""
    out_dtype = dtype or q.dtype
    sm_scale = 1.0 / np.sqrt(q.shape[-1])
    qq, qs = _quantize_act(q, per_token=True)  # qs [B, Sq, H, 1]
    kq, ks = _quantize_act(k, per_token=True)
    scores = torch.einsum("bqhd,bkhd->bhqk", qq.double(), kq.double()).float()
    scores = scores * qs.permute(0, 2, 1, 3)  # [B, H, Sq, 1]
    scores = scores * ks.permute(0, 2, 3, 1)  # [B, H, 1, Sk]
    probs = torch.softmax(scores * sm_scale, dim=-1)
    p_scale = probs.amax(dim=-1, keepdim=True).clamp_min(1e-8) * INV127
    pq = torch.clamp(torch.round(probs / p_scale), -127, 127)
    v32 = v.float()
    v_scale = v32.abs().amax(dim=1, keepdim=True).clamp_min(1e-8) * INV127  # [B, 1, H, D]
    vq = torch.clamp(torch.round(v32 / v_scale), -127, 127)
    out = torch.einsum("bhqk,bkhd->bqhd", pq.double(), vq.double()).float()
    return (out * p_scale.permute(0, 2, 1, 3) * v_scale).to(out_dtype)


# ---------------------------------------------------------------------------
# int4 weights, bf16 compute (W4A16): a memory configuration, not a speed one
# ---------------------------------------------------------------------------


def pack_int4(w4: torch.Tensor) -> torch.Tensor:
    """int8-valued int4 ``[in, out]`` (``in`` even) -> uint8 ``[in // 2, out]``:
    row 2i in the low nibble, row 2i+1 in the high one."""
    lo = w4[0::2].to(torch.uint8) & 0xF
    hi = w4[1::2].to(torch.uint8) & 0xF
    return (hi << 4) | lo


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """uint8 ``[in // 2, out]`` -> int8 ``[in, out]``, nibbles sign-extended."""
    lo = (packed & 0xF).to(torch.int8)
    hi = (packed >> 4).to(torch.int8)
    lo = lo - 16 * (lo >= 8).to(torch.int8)
    hi = hi - 16 * (hi >= 8).to(torch.int8)
    return torch.stack([lo, hi], dim=1).reshape(-1, packed.shape[-1])


def _int4_groups(in_features: int, group_size: int) -> int:
    """Scale groups along the input axis: ``in / group_size`` when it divides,
    else one group (the narrow inputs, such as 64)."""
    if group_size > 0 and in_features % group_size == 0:
        return in_features // group_size
    return 1


def quantize_weight_int4(w: torch.Tensor, group_size: int = INT4_GROUP_SIZE
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric group-wise int4 of a dense kernel ``[in, out]``: returns
    (packed uint8 ``[in // 2, out]``, scale f32 ``[groups, out]``)."""
    w = w.float()
    if w.ndim != 2:
        raise ValueError(f"int4 quant expects a 2-D dense kernel, got {tuple(w.shape)}")
    in_f, out_f = w.shape
    if in_f % 2:
        raise ValueError(f"int4 packing needs an even input dim, got {in_f}")
    groups = _int4_groups(in_f, group_size)
    wg = w.reshape(groups, in_f // groups, out_f)
    scale = wg.abs().amax(dim=1).clamp_min(1e-8) / 7.0
    w4 = torch.clamp(torch.round(wg / scale[:, None, :]), -7, 7)
    return pack_int4(w4.reshape(in_f, out_f).to(torch.int8)), scale


def dequantize_int4(packed: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_weight_int4` -> the kernel ``[in, out]``."""
    w4 = unpack_int4(packed)
    in_f, out_f = w4.shape
    groups = scale.shape[0]
    wg = w4.reshape(groups, in_f // groups, out_f).float()
    return (wg * scale[:, None, :]).reshape(in_f, out_f).to(dtype)


def int4_dense(x: torch.Tensor, kernel_packed: torch.Tensor, kernel_scale: torch.Tensor,
               bias: Optional[torch.Tensor] = None, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``y = x @ dequant(kernel) + bias``, all in ``dtype`` (W4A16)."""
    y = torch.matmul(x.to(dtype), dequantize_int4(kernel_packed, kernel_scale, dtype))
    if bias is not None:
        y = y + bias.to(dtype)
    return y


class Int4Linear(nn.Module):
    """``nn.Linear`` with 4-bit packed weights: ``kernel_packed`` uint8
    ``[in // 2, out]``, ``kernel_scale`` f32 ``[groups, out]`` and an f32
    ``bias``; it computes in its input's dtype."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 group_size: int = INT4_GROUP_SIZE):
        super().__init__()
        if in_features % 2:
            raise ValueError(f"Int4Linear needs an even input dim, got {in_features}")
        self.in_features, self.out_features = in_features, out_features
        self.group_size = group_size
        groups = _int4_groups(in_features, group_size)
        self.register_buffer("kernel_packed", torch.zeros((in_features // 2, out_features),
                                                          dtype=torch.uint8))
        self.register_buffer("kernel_scale", torch.ones((groups, out_features)))
        self.register_buffer("bias", torch.zeros(out_features) if bias else None)

    def quantized_from(self, linear: nn.Linear) -> dict:
        packed, scale = quantize_weight_int4(linear.weight.t(), self.group_size)
        return _with_bias({"kernel_packed": packed, "kernel_scale": scale}, linear.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int4_dense(x, self.kernel_packed, self.kernel_scale, self.bias, dtype=x.dtype)


QUANTIZED_LAYERS = (Int8Linear, Int8Conv2d, Int4Linear)


def _with_bias(state: dict, bias: Optional[torch.Tensor]) -> dict:
    if bias is not None:
        state["bias"] = bias.detach().float()
    return state


@torch.no_grad()
def quantize_like(quant_model: nn.Module, float_model: nn.Module) -> nn.Module:
    """Fill ``quant_model`` (a model built with the quantized config, on any
    device, ``meta`` included) from ``float_model``: each quantized layer
    from the float layer of its name, one layer at a time on the float
    model's device, and a copy of every other tensor.  The port's
    ``quantize_params_like``."""
    float_layers = dict(float_model.named_modules())
    state = {}
    for name, layer in quant_model.named_modules():
        if isinstance(layer, QUANTIZED_LAYERS):
            prefix = f"{name}." if name else ""
            for key, value in layer.quantized_from(float_layers[name]).items():
                state[prefix + key] = value
    float_state = float_model.state_dict()
    for key in quant_model.state_dict():
        if key not in state:
            state[key] = float_state[key].detach().clone()
    quant_model.load_state_dict(state, strict=True, assign=True)
    return quant_model


def module_bytes(module: nn.Module) -> int:
    """Bytes of a module's parameters and buffers."""
    return sum(t.numel() * t.element_size()
               for t in itertools.chain(module.parameters(), module.buffers()))


def cast_float_layers(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """``module.to(dtype)``, except that the quantized layers keep their
    integer kernels and f32 scales and bias."""
    for layer in module.modules():
        if not isinstance(layer, QUANTIZED_LAYERS):
            layer._apply(lambda t: t.to(dtype) if t.is_floating_point() else t, recurse=False)
    return module
