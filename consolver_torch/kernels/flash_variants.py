"""The three flash-attention variants that the JAX package probed at the
FLUX-Kontext attention shapes (d = 128, 24 heads), as CUDA kernels written
by hand in ``consolver_torch/csrc/flash_variants.cu``, each with its plain
version.

They replace the Pallas kernels of ``scripts/probe_flash_variants.py``:

* :func:`flash_bf16` (``flash_bf16``, :70): ``s = (q k^T) * scale`` with bf16
  inputs and f32 sums, the KV mask, a chunked online softmax whose ``p`` is
  rounded to bf16 for the PV product while ``l`` sums the f32 ``p``;
* :func:`flash_int8` (``flash_int8``, :148): per-token int8 q and k,
  per-(batch, head, channel) int8 v, quantized here in plain torch
  (:func:`quantize_int8`) and laid out for the kernel
  (:func:`int8_kernel_operands`); inside the kernel (:func:`launch_int8`)
  int32 dot products, ``pq = round(p * 127)`` against the current chunk's
  row max (round half to even), ``l`` from the quantized probabilities,
  starting at 1e-20;
* :func:`flash_nomask` (``flash_nomask``, :307): :func:`flash_bf16` with q
  pre-scaled in f32 and rounded to bf16, and no KV mask (``Sq % block_q``
  and ``Sk % block_k`` must be 0).

The semantics are defined per ``block_k`` chunk of keys: the row max that
``p`` (and, for int8, ``round(p * 127)``) is taken against is the running
max through the end of the current chunk, so the results depend on
``block_k`` and the plain versions walk the same chunks.  ``block_q`` only
sets the JAX padding, which does not change any row; :func:`flash_nomask`
checks it as the JAX ``assert`` does.

Routes (:func:`kernel_route`, by the type of q/k/v; each wrapper counts its
launches in ``.launches`` and per route in ``.launches_by_route``):

* ``"mma"``: bf16 q/k/v in :func:`flash_bf16` / :func:`flash_nomask`, the
  tensor-core kernel.  It walks each chunk twice (the max, then ``p``) and
  keeps no scores in shared memory, so it takes any ``block_k`` that is a
  multiple of 64, as the JAX function does.  Rows that start 16-byte
  aligned with ``d % 8 == 0`` arrive by ``cp.async``; others are staged
  element by element by the same kernel (:func:`staging`).
* ``"fma"``: f32 / f16 q/k/v in the same two wrappers (a bf16 MMA would
  round them): the first port's FMA kernel, which keeps a chunk's scores
  in shared memory, so ``block_k <= MAX_BLOCK_K``.
* ``"imma"``: :func:`flash_int8` for every output type, the int8
  tensor-core kernel (``mma.sync`` m16n8k32 s8).  Like "mma" it walks each
  chunk twice and keeps no scores in shared memory; it takes ``block_k`` in
  multiples of 64 up to ``INT8_MAX_BLOCK_K`` (1024, where ``pq . v`` stays
  exact in f32), on operands laid out by :func:`int8_kernel_operands`
  (always cp.async).

Layout: q ``[B, Sq, H, D]``, k/v ``[B, Sk, H, D]`` -> out in q's dtype.  A
CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
version.  The library is built at first use
(:mod:`consolver_torch.kernels._nvcc`); importing this module builds
nothing.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch

from consolver_torch.kernels import _nvcc
from consolver_torch.kernels.flash_attention import (_DTYPE_CODES, check_qkv, rows_aligned,
                                                     staging)

_SOURCE = _nvcc.CSRC / "flash_variants.cu"
_VARIANT_CODES = {"bf16": 0, "nomask": 1, "int8": 2}
NEG_INF = -1e30
MAX_HEAD_DIM = 128
SUB_TILE = 64  # keys per shared-memory tile inside a chunk
MAX_BLOCK_K = 512  # FMA route: a chunk's scores stay in shared memory
INT8_MAX_BLOCK_K = 1024  # imma route: |pq . v| <= 1024 * 127^2 < 2^24

_library = None


def build() -> ctypes.CDLL:
    """Compile the variants' library (once per source version) and load it."""
    global _library
    if _library is not None:
        return _library
    lib = _nvcc.build_library(_SOURCE)
    fn = lib.consolver_flash_variant_forward
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
        + [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_void_p]
    )
    occ = lib.consolver_flash_mma_occupancy
    occ.restype = ctypes.c_int
    occ.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                    ctypes.POINTER(ctypes.c_int)]
    iocc = lib.consolver_flash_imma_occupancy
    iocc.restype = ctypes.c_int
    iocc.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    _library = lib
    return lib


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _to_bhsd(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 1, 3).float()


def _online_softmax(chunks, sq_shape, v_dim, device, l0=0.0):
    """The chunked online softmax shared by the three plain versions.
    ``chunks`` yields, per chunk, its f32 scores and ``update(scores,
    m_new) -> (l_part, acc_part)``, which turns them into probabilities
    against the running max ``m_new`` through this chunk."""
    m = torch.full(sq_shape, NEG_INF, device=device)
    l = torch.full(sq_shape, l0, device=device)
    acc = torch.zeros(sq_shape + (v_dim,), device=device)
    for scores, update in chunks:
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        l_part, acc_part = update(scores, m_new)
        l = l * alpha + l_part
        acc = acc * alpha[..., None] + acc_part
        m = m_new
    return acc, l


def _bf16_chunks(q, k, v, block_k, scale):
    """Scores and updates of the bf16-dot variants, one ``block_k`` chunk
    at a time (a ragged last chunk is short; its padded columns would carry
    -1e30 and add nothing)."""
    kt, vt = _to_bhsd(k), _to_bhsd(v)
    for c0 in range(0, kt.shape[2], block_k):
        s = torch.einsum("bhqd,bhkd->bhqk", q, kt[:, :, c0:c0 + block_k])
        if scale is not None:
            s = s * scale
        vc = vt[:, :, c0:c0 + block_k]

        def update(scores, m_new, vc=vc):
            p = torch.exp(scores - m_new[..., None])
            pv = torch.einsum("bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(), vc)
            return p.sum(dim=-1), pv

        yield s, update


def flash_bf16_reference(q, k, v, block_q: int = 512, block_k: int = 512) -> torch.Tensor:
    """Plain :func:`flash_bf16`: the same chunks, in f32 torch ops."""
    del block_q
    scale = 1.0 / (q.shape[-1] ** 0.5)
    acc, l = _online_softmax(_bf16_chunks(_to_bhsd(q), k, v, block_k, scale),
                             (q.shape[0], q.shape[2], q.shape[1]), v.shape[-1], q.device)
    return (acc / l[..., None]).permute(0, 2, 1, 3).to(q.dtype)


def flash_nomask_reference(q, k, v, block_q: int = 512, block_k: int = 512) -> torch.Tensor:
    """Plain :func:`flash_nomask`: q scaled in f32 and rounded to bf16, then
    unscaled bf16-dot chunks."""
    _check_divisible(q, k, block_q, block_k)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    qs = (_to_bhsd(q) * scale).to(torch.bfloat16).float()
    acc, l = _online_softmax(_bf16_chunks(qs, k, v, block_k, None),
                             (q.shape[0], q.shape[2], q.shape[1]), v.shape[-1], q.device)
    return (acc / l[..., None]).permute(0, 2, 1, 3).to(q.dtype)


# XLA compiles the JAX package's divisions by the constant 127 into
# multiplies by the f32 reciprocal (and ``x / 127 / 127`` into one multiply
# by the f32 square of it); the port multiplies by the same constants.
INV127 = float(np.float32(1.0 / 127.0))
INV127_SQ = float(np.float32(INV127) * np.float32(INV127))


def quantize_int8(q, k, v) -> Tuple[torch.Tensor, ...]:
    """The int8 operands of :func:`flash_int8`, as the JAX wrapper makes
    them: per-token symmetric int8 q and k with scales ``max(amax, 1e-8) /
    127`` ``[B, S, H]``; per-(batch, head, channel) int8 v over the keys,
    with ``vs = v_scale / 127`` ``[B, H, D]``.  Returns (qq, qs, kq, ks, vq,
    vs), the int8 tensors ``[B, S, H, D]``, all contiguous."""

    def quant_tokens(x):
        x32 = x.float()
        s = x32.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) * INV127
        return torch.clamp(torch.round(x32 / s), -127, 127).to(torch.int8), s[..., 0]

    qq, qs = quant_tokens(q)
    kq, ks = quant_tokens(k)
    v32 = v.float()
    v_amax = v32.abs().amax(dim=1, keepdim=True).clamp_min(1e-8)  # [B, 1, H, D]
    vq = torch.clamp(torch.round(v32 / (v_amax * INV127)), -127, 127).to(torch.int8)
    vs = (v_amax * INV127_SQ)[:, 0]  # [B, H, D]
    return tuple(t.contiguous() for t in (qq, qs, kq, ks, vq, vs))


def int8_chunk_probs(scores: torch.Tensor, m_new: torch.Tensor) -> torch.Tensor:
    """``round(p * 127)`` of one chunk, half to even, against its row max."""
    return torch.round(torch.exp(scores - m_new[..., None]) * 127.0)


def flash_int8_reference(q, k, v, block_q: int = 512, block_k: int = 512) -> torch.Tensor:
    """Plain :func:`flash_int8`: the same quantization and chunks.  The
    integer products are exact in f32 (|q.k| <= 128 * 127^2 and, for
    ``block_k <= 1024``, |pq.v| <= 1024 * 127^2 < 2^24)."""
    del block_q
    _check_int8_block(block_k)
    qq, qs, kq, ks, vq, vs = quantize_int8(q, k, v)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    qt, kt, vt = _to_bhsd(qq), _to_bhsd(kq), _to_bhsd(vq)
    q_mul = qs.permute(0, 2, 1) * scale  # [B, H, Sq]: qs * scale, as in JAX
    kst = ks.permute(0, 2, 1)  # [B, H, Sk]

    def chunks():
        for c0 in range(0, kt.shape[2], block_k):
            s = torch.einsum("bhqd,bhkd->bhqk", qt, kt[:, :, c0:c0 + block_k])
            s = s * q_mul[..., None] * kst[:, :, None, c0:c0 + block_k]
            vc = vt[:, :, c0:c0 + block_k]

            def update(scores, m_new, vc=vc):
                pq = int8_chunk_probs(scores, m_new)
                pv = torch.einsum("bhqk,bhkd->bhqd", pq, vc) * vs[:, :, None, :]
                return pq.sum(dim=-1) * INV127, pv

            yield s, update

    acc, l = _online_softmax(chunks(), tuple(q_mul.shape), v.shape[-1], q.device, l0=1e-20)
    return (acc / l[..., None]).permute(0, 2, 1, 3).to(q.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_divisible(q, k, block_q, block_k):
    if q.shape[1] % block_q or k.shape[1] % block_k:
        raise ValueError(
            f"flash_nomask needs Sq % block_q == 0 and Sk % block_k == 0, got Sq {q.shape[1]}, "
            f"Sk {k.shape[1]}, blocks ({block_q}, {block_k})")


def _check_int8_block(block_k):
    if block_k > INT8_MAX_BLOCK_K:
        raise ValueError(f"flash_int8 takes block_k <= {INT8_MAX_BLOCK_K} (exact int sums in f32), "
                         f"got {block_k}")


def kernel_route(dtype: torch.dtype, variant: str = "bf16") -> str:
    """The kernel a CUDA call takes: ``"imma"`` (int8 tensor cores) for
    int8, whatever the output type; for bf16 and nomask, ``"mma"`` (tensor
    cores) on bf16 q/k/v and ``"fma"`` on f32 / f16, which a bf16 MMA would
    round."""
    if variant == "int8":
        return "imma"
    return "mma" if dtype == torch.bfloat16 else "fma"


_BLOCK_K_LIMITS = {"mma": None, "imma": INT8_MAX_BLOCK_K, "fma": MAX_BLOCK_K}


def _check(q, k, v, block_k, route=None):
    """Raises unless the ``route`` kernel (by default the one q's dtype
    takes) accepts these operands and ``block_k``: a multiple of 64, with
    no upper limit on "mma", up to ``INT8_MAX_BLOCK_K`` on "imma" and up to
    ``MAX_BLOCK_K`` on "fma"."""
    check_qkv(q, k, v, "the flash variant kernels", MAX_HEAD_DIM)
    _check_block_k(block_k, route or kernel_route(q.dtype))


def _check_block_k(block_k, route):
    limit = _BLOCK_K_LIMITS[route]
    if block_k % SUB_TILE or block_k < SUB_TILE or (limit is not None and block_k > limit):
        upto = f" up to {limit}" if limit else ""
        raise ValueError(f"the {route} flash variant kernel takes block_k in multiples of "
                         f"{SUB_TILE}{upto}, got {block_k}")


def _launch(variant, q, k, v, out, block_k, route):
    """The bf16 / nomask kernels (routes "mma" and "fma")."""
    lib = build()
    b, sq, h, d = q.shape
    vec = staging(route, d, rows_aligned(q, k, v, out)) == "cp.async"
    _nvcc.call(
        lib.consolver_flash_variant_forward, f"flash_{variant}", q.device,
        _VARIANT_CODES[variant], _DTYPE_CODES[out.dtype],
        q.data_ptr(), k.data_ptr(), v.data_ptr(), 0, 0, 0, out.data_ptr(),
        b, h, sq, k.shape[1], d, block_k, int(vec), *_nvcc.bshd_strides(q, k, v, out),
        1.0 / (d**0.5),
    )


def mma_occupancy(variant: str = "bf16", vec: bool = True) -> Tuple[int, int]:
    """The tensor-core kernel's dynamic shared memory per block (bytes) and
    its resident blocks per SM on the current card."""
    lib = build()
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.consolver_flash_mma_occupancy(_VARIANT_CODES[variant], int(vec), ctypes.byref(smem),
                                           ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"occupancy query failed (code {rc})")
    return smem.value, blocks.value


def imma_occupancy(dtype: torch.dtype = torch.bfloat16) -> Tuple[int, int]:
    """``int8_mma_kernel``'s dynamic shared memory per block (bytes) and its
    resident blocks per SM on the current card, for output type ``dtype``."""
    lib = build()
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.consolver_flash_imma_occupancy(_DTYPE_CODES[dtype], ctypes.byref(smem),
                                            ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"occupancy query failed (code {rc})")
    return smem.value, blocks.value


def _device_check(q, name):
    if q.device.type != "cuda":
        raise RuntimeError(f"{name} runs on cuda or cpu, not {q.device}")


def flash_bf16(q, k, v, block_q: int = 512, block_k: int = 512) -> torch.Tensor:
    """bf16-dot flash attention with the KV mask; see the module docstring."""
    if q.device.type == "cpu":
        return flash_bf16_reference(q, k, v, block_q, block_k)
    _device_check(q, "flash_bf16")
    route = kernel_route(q.dtype)
    _check(q, k, v, block_k, route)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch("bf16", q, k, v, out, block_k, route)
    _count(flash_bf16, route)
    return out


def flash_nomask(q, k, v, block_q: int = 512, block_k: int = 512) -> torch.Tensor:
    """bf16-dot flash attention, q pre-scaled to bf16, no KV mask."""
    _check_divisible(q, k, block_q, block_k)
    if q.device.type == "cpu":
        return flash_nomask_reference(q, k, v, block_q, block_k)
    _device_check(q, "flash_nomask")
    route = kernel_route(q.dtype)
    _check(q, k, v, block_k, route)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch("nomask", q, k, v, out, block_k, route)
    _count(flash_nomask, route)
    return out


class Int8Operands(NamedTuple):
    """The int8 kernel's operands (:func:`int8_kernel_operands`): ``qq``
    ``[B, Sq, H, D16]`` and ``kq`` ``[B, Sk, H, D16]`` int8 with the head
    dim zero-padded to a multiple of 16; ``vq_t`` ``[B, H, D16, Sk16]``
    int8, V transposed with its keys zero-padded to a multiple of 16; ``ks_t``
    ``[B, H, Sk16]`` f32; ``qs`` ``[B, Sq, H]`` and ``vs`` ``[B, H, D]`` f32
    as :func:`quantize_int8` gives them.  All contiguous."""

    qq: torch.Tensor
    qs: torch.Tensor
    kq: torch.Tensor
    ks_t: torch.Tensor
    vq_t: torch.Tensor
    vs: torch.Tensor


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def int8_kernel_operands(qq, qs, kq, ks, vq, vs) -> Int8Operands:
    """Lays :func:`quantize_int8`'s tensors out for the int8 tensor-core
    kernel.  ``ldmatrix`` has no 8-bit transpose, and the ``pq . v`` MMA
    wants 4 consecutive keys of one channel in a register, so V is handed
    over transposed; zero padding of the head dim (to 16) adds nothing to
    any integer product, and the padded keys are masked in the kernel.
    Every row then starts on 16 bytes, so every tile arrives by cp.async."""
    d, sk = qq.shape[-1], kq.shape[1]
    dpad, skpad = _round16(d), _round16(sk)

    def pad_d(x):
        return torch.nn.functional.pad(x, (0, dpad - d)).contiguous()

    vq_t = torch.nn.functional.pad(vq.permute(0, 2, 3, 1), (0, skpad - sk, 0, dpad - d))
    ks_t = torch.nn.functional.pad(ks.permute(0, 2, 1), (0, skpad - sk))
    return Int8Operands(pad_d(qq), qs.contiguous(), pad_d(kq), ks_t.contiguous(),
                        vq_t.contiguous(), vs.contiguous())


def launch_int8(ops: Int8Operands, dtype: torch.dtype, block_k: int = 512) -> torch.Tensor:
    """``int8_mma_kernel`` on operands already quantized and laid out; the
    output ``[B, Sq, H, D]`` in ``dtype``.  CUDA only: the CPU path of
    :func:`flash_int8` is its plain version."""
    if ops.qq.device.type != "cuda":
        raise RuntimeError(f"launch_int8 runs on cuda only, not {ops.qq.device} (flash_int8 takes "
                           "the plain version on the cpu)")
    _check_block_k(block_k, "imma")
    lib = build()
    b, sq, h, _ = ops.qq.shape
    d = ops.vs.shape[-1]
    out = torch.empty((b, sq, h, d), dtype=dtype, device=ops.qq.device)
    vt = ops.vq_t.stride()
    _nvcc.call(
        lib.consolver_flash_variant_forward, "flash_int8", out.device,
        _VARIANT_CODES["int8"], _DTYPE_CODES[dtype],
        ops.qq.data_ptr(), ops.kq.data_ptr(), ops.vq_t.data_ptr(), ops.qs.data_ptr(),
        ops.ks_t.data_ptr(), ops.vs.data_ptr(), out.data_ptr(),
        b, h, sq, ops.kq.shape[1], d, block_k, 1,
        *_nvcc.bshd_strides(ops.qq, ops.kq), vt[0], vt[2], vt[1], *_nvcc.bshd_strides(out),
        1.0 / (d**0.5),
    )
    _count(flash_int8, "imma")
    return out


def flash_int8(q, k, v, block_q: int = 512, block_k: int = 512) -> torch.Tensor:
    """int8 flash attention: quantization and layout in plain torch, then
    the kernel on the int8 operands (:func:`launch_int8`)."""
    _check_int8_block(block_k)
    if q.device.type == "cpu":
        return flash_int8_reference(q, k, v, block_q, block_k)
    _device_check(q, "flash_int8")
    _check(q, k, v, block_k, kernel_route(q.dtype, "int8"))
    return launch_int8(int8_kernel_operands(*quantize_int8(q, k, v)), q.dtype, block_k)


def _count(kernel, route):
    kernel.launches += 1
    kernel.launches_by_route[route] += 1


KERNELS = (flash_bf16, flash_int8, flash_nomask)


def reset_counts() -> None:
    """Sets every wrapper's launch counts to 0."""
    for kernel in KERNELS:
        kernel.launches = 0
        kernel.launches_by_route = ({"imma": 0} if kernel is flash_int8
                                    else {"mma": 0, "fma": 0})


reset_counts()
