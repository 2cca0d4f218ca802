"""Flash attention (non-causal, unmasked) for Hopper: a CUDA kernel written by
hand in ``consolver_torch/csrc/flash_attention.cu``, and its plain version.

The kernel replaces the JAX package's Pallas kernel
(``consolver_tpu/kernels/flash_attention.py::_flash_kernel``). It is compiled
with ``nvcc`` for ``sm_90a`` into a shared library with a plain C interface
at first use, into ``consolver_torch/kernels/_build/``, and called through
``ctypes``. Importing this module builds nothing.

Layout: q ``[B, Sq, H, D]``, k/v ``[B, Sk, H, D]`` -> out ``[B, Sq, H, D]``
in q's dtype.  :func:`flash_attention` runs the kernel for a CUDA tensor and
the plain version for a CPU tensor; it raises for a call the kernel cannot
take.  ``flash_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from consolver_torch.kernels import _nvcc

_SOURCE = _nvcc.CSRC / "flash_attention.cu"
_BUILD_DIR = _nvcc.BUILD_DIR
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
MAX_HEAD_DIM = 512
_MAX_GRID_YZ = 65535

_library = None


def build() -> ctypes.CDLL:
    """Compile the kernel (once per source version) and load it.  Raises if
    the build fails; nothing falls back to the plain version."""
    global _library
    if _library is not None:
        return _library
    lib = _nvcc.build_library(_SOURCE)
    fn = lib.consolver_flash_attention_forward
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
        + [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_void_p]
    )
    _library = lib
    return lib


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version: ``softmax(q k^T / sqrt(d)) v`` in f32, cast to q's dtype."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              name: str = "flash_attention kernel", max_head_dim: int = MAX_HEAD_DIM) -> None:
    """Raises unless the kernel ``name`` takes these operands: ``[B, S, H,
    D]`` q and k/v alike in float32/float16/bfloat16 on one device, head
    dims 1..``max_head_dim`` contiguous, non-empty sequences, and batch and
    heads within the launch grid.  Shared by every flash kernel's wrapper."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"{name} expects [B, S, H, D] tensors")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} does not match k {tuple(k.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"{name} takes float32/float16/bfloat16 alike, got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if not 1 <= d <= max_head_dim:
        raise ValueError(f"{name} takes head dims 1..{max_head_dim}, got {d}")
    if sq < 1 or k.shape[1] < 1:
        raise ValueError(f"{name} needs non-empty sequences")
    if b > _MAX_GRID_YZ or h > _MAX_GRID_YZ:
        raise ValueError(f"batch {b} or heads {h} exceed the launch grid")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError(f"{name} needs a contiguous head dim")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Non-causal unmasked attention.  CUDA tensors launch the kernel (or
    raise); CPU tensors take :func:`flash_attention_reference`."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention runs on cuda or cpu, not {q.device}")
    check_qkv(q, k, v)
    lib = build()
    b, sq, h, d = q.shape
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    _nvcc.call(
        lib.consolver_flash_attention_forward, "flash_attention", q.device,
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, sq, k.shape[1], d, *_nvcc.bshd_strides(q, k, v, out), 1.0 / (d**0.5),
    )
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
