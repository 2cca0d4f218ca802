"""Flash attention (non-causal, unmasked) for Hopper: CUDA kernels written by
hand in ``consolver_torch/csrc/flash_attention.cu``, and their plain version.

The kernels replace the JAX package's Pallas kernel
(``consolver_tpu/kernels/flash_attention.py::_flash_kernel``) and keep its
function: f32 scores and f32 probabilities.  They are compiled with ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface at first use,
into ``consolver_torch/kernels/_build/``, and called through ``ctypes``.
Importing this module builds nothing.

Routes (:func:`kernel_route`, by the type of q/k/v):

* ``"mma"``: bf16 q/k/v, on tensor cores.  ``q k^T`` is a bf16 MMA (exact
  products, f32 sums), and ``p`` is split into ``bf16(p)`` and
  ``bf16(p - bf16(p))`` for two ``p v`` MMAs, which keeps the f32-``p``
  function.  Head dims up to 160 take design A (:func:`mma_design`), one warp
  per 16 query rows over all columns; 160 < d <= 512 take design B, whose
  warps split the output columns.  :func:`padded_width` gives the head dim
  the kernel runs on.  Rows that start 16-byte aligned with ``d % 8 == 0``
  arrive by ``cp.async``; others are staged element by element by the same
  kernel (:func:`staging`).
* ``"fma"``: f32 / f16 q/k/v, which a bf16 MMA would round: plain f32 FMAs.

Layout: q ``[B, Sq, H, D]``, k/v ``[B, Sk, H, D]`` -> out ``[B, Sq, H, D]``
in q's dtype.  :func:`flash_attention` runs a kernel for a CUDA tensor and
the plain version for a CPU tensor; it raises for a call the kernels cannot
take.  ``flash_attention.launches`` counts kernel launches and
``flash_attention.launches_by_route`` counts them per route.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from consolver_torch.kernels import _nvcc

_SOURCE = _nvcc.CSRC / "flash_attention.cu"
_BUILD_DIR = _nvcc.BUILD_DIR
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
MAX_HEAD_DIM = 512
MMA_A_MAX_DIM = 160  # design A up to here, design B above
FMA_WIDTHS = (32, 48, 64, 80, 128, 160, 256, 512)
MMA_WIDTHS = tuple(range(16, MMA_A_MAX_DIM + 1, 16)) + (256, 512)
_MAX_GRID_YZ = 65535

_library = None


def build() -> ctypes.CDLL:
    """Compile the kernels (once per source version) and load them.  Raises
    if the build fails; nothing falls back to the plain version."""
    global _library
    if _library is not None:
        return _library
    lib = _nvcc.build_library(_SOURCE)
    fn = lib.consolver_flash_attention_forward
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
        + [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_void_p]
    )
    info = lib.consolver_flash_attention_mma_info
    info.restype = ctypes.c_int
    info.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 5
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


def kernel_route(dtype: torch.dtype) -> str:
    """The kernel a CUDA call takes: ``"mma"`` (tensor cores) for bf16 q/k/v,
    ``"fma"`` for f32 / f16, which a bf16 MMA would round."""
    return "mma" if dtype == torch.bfloat16 else "fma"


def mma_design(d: int) -> str:
    """The tensor-core design a head dim takes: ``"A"`` (one warp owns 16
    query rows and every output column) up to ``MMA_A_MAX_DIM``, ``"B"`` (the
    warps split the output columns) above."""
    _check_head_dim(d)
    return "A" if d <= MMA_A_MAX_DIM else "B"


def padded_width(d: int, route: str) -> int:
    """The head dim the ``route`` kernel runs on; columns past ``d`` are
    zeros in shared memory.  "mma": the next multiple of 16 up to 160, then
    256 or 512; "fma": the next of ``FMA_WIDTHS``."""
    _check_head_dim(d)
    widths = MMA_WIDTHS if route == "mma" else FMA_WIDTHS
    return next(w for w in widths if d <= w)


def _check_head_dim(d: int) -> None:
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"the flash_attention kernels take head dims 1..{MAX_HEAD_DIM}, got {d}")


def rows_aligned(*tensors: torch.Tensor) -> bool:
    """Whether every ``[B, S, H, D]`` row of these 2-byte tensors starts on
    16 bytes: data pointers on 16 bytes, (batch, sequence, head) strides
    multiples of 8 elements."""
    return all(t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])
               for t in tensors)


def staging(route: str, d: int, aligned: bool) -> str:
    """How a kernel brings tiles into shared memory: ``"cp.async"`` 16-byte
    copies (bf16 tensor-core route "mma" with ``d % 8 == 0`` and aligned
    rows; always on the int8 route "imma", whose operands the wrapper pads
    to 16-byte rows), else ``"elementwise"``."""
    if route == "imma":
        return "cp.async"
    return "cp.async" if route == "mma" and d % 8 == 0 and aligned else "elementwise"


def mma_occupancy(d: int, vec: bool = True) -> Dict[str, int]:
    """The tensor-core kernel a bf16 call with head dim ``d`` launches on the
    current card: its design, padded width, threads, dynamic shared memory
    per block (bytes) and resident blocks per SM."""
    lib = build()
    out = [ctypes.c_int(0) for _ in range(5)]
    rc = lib.consolver_flash_attention_mma_info(d, int(vec), *map(ctypes.byref, out))
    if rc != 0:
        raise RuntimeError(f"occupancy query failed (code {rc})")
    design, width, threads, smem, blocks = (x.value for x in out)
    return {"design": "AB"[design], "width": width, "threads": threads,
            "dynamic_smem_bytes": smem, "blocks_per_sm": blocks}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Non-causal unmasked attention.  CUDA tensors launch the kernel of
    their route (or raise); CPU tensors take :func:`flash_attention_reference`."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention runs on cuda or cpu, not {q.device}")
    check_qkv(q, k, v)
    route = kernel_route(q.dtype)
    lib = build()
    b, sq, h, d = q.shape
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    vec = staging(route, d, rows_aligned(q, k, v, out)) == "cp.async"
    _nvcc.call(
        lib.consolver_flash_attention_forward, "flash_attention", q.device,
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, sq, k.shape[1], d, int(vec), *_nvcc.bshd_strides(q, k, v, out), 1.0 / (d**0.5),
    )
    flash_attention.launches += 1
    flash_attention.launches_by_route[route] += 1
    return out


def reset_counts() -> None:
    """Sets the wrapper's launch counts to 0."""
    flash_attention.launches = 0
    flash_attention.launches_by_route = {"mma": 0, "fma": 0}


reset_counts()
