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
  function.  :func:`padded_width` gives the head dim the kernel runs on and
  :func:`mma_design` the design:

  - H (Hopper's own path, ``wgmma`` + TMA, warp-specialised) on kernels 64
    and 128 columns wide, for rows that arrive by copies: padded widths 64
    and 128 (the SD3.5 joint attention at d = 64, FLUX's at d = 128, the
    d = 64 backbones) and, by measurement, SD-1.5's widths 80 and 48 (the
    latter past one 128-key tile: its self-attention).  A producer warp keeps
    TMA loads of K and V tiles in flight; two consumer warpgroups of 64
    query rows each run ``S = Q K^T`` and ``O += p_hi V + p_lo V`` as
    ``wgmma`` and take turns, so that one's exponentials overlap the other's
    MMAs.  At d = 64 the exponentials (one ``exp2`` a score on the SFU)
    cost about as much as the MMAs; at d = 128 the MMAs bound it.
  - A, ``mma.sync`` with one warp per 16 query rows over all columns: the
    other widths up to 160 (SD-1.5's 160, its 77-key cross-attention at 48)
    and every width whose rows are staged element by element.
  - B, whose warps split the output columns: 160 < d <= 512.

  Rows that start 16-byte aligned with ``d % 8 == 0`` arrive by copies
  (``cp.async`` in A and B, TMA in H); others are staged element by element
  by design A or B (:func:`staging`).
* ``"fma"``: f32 / f16 q/k/v, which a bf16 MMA would round: plain f32 FMAs.

Layout: q ``[B, Sq, H, D]``, k/v ``[B, Sk, H, D]`` -> out ``[B, Sq, H, D]``
in q's dtype.  :func:`flash_attention` runs a kernel for a CUDA tensor and
the plain version for a CPU tensor; it raises for a call the kernels cannot
take.  ``flash_attention.launches`` counts kernel launches,
``flash_attention.launches_by_route`` counts them per route and
``flash_attention.launches_by_design`` the "mma" route's per design.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from consolver_torch.kernels import _nvcc

_SOURCE = _nvcc.CSRC / "flash_attention.cu"
_BUILD_DIR = _nvcc.BUILD_DIR
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
MAX_HEAD_DIM = 512
MMA_A_MAX_DIM = 160  # designs A and H up to here, design B above
WGMMA_WIDTHS = (64, 128)  # design H's kernels: head dims up to 64, up to 128
# Padded widths (of designs A and B) that design H takes with aligned rows,
# and the least key length it takes there.  64 and 128 are its own; 80
# (SD-1.5 level 1) and 48 (level 0) ran faster on H's wider kernels at every
# main-path shape of theirs but level 0's 77-key cross-attention, which one
# key tile leaves on A (PERF.md §5).
H_WIDTHS = {48: 129, 64: 1, 80: 1, 128: 1}
_DESIGN_CODES = {"A": 0, "B": 1, "H": 2}
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
        [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
        + [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_void_p]
    )
    info = lib.consolver_flash_attention_mma_info
    info.restype = ctypes.c_int
    info.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 4
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


def mma_design(d: int, aligned: bool = True, sq: int = 1, sk: int = 1) -> str:
    """The tensor-core design a bf16 call takes, from its head dim ``d``,
    whether its rows are 16-byte aligned (:func:`rows_aligned`) and its
    query and key lengths: ``"H"`` (wgmma + TMA) at the padded widths of
    ``H_WIDTHS`` when the rows arrive by copies (:func:`staging`) and ``sk``
    reaches the width's least key length, ``"A"`` (one warp owns 16 query
    rows and every output column) at the other widths up to
    ``MMA_A_MAX_DIM``, ``"B"`` (the warps split the output columns) above.
    ``sq`` does not move the choice; the defaults are a call of one query
    and one key."""
    _check_head_dim(d)
    if sq < 1 or sk < 1:
        raise ValueError(f"sequence lengths must be positive, got {sq}, {sk}")
    if d > MMA_A_MAX_DIM:
        return "B"
    least_sk = H_WIDTHS.get(padded_width(d, "mma"))
    if least_sk is not None and staging("mma", d, aligned) == "cp.async" and sk >= least_sk:
        return "H"
    return "A"


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
    copies, or TMA tile loads in design H (bf16 tensor-core route "mma" with
    ``d % 8 == 0`` and aligned rows; always on the int8 route "imma", whose
    operands the wrapper pads to 16-byte rows), else ``"elementwise"``."""
    if route == "imma":
        return "cp.async"
    return "cp.async" if route == "mma" and d % 8 == 0 and aligned else "elementwise"


def mma_occupancy(d: int, vec: bool = True, design: Optional[str] = None) -> Dict[str, int]:
    """The tensor-core kernel that a bf16 call with head dim ``d`` and
    staging ``vec`` (copies) launches on the current card in ``design``
    ("A", "B" or "H"; by default :func:`mma_design` of ``d`` and ``vec``):
    its design, the width it runs on, threads, dynamic shared memory per
    block (bytes) and resident blocks per SM."""
    design = design or mma_design(d, vec)
    lib = build()
    out = [ctypes.c_int(0) for _ in range(4)]
    rc = lib.consolver_flash_attention_mma_info(_DESIGN_CODES[design], d, int(vec),
                                                *map(ctypes.byref, out))
    if rc != 0:
        raise RuntimeError(f"occupancy query failed (code {rc})")
    width, threads, smem, blocks = (x.value for x in out)
    return {"design": design, "width": width, "threads": threads,
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
    b, sq, h, d = q.shape
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    aligned = rows_aligned(q, k, v, out)
    design = mma_design(d, aligned, sq, k.shape[1]) if route == "mma" else None
    launch(q, k, v, out, design)
    flash_attention.launches += 1
    flash_attention.launches_by_route[route] += 1
    if design is not None:
        flash_attention.launches_by_design[design] += 1
    return out


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
           design: Optional[str]) -> None:
    """Launches kernel #1 into ``out`` on checked CUDA operands: the FMA
    kernel for f32 / f16 (``design`` None), else the tensor-core ``design``.
    :func:`flash_attention` passes :func:`mma_design`'s choice;
    ``chip_smoke.py`` times design A beside it at the widths H takes, the
    measurement behind ``H_WIDTHS``.  Raises where the design does not take
    the call.  Counts nothing."""
    b, sq, h, d = q.shape
    aligned = rows_aligned(q, k, v, out)
    vec = staging(kernel_route(q.dtype), d, aligned) == "cp.async"
    _nvcc.call(
        build().consolver_flash_attention_forward, "flash_attention", q.device,
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, sq, k.shape[1], d, int(vec), _DESIGN_CODES.get(design, 0),
        *_nvcc.bshd_strides(q, k, v, out), 1.0 / (d**0.5),
    )


def reset_counts() -> None:
    """Sets the wrapper's launch counts to 0."""
    flash_attention.launches = 0
    flash_attention.launches_by_route = {"mma": 0, "fma": 0}
    flash_attention.launches_by_design = {"A": 0, "B": 0, "H": 0}


reset_counts()
