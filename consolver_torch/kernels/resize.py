"""The edit's reference image on the card: the imaging library's 8-bit
Lanczos resize with the short side scaled to ``size``, its centre
``size x size`` crop, as float32 in [-1, 1], by a CUDA kernel written by hand
in ``consolver_torch/csrc/resize.cu``.

The dataset path (``data/edit_prep.py::center_crop_resize``, then
``* 2 - 1``) resizes the whole image in numpy and throws most of the long
side away; the kernel computes the crop window alone, with the host's
fixed-point tables for the window's outputs (``utils/resize.py::_coefficients``)
and the host's integer arithmetic, so its output is bit-equal to the dataset
path's.  :func:`crop_resize_plain` is the kernel's arithmetic in numpy, the
plain version beside it.  The library is compiled with ``nvcc`` at its first
launch; importing this module builds nothing.

:func:`reference_into` is the serving engines' route: a CUDA output takes
the kernel, a CPU output :func:`crop_resize_plain`.  ``launches_by_route``
counts the references resized by each route (``"card"``, ``"host"``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from consolver_torch.kernels import _nvcc
from consolver_torch.utils.resize import _coefficients, apply_taps

_SOURCE = _nvcc.CSRC / "resize.cu"

_library = None
launches_by_route = {"card": 0, "host": 0}


def build() -> ctypes.CDLL:
    """Compile the kernel (once per source version) and load it.  Raises if
    the build fails; nothing falls back to the host."""
    global _library
    if _library is not None:
        return _library
    lib = _nvcc.build_library(_SOURCE)
    fn = lib.consolver_resize_center_crop
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
        + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    )
    _library = lib
    return lib


def _upload(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """``array`` on ``device``, copied from pinned memory on the current
    stream: the host neither waits for the work queued before the copy nor
    for the copy (the pinned block is not reused until the copy is done)."""
    pinned = torch.from_numpy(np.ascontiguousarray(array)).pin_memory()
    return pinned.to(device, non_blocking=True)


def crop_window(height: int, width: int, size: int) -> Tuple[int, int, int, int]:
    """The resized width and height and the crop's left and top, with the
    expressions of ``data/edit_prep.py::center_crop_resize``."""
    scale = size / min(width, height)
    w, h = round(width * scale), round(height * scale)
    return w, h, (w - size) // 2, (h - size) // 2


@functools.lru_cache(maxsize=256)
def window_tables(in_size: int, out_size: int, offset: int, size: int):
    """The fixed-point tables of outputs ``offset .. offset + size - 1`` of a
    Lanczos resample from ``in_size`` to ``out_size``: first input index
    ``[size]`` and weights ``[size, taps]``, int32 (read-only, cached)."""
    first, weights = _coefficients(in_size, out_size, "lanczos", offset, offset + size)
    first, weights = first.astype(np.int32), weights.astype(np.int32)
    first.flags.writeable = weights.flags.writeable = False
    return first, weights


@functools.lru_cache(maxsize=256)
def _tables_on(device: torch.device, in_size: int, out_size: int, offset: int, size: int):
    """:func:`window_tables` on ``device``, uploaded at their first use and
    kept there (the 256 latest; a table dropped while a launch still reads
    it is freed in stream order)."""
    return tuple(_upload(np.array(t), device)  # a writable copy
                 for t in window_tables(in_size, out_size, offset, size))


def crop_resize_plain(image: np.ndarray, size: int) -> np.ndarray:
    """The kernel's passes in numpy: ``[H, W, C]`` uint8 -> the ``[size,
    size, C]`` uint8 crop, computed on the crop window alone.  Equal to the
    whole resize followed by the crop."""
    h, w = image.shape[:2]
    width, height, left, top = crop_window(h, w, size)
    img = (apply_taps(image, *window_tables(w, width, left, size), axis=1) if width != w
           else image[:, left:left + size])
    return (apply_taps(img, *window_tables(h, height, top, size), axis=0) if height != h
            else img[top:top + size])


def check_source(src: torch.Tensor) -> None:
    """Raises unless the kernel takes ``src``: a contiguous ``[H, W, 3]``
    uint8 tensor on a CUDA device."""
    if src.device.type != "cuda":
        raise RuntimeError(f"the resize kernel runs on cuda, not {src.device}")
    if src.dtype != torch.uint8:
        raise TypeError(f"the resize kernel takes uint8, got {src.dtype}")
    if src.ndim != 3 or src.shape[2] != 3 or src.shape[0] < 1 or src.shape[1] < 1:
        raise ValueError(f"the resize kernel takes [H, W, 3], got {tuple(src.shape)}")
    if not src.is_contiguous():
        raise ValueError("the resize kernel needs a contiguous source")


def center_crop_resize(src: torch.Tensor, size: int,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[H, W, 3]`` uint8 on a CUDA device -> ``[size, size, 3]`` float32 in
    [-1, 1] (into ``out`` if given: contiguous float32 on ``src``'s
    device), launched on the current stream.  Raises for what the kernel
    does not take."""
    check_source(src)
    size = int(size)
    if size < 1:
        raise ValueError(f"size must be positive, got {size}")
    if out is None:
        out = torch.empty((size, size, 3), dtype=torch.float32, device=src.device)
    elif (out.shape != (size, size, 3) or out.dtype != torch.float32
          or out.device != src.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous [{size}, {size}, 3] float32 tensor on "
                         f"{src.device}, got {tuple(out.shape)} {out.dtype} on {out.device}")
    h, w = src.shape[:2]
    width, height, left, top = crop_window(h, w, size)
    cols = _tables_on(src.device, w, width, left, size) if width != w else None
    rows = _tables_on(src.device, h, height, top, size) if height != h else None
    scratch = (torch.empty((h, size, 3), dtype=torch.uint8, device=src.device)
               if cols is not None else None)

    def pointers(tables):
        return (None, None, 0) if tables is None else (
            tables[0].data_ptr(), tables[1].data_ptr(), tables[1].shape[1])

    _nvcc.call(
        build().consolver_resize_center_crop, "resize", src.device,
        src.data_ptr(), h, w, None if scratch is None else scratch.data_ptr(),
        *pointers(cols), left, *pointers(rows), top, size, out.data_ptr(),
    )
    launches_by_route["card"] += 1
    return out


def reference_into(image: np.ndarray, size: int, out: torch.Tensor) -> torch.Tensor:
    """One edit's reference (``[H, W, 3]`` uint8, or float cast to uint8 as
    the dataset path casts it) into ``out``, ``[size, size, 3]`` float32 in
    [-1, 1]: uploaded and resized by the kernel where ``out`` is on a CUDA
    device, by :func:`crop_resize_plain` on the CPU."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = img.astype(np.uint8)
    if out.device.type == "cuda":
        return center_crop_resize(_upload(img, out.device), size, out=out)
    crop = np.asarray(crop_resize_plain(img, size), np.float32) / 255.0
    out.copy_(torch.from_numpy(crop * 2.0 - 1.0))
    launches_by_route["host"] += 1
    return out


def reset_counts() -> None:
    """Sets the route counts to 0."""
    launches_by_route.update(card=0, host=0)
