"""Builds a CUDA source of ``consolver_torch/csrc/`` into a shared library
with a plain C interface, loads it with ``ctypes`` and calls its entry
points on the current CUDA stream.

``nvcc`` compiles for ``sm_90a`` into ``consolver_torch/kernels/_build/``
(gitignored), once per content of the source and the shared headers (the
file name carries their hash), and writes ptxas' register / shared-memory /
spill report beside the library.  Nothing here runs at import time.  Two
builds of different sources may run at once from two threads: each is its
own ``nvcc`` process.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(source: Path) -> Path:
    """Where the build of ``source``'s current content, with the headers
    beside it, lands."""
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{source.stem}_{digest.hexdigest()[:16]}.so"


def build_library(source: Path) -> ctypes.CDLL:
    """Compile ``source`` unless this content was built already, and load
    it.  Raises if the build fails; nothing falls back."""
    out = library_path(source)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [
            nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", str(tmp), str(source),
        ]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {source.name}:\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        out.with_suffix(".ptxas.txt").write_text(proc.stderr)
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))


def bshd_strides(*tensors: torch.Tensor) -> list:
    """The (batch, sequence, head) element strides of each ``[B, S, H, D]``
    tensor, in order, as the C interfaces take them."""
    return [s for t in tensors for s in t.stride()[:3]]


def call(entry, name: str, device: torch.device, *args) -> None:
    """Calls a library entry point with ``device``'s current stream as its
    last argument; raises on a non-zero return code."""
    with torch.cuda.device(device):
        rc = entry(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed (code {rc})")
