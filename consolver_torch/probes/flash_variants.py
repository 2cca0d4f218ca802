"""Probe of the flash-attention variants at the FLUX-Kontext attention shapes.

    python -m consolver_torch.probes.flash_variants            # on the card
    python -m consolver_torch.probes.flash_variants --device cpu --tiny

Port of ``scripts/probe_flash_variants.py`` (``main`` and ``main2``).  Three
parts, each printed as it runs:

1. accuracy: the mean relative error of :func:`flash_bf16` and
   :func:`flash_int8` against the shipped kernel (:func:`flash_attention`,
   f32 products) on the same bf16 inputs, at the training shape;
2. times of the shipped kernel and the two variants at the serving shape
   ``(1, 8704, 24, 128)`` (one 1024^2 Kontext edit) and the training shape
   ``(8, 2560, 24, 128)`` (batch 8 at 512^2), with the achieved TFLOP/s;
3. :func:`flash_nomask` over the block pairs of the JAX sweep that divide
   the serving length: of (512, 512), (1024, 512), (512, 1024), (256, 512)
   only (512, 512) and (256, 512) divide 8704.

On the card, times come from CUDA events around ``iters`` launches after a
warm-up.  ``--device cpu --tiny`` runs the plain versions at small shapes
and times them on the host clock (CPU times, not card times).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict

import torch

from consolver_torch.kernels.flash_attention import flash_attention
from consolver_torch.kernels.flash_variants import flash_bf16, flash_int8, flash_nomask

SHAPES = {"serve 1024^2 kontext": (1, 8704, 24, 128), "train 512^2 b8": (8, 2560, 24, 128)}
TINY_SHAPES = {"serve tiny": (1, 512, 2, 128), "train tiny": (2, 256, 2, 128)}
BLOCK_PAIRS = [(512, 512), (1024, 512), (512, 1024), (256, 512)]
VARIANTS = [("f32dot (shipped)", flash_attention), ("bf16dot", flash_bf16), ("int8", flash_int8)]


def _inputs(shape, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
                 for _ in range(3))


def time_ms(fn: Callable[[], torch.Tensor], device: torch.device, iters: int, warmup: int = 1) -> float:
    """Mean ms per call: CUDA events on the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def _rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    ref = ref.float()
    return ((out.float() - ref).abs().mean() / ref.abs().mean()).item()


def run(device="cuda", shapes: Dict[str, tuple] = SHAPES, iters: int = 10, seed: int = 0,
        log: Callable[[str], None] = print) -> dict:
    """Runs the three parts; returns their numbers as a dict."""
    device = torch.device(device)
    result = {"device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
              "accuracy": {}, "timing": {}, "nomask_sweep": {}}
    train_name, train_shape = list(shapes.items())[-1]
    q, k, v = _inputs(train_shape, seed, device)
    ref = flash_attention(q, k, v)
    for name, fn in VARIANTS[1:]:
        err = _rel_err(fn(q, k, v), ref)
        result["accuracy"][name] = err
        log(f"accuracy {name} at {train_name}: mean-rel-err vs f32dot = {err:.4e}")
    del q, k, v, ref

    for sname, (b, s, h, d) in shapes.items():
        q, k, v = _inputs((b, s, h, d), seed + 3, device)
        gflop = 4 * b * h * s * s * d / 1e9
        for name, fn in VARIANTS:
            ms = time_ms(lambda: fn(q, k, v), device, iters)
            result["timing"][f"{sname} | {name}"] = {"ms": ms, "tflops": gflop / ms}
            log(f"{sname}: {name:18s} {ms:9.3f} ms  {gflop / ms:7.2f} TF/s")
        del q, k, v

    sname, (b, s, h, d) = next(iter(shapes.items()))
    q, k, v = _inputs((b, s, h, d), seed + 3, device)
    gflop = 4 * b * h * s * s * d / 1e9
    ref = flash_attention(q, k, v)
    for bq, bk in BLOCK_PAIRS:
        if s % bq or s % bk:
            continue
        fn = lambda: flash_nomask(q, k, v, block_q=bq, block_k=bk)  # noqa: E731
        err = _rel_err(fn(), ref)
        ms = time_ms(fn, device, iters)
        result["nomask_sweep"][f"bq{bq}/bk{bk}"] = {"ms": ms, "tflops": gflop / ms, "relerr": err}
        log(f"{sname} nomask bq{bq}/bk{bk}: {ms:9.3f} ms  {gflop / ms:7.2f} TF/s  relerr {err:.2e}")
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    parser.add_argument("--tiny", action="store_true", help="small shapes (for the CPU)")
    args = parser.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        parser.error("no CUDA device; pass --device cpu --tiny for the plain versions")
    print(json.dumps(run(args.device, TINY_SHAPES if args.tiny else SHAPES)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
