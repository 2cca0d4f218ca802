"""Probe: the SD-1.5 UNet's forward, eager against its CUDA graph
(``models/graphs.py``), at the serving engine's row counts.

    python -m consolver_torch.probes.unet_graphs          # on the card only
    python -m consolver_torch.probes.unet_graphs --int8   # the hybrid int8 UNet

The UNet has the published widths, bf16 weights 0.02 * N(0, 1) from the
seed (norm scales 1 + 0.02 * N(0, 1)), 512^2 latents and a 77-token
context.  One JSON line per row count (2: a lone preview under CFG; 16: a
batch of 8), each number from the card:

- ``eager_device_ms`` / ``graph_device_ms``: CUDA events around ``iters``
  back-to-back calls, over the count: the card's time of one forward;
- ``eager_enqueue_ms`` / ``graph_enqueue_ms``: the host clock over the same
  calls before the closing synchronise, over the count: the host's time to
  enqueue one forward;
- ``eager_alone_ms`` / ``graph_alone_ms``: one call then a synchronise, on
  the host clock, the median of ``iters``: what a step that waits for the
  UNet sees;
- ``eager_launches`` / ``graph_launches``: runtime launch calls of one call
  (``cudaLaunchKernel*`` / ``cuLaunchKernel*`` / ``cudaGraphLaunch``) in a
  ``torch.profiler`` trace; ``flash_attention`` launches counted by the
  wrapper in one call, eager and replayed;
- ``graph_kernels`` / ``graph_top``: the device operations of one replay,
  counted, and the heaviest by device time (ms), from the same trace;
- ``bit_equal``: the replay's output against the eager forward's;
- ``graph_bytes`` / ``pool_bytes``: device memory the capture added, held
  by tensors (the static buffers) and reserved (with the graphs' pool),
  from ``torch.cuda.memory_allocated`` / ``memory_reserved``.

``--int8`` measures the UNet ``TextToImagePipeline.quantize()`` serves
(W8A8 int8 below level 0).  The first line names the card and its power
limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import time

import torch

from consolver_torch.kernels import flash_attention as fa
from consolver_torch.kernels.quant import quantize_like
from consolver_torch.models.unet_2d import UNet2DCondition, UNetConfig

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch")


def fill_(unet: UNet2DCondition, seed: int) -> UNet2DCondition:
    """0.02 * N(0, 1) weights; norm scales 1 + 0.02 * N(0, 1)."""
    g = torch.Generator(unet.conv_in.weight.device).manual_seed(seed)
    with torch.no_grad():
        for name, p in unet.named_parameters():
            p.normal_(0.0, 0.02, generator=g)
            if "norm" in name and name.endswith("weight"):
                p.add_(1.0)
    return unet


def inputs(rows: int, device, seed: int, latent: int = 64):
    g = torch.Generator(device).manual_seed(seed)
    return (torch.randn((rows, latent, latent, 4), device=device, generator=g),
            torch.full((rows,), 501, dtype=torch.int64, device=device),
            torch.randn((rows, 77, 768), device=device, generator=g).to(torch.bfloat16))


def _device_and_enqueue_ms(fn, iters: int):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, enqueue


def _alone_ms(fn, iters: int) -> float:
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _trace(fn):
    """(runtime launch calls, device operations, the heaviest six by device
    ms) of one call of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    ops = [e for e in events if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]  # the spans' ranges
    top = sorted(ops, key=lambda e: -e.self_device_time_total)[:6]
    return (sum(e.count for e in events if e.key.startswith(LAUNCH_CALLS)),
            sum(e.count for e in ops),
            [[e.key[:80], e.count, e.self_device_time_total / 1e3] for e in top])


def _flash_launches(fn) -> int:
    before = fa.flash_attention.launches
    fn()
    return fa.flash_attention.launches - before


def probe(unet: UNet2DCondition, rows: int, iters: int, seed: int) -> dict:
    x = inputs(rows, unet.conv_in.weight.device, seed)
    eager = lambda: unet._forward_eager(*x)  # noqa: E731
    graph = lambda: unet(*x)  # noqa: E731
    out = {"rows": rows}
    with torch.inference_mode():
        want = eager()
        out["eager_device_ms"], out["eager_enqueue_ms"] = _device_and_enqueue_ms(eager, iters)
        out["eager_alone_ms"] = _alone_ms(eager, iters)
        out["eager_launches"], out["eager_kernels"], _ = _trace(eager)
        out["eager_flash_launches"] = _flash_launches(eager)
        unet.cuda_graphs.enabled = True
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        allocated, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        graph()  # warm-up and capture
        torch.cuda.synchronize()
        out["capture_s"] = time.perf_counter() - t0
        out["graph_bytes"] = torch.cuda.memory_allocated() - allocated
        out["pool_bytes"] = torch.cuda.memory_reserved() - reserved
        out["captured"] = list(unet.cuda_graphs.signatures.values())
        out["bit_equal"] = bool(torch.equal(graph(), want))
        out["graph_device_ms"], out["graph_enqueue_ms"] = _device_and_enqueue_ms(graph, iters)
        out["graph_alone_ms"] = _alone_ms(graph, iters)
        out["graph_launches"], out["graph_kernels"], out["graph_top"] = _trace(graph)
        out["graph_flash_launches"] = _flash_launches(graph)
        unet.cuda_graphs.enabled = False
    return out


def _power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rows", type=int, nargs="+", default=[2, 16])
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--int8", action="store_true", help="the hybrid int8 UNet")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the probe measures the card: no CUDA device")
    device = torch.device("cuda")
    fa.build()
    print(json.dumps({"device": torch.cuda.get_device_name(device), "nvidia_smi": _power_limit(),
                      "torch": torch.__version__}), flush=True)
    unet = UNet2DCondition(UNetConfig.sd15(), device="meta", dtype=torch.bfloat16)
    unet = fill_(unet.to_empty(device=device), args.seed)
    if args.int8:
        cfg = dataclasses.replace(unet.cfg, quant_int8=True, quant_skip_levels=(0,))
        unet = quantize_like(UNet2DCondition(cfg, device="meta"), unet)
    for rows in args.rows:
        print(json.dumps(probe(unet, rows, args.iters, args.seed)), flush=True)


if __name__ == "__main__":
    main()
