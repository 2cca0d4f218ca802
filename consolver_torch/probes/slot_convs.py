"""Probe: which convolutions of the SD-1.5 UNet give a row bits that depend
on the row's batch slot, and what a slot-invariant route costs.

    python -m consolver_torch.probes.slot_convs            # on the card
    python -m consolver_torch.probes.slot_convs --device cpu --tiny

One CFG-batched UNet forward (batch 8 under CFG: 16 rows, 512^2) and one
VAE decode of batch 8 record every ``Conv2d``'s input shape.  Each distinct
convolution then runs on a batch whose rows are all one random input: a
convolution whose output rows are not all equal reduces some slots in
another order than others.  Each is timed four ways: batched (the library's
choice), one sample at a time, batched with cuDNN switched off (ATen's own
im2col + GEMM, one sample at a time), and the port's slot-invariant route
(``layers.slot_invariant_conv``: one im2col, one GEMM per sample).  One JSON
line per convolution, then a summary per model.  On the card the times
come from CUDA events; on the CPU from the host clock (CPU times, not card
times).
"""

from __future__ import annotations

import argparse
import json
import time

import torch
import torch.nn.functional as F
from torch import nn

from consolver_torch.models.layers import slot_invariant_conv
from consolver_torch.models.unet_2d import UNet2DCondition, UNetConfig
from consolver_torch.models.vae import AutoencoderKL, VaeConfig


def _time_ms(fn, device, iters, warmup=2):
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


def conv_shapes(model: nn.Module, run):
    """(name, conv, input shape) of every ``Conv2d`` that ``run()`` calls."""
    seen = []
    hooks = [m.register_forward_pre_hook(lambda mod, args, name=name: seen.append(
        (name, mod, tuple(args[0].shape))))
        for name, m in model.named_modules() if isinstance(m, nn.Conv2d)]
    try:
        with torch.inference_mode():
            run()
    finally:
        for h in hooks:
            h.remove()
    return seen


def slots_differing(conv: nn.Conv2d, x_row: torch.Tensor, rows: int):
    """Slots whose output differs from slot 0's when every row is ``x_row``."""
    out = conv(x_row.expand(rows, *x_row.shape[1:]).contiguous())
    return [r for r in range(1, rows) if not torch.equal(out[r], out[0])]


def _filled(model, gen):
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.02, generator=gen)
    return model


def run(device: str, rows: int, latent: int, tiny: bool, iters: int, seed: int, log=print):
    device = torch.device(device)
    torch.manual_seed(seed)
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(seed)
    unet = _filled(UNet2DCondition(UNetConfig.tiny() if tiny else UNetConfig.sd15(),
                                   device=device, dtype=dtype), gen)
    vae = _filled(AutoencoderKL(VaeConfig.tiny() if tiny else VaeConfig.sd15(),
                                device=device, dtype=dtype), gen)
    ucfg = unet.cfg
    models = {
        "unet": conv_shapes(unet, lambda: unet(
            torch.randn((rows, latent, latent, ucfg.in_channels), device=device),
            torch.full((rows,), 500, device=device),
            torch.randn((rows, 77, ucfg.cross_attention_dim), device=device))),
        "vae_decode": conv_shapes(vae, lambda: vae.decode(
            torch.randn((rows // 2, latent, latent, vae.cfg.latent_channels), device=device))),
    }
    results, summary = [], {"device": torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu",
                            "rows": rows, "latent": latent, "dtype": str(dtype).replace("torch.", "")}
    for model, seen in models.items():
        rows_m = seen[0][2][0]
        found = _probe_convs(seen, rows_m, device, dtype, gen, iters, log)
        results += found
        summary[model] = _summary(found, rows_m)
    log(json.dumps({"summary": summary}))
    return results, summary


def _probe_convs(seen, rows, device, dtype, gen, iters, log):
    by_key = {}
    for name, conv, shape in seen:
        key = (conv.in_channels, conv.out_channels, conv.kernel_size, conv.stride, conv.padding,
               shape[2], shape[3])
        by_key.setdefault(key, [conv, shape, []])[2].append(name)
    results = []
    with torch.inference_mode():
        for (cin, cout, k, stride, pad, h, w), (conv, shape, names) in by_key.items():
            x_row = torch.randn((1, cin, h, w), device=device, generator=gen).to(dtype)
            x = torch.randn(shape, device=device, generator=gen).to(dtype)
            differ = slots_differing(conv, x_row, rows)
            with torch.backends.cudnn.flags(enabled=False):
                differ_off = slots_differing(conv, x_row, rows)
            route = lambda x: slot_invariant_conv(conv, x)  # noqa: E731
            row = {
                "in": cin, "out": cout, "k": k[0], "stride": stride[0], "hw": [h, w],
                "rows": shape[0], "uses": len(names), "names": names[:3],
                "slots_differing": differ, "slots_differing_cudnn_off": differ_off,
                "slots_differing_route": slots_differing(route, x_row, rows),
                "batched_ms": _time_ms(lambda: conv(x), device, iters),
                "per_sample_ms": _time_ms(lambda: torch.cat([conv(r) for r in x.split(1)]),
                                          device, iters),
                "route_ms": _time_ms(lambda: route(x), device, iters),
            }
            with torch.backends.cudnn.flags(enabled=False):
                row["cudnn_off_ms"] = _time_ms(lambda: F.conv2d(x, conv.weight, conv.bias,
                                                                conv.stride, conv.padding),
                                               device, iters)
            log(json.dumps({"conv": row}))
            results.append(row)
    return results


def _summary(results, rows):
    """Per forward: the convolutions and their ms by route, grouped by
    whether the batched one is slot-dependent."""
    totals = {}
    for r in results:
        group = "slot_dependent" if r["slots_differing"] else "slot_invariant"
        t = totals.setdefault(group, {"convs": 0, "uses": 0, "batched_ms": 0.0,
                                      "per_sample_ms": 0.0, "cudnn_off_ms": 0.0, "route_ms": 0.0})
        t["convs"] += 1
        t["uses"] += r["uses"]
        for key in ("batched_ms", "per_sample_ms", "cudnn_off_ms", "route_ms"):
            t[key] += r[key] * r["uses"]
    return {
        "rows": rows, "per_forward": totals,
        "slot_dependent": sorted({(r["in"], r["k"], r["stride"], r["hw"][0]) for r in results
                                  if r["slots_differing"]}),
        "route_slot_dependent": sorted({(r["in"], r["k"], r["stride"], r["hw"][0])
                                        for r in results if r["slots_differing_route"]}),
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--tiny", action="store_true", help="tiny UNet, small shapes")
    parser.add_argument("--rows", type=int, default=16, help="UNet batch (2x the batch under CFG)")
    parser.add_argument("--latent", type=int, default=64)
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu --tiny for the plain CPU run")
    run(args.device, args.rows, 8 if args.tiny else args.latent, args.tiny, args.iters, args.seed)


if __name__ == "__main__":
    main()
