#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``consolver_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository around this file; it exits
non-zero, printing nothing on stdout, without them.  Phases:

1. Build the hand-written flash-attention kernel from
   ``consolver_torch/csrc/flash_attention.cu``; print the card's name and
   power limit (``nvidia-smi``).
2. Hold the kernel against its plain PyTorch version at every attention
   shape of the SD-1.5 preview path (batch 8, so 16 rows under CFG), plus
   Sq != Sk, a ragged length and large scores, in bf16 and f32; time the
   kernel, its plain version and ``scaled_dot_product_attention`` (as a
   yardstick only), beside the least time the card could take.
3. Drive the port's main path at full SD-1.5 width through
   ``TextToImagePipeline``: random-normal x0.02 bf16 weights from a seeded
   generator, 8 prompts, 512x512, 8 steps, CFG 3.  Check the images and that
   the kernel ran exactly 8 x 32 + 1 = 257 times; print img/s, peak memory
   and the kernel's share of device time from ``torch.profiler``.
4. Run the tiny stack in f32 on the card (the kernel) and on the CPU (the
   plain versions), TF32 off, and compare latents, images and actions, for
   the per-count and the padded programs.

The line before the last is a JSON object listing each kernel (launches on
the main path, worst error, times per generation); the last line is
``{"ok": true, "device": {...}}``.  Any failed check raises.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0

BF16_TFLOPS = 989.0  # H100 SXM dense peaks (NVIDIA data sheet)
F32_TFLOPS = 67.0  # float32 outside the tensor cores
HBM_TBPS = 3.35

# Kernel vs its plain version in f32 on the same inputs, held at every
# element: |out - ref| <= rtol * |ref| + atol.  The kernel computes in f32
# and rounds once to the output type, so a bf16 output may be off by half a
# bf16 ulp (2^-8 of |ref|); the limit allows one ulp.  atol covers the f32
# summation order (f32 runs differ by a few 1e-6).
F32_RTOL, F32_ATOL = 0.0, 1e-4
BF16_RTOL, BF16_ATOL = 2.0**-7, 1e-5
SLICE_TOL = 5e-4  # f32 tiny stack, card vs CPU through 3 CFG-3 steps

BATCH = 8
STEPS = 8
CFG = 3.0
PROMPTS = [
    "a red fox in the snow", "an astronaut riding a horse", "a bowl of ramen",
    "a lighthouse at dusk", "a watercolor of a city street", "a cat wearing a hat",
    "mountains above the clouds", "a robot reading a book",
]

# (name, q shape, Sk, launches per generation).  CFG doubles the UNet batch;
# per UNet forward each resolution level runs 5 Transformer2D blocks (2 down,
# 3 up), the mid block 1, each with one self- and one cross-attention.
MAIN_PATH_CASES = [
    ("unet_l0_self", (2 * BATCH, 4096, 8, 40), 4096, 5 * STEPS),
    ("unet_l0_cross", (2 * BATCH, 4096, 8, 40), 77, 5 * STEPS),
    ("unet_l1_self", (2 * BATCH, 1024, 8, 80), 1024, 5 * STEPS),
    ("unet_l1_cross", (2 * BATCH, 1024, 8, 80), 77, 5 * STEPS),
    ("unet_l2_self", (2 * BATCH, 256, 8, 160), 256, 5 * STEPS),
    ("unet_l2_cross", (2 * BATCH, 256, 8, 160), 77, 5 * STEPS),
    ("unet_mid_self", (2 * BATCH, 64, 8, 160), 64, STEPS),
    ("unet_mid_cross", (2 * BATCH, 64, 8, 160), 77, STEPS),
    ("vae_mid", (BATCH, 4096, 1, 512), 4096, 1),
]
EXTRA_CASES = [
    ("sq_ne_sk", (2, 256, 2, 128), 384, 0),
    ("ragged_200", (2, 200, 2, 128), 200, 0),
    ("large_scores", (1, 128, 1, 128), 128, 0),
]
LAUNCHES_PER_GENERATION = sum(c[3] for c in MAIN_PATH_CASES)


def _time_ms(fn, iters, warmup=1):
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _library_ms(q, k, v, iters):
    """Yardstick: one PyTorch call computing the same attention, in its own
    [B, H, S, D] layout (transposed outside the timed region)."""
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    return _time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), iters)


def _bound(q_shape, sk, dtype):
    import torch

    b, sq, h, d = q_shape
    itemsize = torch.finfo(dtype).bits // 8
    ops = 4.0 * b * h * sq * sk * d
    peak = BF16_TFLOPS if dtype == torch.bfloat16 else F32_TFLOPS
    op_ms = ops / (peak * 1e12) * 1e3
    byte_ms = (2 * b * sq * h * d + 2 * b * sk * h * d) * itemsize / (HBM_TBPS * 1e12) * 1e3
    return (op_ms, "operations") if op_ms >= byte_ms else (byte_ms, "bytes")


def phase_kernel(fa):
    """Kernel vs plain version at every case; returns per-case rows."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for dtype, rtol, atol in ((torch.bfloat16, BF16_RTOL, BF16_ATOL),
                              (torch.float32, F32_RTOL, F32_ATOL)):
        for name, q_shape, sk, per_gen in MAIN_PATH_CASES + EXTRA_CASES:
            b, sq, h, d = q_shape
            if name == "large_scores":
                q = torch.full(q_shape, 10.0, device="cuda", dtype=dtype)
                k = q.clone()
            else:
                q = torch.randn(q_shape, device="cuda", generator=gen).to(dtype)
                k = torch.randn((b, sk, h, d), device="cuda", generator=gen).to(dtype)
            v = torch.randn((b, sk, h, d), device="cuda", generator=gen).to(dtype)
            out = fa.flash_attention(q, k, v)
            torch.cuda.synchronize()
            ref = fa.flash_attention_reference(q.float(), k.float(), v.float())
            diff = (out.float() - ref).abs()
            err = diff.max().item()
            # worst element's error as a share of its limit; the case passes at <= 1
            over_limit = (diff / (rtol * ref.abs() + atol)).max().item()
            ref_max = ref.abs().max().item()
            del ref, diff
            finite = bool(torch.isfinite(out).all())
            heavy = b * h * sq * sk * d > 1e10
            row = {
                "case": name, "dtype": str(dtype).replace("torch.", ""), "q": list(q_shape),
                "sk": sk, "per_generation": per_gen, "max_abs_err": err, "max_abs_ref": ref_max,
                "rtol": rtol, "atol": atol, "err_over_limit": over_limit,
                "ms": _time_ms(lambda: fa.flash_attention(q, k, v), 5 if heavy else 20, warmup=2),
                "plain_ms": _time_ms(lambda: fa.flash_attention_reference(q, k, v), 2 if heavy else 5),
                "library_ms": _library_ms(q, k, v, 5 if heavy else 20),
            }
            row["bound_ms"], row["bound_by"] = _bound(q_shape, sk, dtype)
            print(json.dumps({"phase": "kernel", **row}), flush=True)
            if not finite or not over_limit <= 1.0:
                raise AssertionError(
                    f"flash_attention {name} {dtype}: max err {err}, {over_limit}x the limit "
                    f"{rtol} * |ref| + {atol}")
            rows.append(row)
            del q, k, v, out
    torch.cuda.empty_cache()
    return rows


def _random_fill_(module, gen, std=0.02):
    import torch

    with torch.no_grad():
        for p in module.parameters():
            p.normal_(0.0, std, generator=gen)
    return module


def phase_main_path(fa):
    """Full-width SD-1.5 preview: 8 prompts, 512^2, 8 steps, CFG 3, bf16."""
    import torch

    from consolver_torch.core.schedules import DiffusionSchedule
    from consolver_torch.data.tokenizer import HashTokenizer, tokenize_batch
    from consolver_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
    from consolver_torch.models.unet_2d import UNet2DCondition, UNetConfig
    from consolver_torch.models.vae import AutoencoderKL, VaeConfig
    from consolver_torch.pipelines.t2i import TextToImagePipeline
    from consolver_torch.policy.factor_net import FactorNet, FactorNetConfig

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    bf16 = torch.bfloat16
    unet = UNet2DCondition(UNetConfig.sd15(), device="meta", dtype=bf16).to_empty(device="cuda")
    text = ClipTextEncoder(ClipTextConfig.sd15(), device="meta", dtype=bf16).to_empty(device="cuda")
    vae = AutoencoderKL(VaeConfig.sd15(), device="meta", dtype=bf16).to_empty(device="cuda")
    for m in (unet, text, vae):
        _random_fill_(m, gen)
    policy = FactorNet(
        FactorNetConfig(order_dim=4, scaler_dim=0, num_actions=11, family="sd"), device="cuda"
    )
    pipe = TextToImagePipeline(unet, text, vae, DiffusionSchedule.sd15(), factor_net=policy,
                               tokenizer=HashTokenizer(), device="cuda")
    ids = tokenize_batch(HashTokenizer(), PROMPTS[:BATCH], 77)
    noise = torch.randn((BATCH, 64, 64, 4), device="cuda", generator=gen)

    def generate(seed):
        policy_gen = torch.Generator(device="cuda").manual_seed(seed)
        images, _ = pipe(policy_gen, ids, noise, num_inference_steps=STEPS,
                         guidance_scale=CFG, record=False)
        return images

    fa.flash_attention.launches = 0
    images = generate(SEED + 2)
    torch.cuda.synchronize()
    launches = fa.flash_attention.launches
    if tuple(images.shape) != (BATCH, 512, 512, 3):
        raise AssertionError(f"images {tuple(images.shape)}")
    if not bool(torch.isfinite(images).all()):
        raise AssertionError("non-finite images")
    lo, hi = images.min().item(), images.max().item()
    if lo < 0.0 or hi > 1.0:
        raise AssertionError(f"images outside [0, 1]: {lo} {hi}")
    if launches != LAUNCHES_PER_GENERATION:
        raise AssertionError(f"flash_attention launched {launches} times, want {LAUNCHES_PER_GENERATION}")

    generate(SEED + 3)  # warm-up after the first (autotuning) run
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs = 3
    run_s = []
    for i in range(runs):
        t0 = time.perf_counter()
        generate(SEED + 4 + i)
        torch.cuda.synchronize()
        run_s.append(time.perf_counter() - t0)
    elapsed = sum(run_s)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        generate(SEED + 10)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_us = kernel_us = 0.0
    by_name = {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.device_time_total if hasattr(evt, "device_time_total") else evt.cuda_time_total
        device_us += us
        if "flash_fwd_kernel" in evt.name:
            kernel_us += us
        by_name[evt.name[:80]] = by_name.get(evt.name[:80], 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    result = {
        "phase": "main_path", "batch": BATCH, "steps": STEPS, "cfg": CFG, "resolution": 512,
        "launches": launches, "img_per_s": BATCH * runs / elapsed,
        "s_per_generation": elapsed / runs, "run_s": run_s, "peak_mem_gib": peak_gib,
        "image_min": lo, "image_max": hi,
        "profiled_wall_ms": wall_ms, "device_busy_ms": device_us / 1e3,
        "flash_kernel_ms": kernel_us / 1e3,
        "flash_share_of_device_time": kernel_us / device_us if device_us else None,
        "device_idle_share": 1 - device_us / 1e3 / wall_ms if device_us else None,
        "top_device_ms": {name: us / 1e3 for name, us in top},
    }
    print(json.dumps(result), flush=True)
    del pipe, unet, text, vae, images
    torch.cuda.empty_cache()
    return result


def _tiny_pipeline(device, models):
    from consolver_torch.core.schedules import DiffusionSchedule
    from consolver_torch.pipelines.t2i import TextToImagePipeline

    unet, text, vae, policy = (copy.deepcopy(m).to(device) for m in models)
    return TextToImagePipeline(unet, text, vae, DiffusionSchedule.sd15(), factor_net=policy,
                               device=device)


def phase_tiny_slice(fa):
    """The tiny f32 stack on the card vs the CPU, TF32 off."""
    import numpy as np
    import torch

    from consolver_torch.data.tokenizer import HashTokenizer, tokenize_batch
    from consolver_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
    from consolver_torch.models.unet_2d import UNet2DCondition, UNetConfig
    from consolver_torch.models.vae import AutoencoderKL, VaeConfig
    from consolver_torch.policy.factor_net import FactorNet, FactorNetConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED + 20)
    models = [
        _random_fill_(UNet2DCondition(UNetConfig.tiny(), device="cpu"), gen, 0.1),
        _random_fill_(ClipTextEncoder(ClipTextConfig.tiny(), device="cpu"), gen, 0.1),
        _random_fill_(AutoencoderKL(VaeConfig.tiny(), device="cpu"), gen, 0.1),
        _random_fill_(FactorNet(FactorNetConfig(order_dim=3, scaler_dim=2, num_actions=11,
                                                use_conv=True), device="cpu"), gen, 0.3),
    ]
    cpu, gpu = _tiny_pipeline("cpu", models), _tiny_pipeline("cuda", models)
    ids = tokenize_batch(HashTokenizer(), PROMPTS[:2], 77, vocab_size=1000)
    noise = torch.randn((2, 8, 8, 4), generator=gen)
    out = {"phase": "tiny_slice"}
    for program, kwargs in (("per_count", {}), ("padded", {"padded_max_steps": 5})):
        before = fa.flash_attention.launches
        results = {}
        for name, pipe in (("cpu", cpu), ("cuda", gpu)):
            with torch.inference_mode():
                lat, traj = pipe(None, ids, noise, num_inference_steps=3, guidance_scale=CFG,
                                 deterministic_policy=True, decode=False, **kwargs)
                img = pipe.decode_latents(lat)
            results[name] = (lat.cpu(), img.cpu(), traj.actions.cpu())
        if fa.flash_attention.launches == before:
            raise AssertionError("the card's tiny run did not launch the kernel")
        lat_err = (results["cpu"][0] - results["cuda"][0]).abs().max().item()
        img_err = (results["cpu"][1] - results["cuda"][1]).abs().max().item()
        same_actions = torch.equal(results["cpu"][2], results["cuda"][2])
        out[program] = {"latent_max_abs_err": lat_err, "image_max_abs_err": img_err,
                        "actions_equal": same_actions}
        if not (lat_err <= SLICE_TOL and img_err <= SLICE_TOL and same_actions):
            raise AssertionError(f"tiny slice {program}: card vs cpu {out[program]}")
        if not np.isfinite(results["cuda"][0].numpy()).all():
            raise AssertionError("non-finite tiny latents")
    out["tol"] = SLICE_TOL
    print(json.dumps(out), flush=True)
    return out


def main() -> int:
    if not (ROOT / "consolver_torch" / "csrc" / "flash_attention.cu").exists():
        print("chip_smoke.py needs the repository around it (consolver_torch/)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from consolver_torch.kernels import flash_attention as fa

    torch.manual_seed(SEED)  # the policy's default-initialised hidden layers

    t0 = time.perf_counter()
    fa.build()
    build_s = time.perf_counter() - t0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    print(json.dumps({"phase": "build", "kernel": "flash_attention", "build_s": build_s,
                      "torch": torch.__version__, "cuda": torch.version.cuda}), flush=True)

    with torch.inference_mode():
        rows = phase_kernel(fa)
    main_path = phase_main_path(fa)
    phase_tiny_slice(fa)

    per_gen = [r for r in rows if r["dtype"] == "bfloat16" and r["per_generation"]]
    total = {key: sum(r[key] * r["per_generation"] for r in per_gen)
             for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
    ops_ms = sum(r["bound_ms"] * r["per_generation"] for r in per_gen if r["bound_by"] == "operations")
    kernels = {"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "consolver_torch/csrc/flash_attention.cu",
        "replaces": "consolver_tpu/kernels/flash_attention.py:67",
        "launches": main_path["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        # times per generation: each main-path shape timed alone, times its
        # launches in one generation (batch 8, 8 steps, CFG, VAE decode)
        "ms": total["ms"],
        "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": "operations" if ops_ms >= total["bound_ms"] / 2 else "bytes",
        "library_ms": total["library_ms"],
    }]}
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
