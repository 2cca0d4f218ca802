"""Probe: which layer of SD-1.5's deterministic program gives a row bits
that depend on the batch size it runs at.

    python -m consolver_torch.probes.dp_shapes              # on the card
    python -m consolver_torch.probes.dp_shapes --device cpu --tiny

A data-parallel engine over ``dp`` ranks runs ``max / dp`` rows per rank,
where one process runs ``max`` rows, so a deterministic request's program
differs in its batch size alone.  The probe runs the engine's deterministic
program (``TextToImagePipeline.__call__(..., deterministic_policy=True)``:
mode actions, slot-invariant UNet convolutions below level 0) on 8 rows and
holds each layer against the same layer on 4 of those rows: while the
8-row run goes, every call of a ``Conv2d``, ``Linear``, ``GroupNorm``,
``LayerNorm`` module and of the functional routes (kernel #1 through
``attention_op``, the per-sample convolution ``slot_invariant_conv``, the
f32 ``conv_f32`` / ``group_norm_f32`` / ``layer_norm_f32``) is called again on its input's rows of
the 4-row run (under CFG the UNet's rows ``0-3`` and ``8-11`` of 16) and
the two outputs compared.  The first call in program order whose outputs
differ is the first layer of the 4-row run that would differ, since every
earlier layer gave both runs the same bits.  Then both whole programs run
and their uint8 images are compared.

One JSON line per differing route kind (calls, calls differing, the first
differing call with its share of differing elements and largest |diff|),
then the summary: the first differing call in program order and the whole
programs' uint8 gap.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np
import torch
from torch import nn

from consolver_torch.core.schedules import DiffusionSchedule
from consolver_torch.data.tokenizer import HashTokenizer, tokenize_batch
from consolver_torch.models import clip_text, layers, unet_2d
from consolver_torch.models import vae as vae_lib
from consolver_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
from consolver_torch.models.unet_2d import UNet2DCondition, UNetConfig
from consolver_torch.models.vae import AutoencoderKL, VaeConfig
from consolver_torch.pipelines.t2i import TextToImagePipeline
from consolver_torch.policy.factor_net import FactorNet, FactorNetConfig

PROMPTS = [
    "a red fox in the snow", "an astronaut riding a horse", "a bowl of ramen",
    "a lighthouse at dusk", "a watercolor of a city street", "a cat wearing a hat",
    "mountains above the clouds", "a robot reading a book",
]
HOOKED = (nn.Conv2d, nn.Linear, nn.GroupNorm, nn.LayerNorm)
# the functional routes the models call by name, in every module that imports one
PATCHED = ("attention_op", "slot_invariant_conv", "conv_f32", "group_norm_f32", "layer_norm_f32")
PATCHED_MODULES = (layers, unet_2d, vae_lib, clip_text)


def _filled(model, gen):
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.02, generator=gen)
    return model


def _sub_rows(n: int, full: int, part: int):
    """The rows of an ``n``-row input that the ``part``-row run holds, when
    the full run has ``full`` rows: the first ``part`` of ``full``, or of
    each CFG half of ``2 full``; None for another leading size."""
    if n == full:
        return list(range(part))
    if n == 2 * full:
        return list(range(part)) + list(range(full, full + part))
    return None


def _take(value, rows):
    if torch.is_tensor(value) and value.dim() > 0:
        return value[rows]
    return value


class _Compare:
    """Holds every hooked call of the full run against the same call on the
    part run's rows of its input."""

    def __init__(self, full: int, part: int):
        self.full, self.part = full, part
        self.calls = []
        self.busy = False

    def check(self, kind: str, name: str, fn, args, kwargs, out):
        if self.busy or not torch.is_tensor(out) or not args or not torch.is_tensor(args[0]):
            return
        rows = _sub_rows(args[0].shape[0], self.full, self.part)
        if rows is None or out.shape[0] != args[0].shape[0]:
            self.calls.append({"kind": kind, "name": name, "unmapped": list(args[0].shape)})
            return
        self.busy = True
        try:
            idx = torch.tensor(rows, device=out.device)
            sub = fn(*(_take(a, idx) for a in args),
                     **{k: _take(v, idx) for k, v in kwargs.items()})
        finally:
            self.busy = False
        want = out[idx]
        diff = (sub.float() - want.float()).abs()
        self.calls.append({
            "kind": kind, "name": name, "shape": list(args[0].shape),
            "equal": bool(torch.equal(sub, want)),
            "share_differing": float((diff > 0).float().mean()),
            "max_abs_diff": float(diff.max()) if diff.numel() else 0.0,
        })

    @contextlib.contextmanager
    def hooked(self, models):
        handles = []
        for label, model in models.items():
            for name, mod in model.named_modules():
                if isinstance(mod, HOOKED):
                    kind = type(mod).__name__
                    handles.append(mod.register_forward_hook(
                        lambda m, a, kw, o, kind=kind, name=f"{label}.{name}":
                        self.check(kind, name, m, a, kw, o), with_kwargs=True))
        names = {id(m): f"{label}.{n}" for label, model in models.items()
                 for n, m in model.named_modules()}
        saved = [(mod, n, getattr(mod, n)) for mod in PATCHED_MODULES for n in PATCHED
                 if hasattr(mod, n)]

        def wrap(fn_name, fn):
            def wrapped(*args, **kwargs):
                out = fn(*args, **kwargs)
                if fn_name == "attention_op":  # (q, k, v): every operand carries the batch
                    self.check(fn_name, fn_name, fn, args, kwargs, out)
                else:  # (layer, x)
                    self.check(fn_name, names.get(id(args[0]), fn_name),
                               lambda *a, **kw: fn(args[0], *a, **kw),
                               args[1:], kwargs, out)
                return out
            return wrapped

        for mod, fn_name, fn in saved:
            setattr(mod, fn_name, wrap(fn_name, fn))
        try:
            yield
        finally:
            for h in handles:
                h.remove()
            for mod, fn_name, fn in saved:
                setattr(mod, fn_name, fn)


def build(device, tiny: bool, seed: int):
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(seed)
    cfgs = ((UNetConfig.tiny(), ClipTextConfig.tiny(), VaeConfig.tiny()) if tiny
            else (UNetConfig.sd15(), ClipTextConfig.sd15(), VaeConfig.sd15()))
    unet = _filled(UNet2DCondition(cfgs[0], device=device, dtype=dtype), gen)
    text = _filled(ClipTextEncoder(cfgs[1], device=device, dtype=dtype), gen)
    vae = _filled(AutoencoderKL(cfgs[2], device=device, dtype=dtype), gen)
    with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
        torch.manual_seed(seed + 1)
        policy = FactorNet(FactorNetConfig(order_dim=4, scaler_dim=0, num_actions=11,
                                           family="sd"), device=device)
    return TextToImagePipeline(unet, text, vae, DiffusionSchedule.sd15(), factor_net=policy,
                               tokenizer=HashTokenizer(), device=device)


def _uint8(images):
    return np.clip(images.float().cpu().numpy() * 255.0 + 0.5, 0, 255).astype(np.uint8)


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


def time_top_level_convs(pipe, rows: int, latent: int, steps: int, iters: int, log=print):
    """The top-level UNet convolutions that a deterministic program runs one
    sample at a time (the level-0 downsampler and the f32 ``conv_out``): each
    one's ms batched and per sample at the CFG batch of ``rows`` requests,
    and the difference per deterministic generation (one call a step)."""
    device = pipe.device
    unet = pipe.unet
    shapes = {"unet.down_blocks.0.downsamplers.0.conv": (unet.cfg.block_out_channels[0],
                                                         latent + 1, latent + 1),
              "unet.conv_out": (unet.cfg.block_out_channels[0], latent, latent)}
    convs = dict(unet.named_modules(prefix="unet"))
    out = {}
    with torch.inference_mode():
        for name, (c, h, w) in shapes.items():
            conv = convs[name]
            f32 = name == "unet.conv_out"
            x = torch.randn((2 * rows, c, h, w), device=device).to(
                torch.float32 if f32 else conv.weight.dtype)
            batched = (lambda: layers.conv_f32(conv, x)) if f32 else (lambda: conv(x))
            per_sample = (lambda: layers.conv_f32(conv, x, per_sample=True)) if f32 \
                else (lambda: layers.slot_invariant_conv(conv, x))
            row = {"conv": name, "input": list(x.shape),
                   "batched_ms": _time_ms(batched, device, iters),
                   "per_sample_ms": _time_ms(per_sample, device, iters)}
            row["added_ms_per_generation"] = steps * (row["per_sample_ms"] - row["batched_ms"])
            log(json.dumps({"top_level_conv": row}))
            out[name] = row
    return out


def compare_parts(pipe, ids, noise, full: int, part: int, steps: int, cfg: float, log=print):
    """Every hooked call of the ``full``-row deterministic program against
    its ``part``-row rows, then the two whole programs' uint8 images."""
    def program(rows):
        images, _ = pipe(None, ids[:rows], noise[:rows], num_inference_steps=steps,
                         guidance_scale=cfg, deterministic_policy=True, record=False)
        return images

    compare = _Compare(full, part)
    with torch.inference_mode(), compare.hooked({"unet": pipe.unet, "text": pipe.text_encoder,
                                                 "vae": pipe.vae}):
        program(full)
    with torch.inference_mode():
        full_images, part_images = _uint8(program(full)), _uint8(program(part))
    gap = np.abs(full_images[:part].astype(np.int32) - part_images.astype(np.int32))

    kinds = {}
    for c in compare.calls:
        k = kinds.setdefault(c["kind"], {"calls": 0, "differing": 0, "unmapped": 0,
                                         "names_differing": [], "first": None})
        k["calls"] += 1
        if "unmapped" in c:
            k["unmapped"] += 1
        elif not c["equal"]:
            k["differing"] += 1
            k["first"] = k["first"] or c
            if c["name"] not in k["names_differing"]:
                k["names_differing"].append(c["name"])
    for kind, k in kinds.items():
        log(json.dumps({"part_rows": part, "route": kind, **k}))
    differing = [c for c in compare.calls if "equal" in c and not c["equal"]]
    summary = {
        "full_rows": full, "part_rows": part, "calls": len(compare.calls),
        "calls_differing": len(differing),
        "first_differing": differing[0] if differing else None,
        "images_equal": bool((gap == 0).all()), "images_max_levels": int(gap.max()),
        "images_share_differing": float((gap > 0).mean()),
    }
    log(json.dumps({"summary": summary}))
    return summary


def run(device: str, tiny: bool, full: int, parts, steps: int, cfg: float, seed: int,
        iters: int = 10, log=print):
    device = torch.device(device)
    torch.manual_seed(seed)
    pipe = build(device, tiny, seed)
    latent = 8 if tiny else 64
    log(json.dumps({
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "dtype": str(pipe.unet.conv_in.weight.dtype).replace("torch.", ""),
        "steps": steps, "cfg": cfg, "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
        "tf32_cudnn": torch.backends.cudnn.allow_tf32}))
    vocab = pipe.text_encoder.cfg.vocab_size
    ids = tokenize_batch(HashTokenizer(), (PROMPTS * full)[:full], 77, vocab_size=vocab)
    gen = torch.Generator(device="cpu").manual_seed(seed + 2)
    noise = torch.randn((full, latent, latent, pipe.unet.cfg.in_channels), generator=gen)
    summaries = [compare_parts(pipe, ids, noise, full, part, steps, cfg, log) for part in parts]
    timing = time_top_level_convs(pipe, full, latent, steps, iters, log)
    return summaries, timing


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--tiny", action="store_true", help="tiny models, 8x8 latents")
    parser.add_argument("--full", type=int, default=8, help="rows of one process's batch")
    parser.add_argument("--parts", type=int, nargs="+", default=[4, 2, 1],
                        help="rows of one data rank's batch (dp = full / part)")
    parser.add_argument("--steps", type=int, default=8)
    parser.add_argument("--cfg", type=float, default=3.0)
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu --tiny for the plain CPU run")
    torch.backends.cuda.matmul.allow_tf32 = False  # chip_smoke.py's setting
    run(args.device, args.tiny, args.full, args.parts, args.steps, args.cfg, args.seed,
        args.iters)


if __name__ == "__main__":
    main()
