"""End-to-end dry run of the evaluation chain: ``python -m consolver_torch selftest``.

Port of ``scripts/selftest_eval.py`` (its SD chain)::

  hub-layout state dicts --> convert --> component directories
  --> generate (teacher sweep + consistencysolver sweep)
  --> evaluate consistency + fid

with tiny random models written by the port's own modules under the hub's
key names (``models.checkpoint.hub_state_dict``: diffusers' for the UNet and
VAE, transformers' for CLIP), every step through ``__main__.main``.  With
real checkpoints the same commands reproduce the BASELINE.md table; they are
printed at the end.  The FLUX edit chain of the JAX selftest (generate-edit,
then edit-score with a tiny transformers VLM) is not in this chain: the GPU
host has no transformers.  ``tests/test_torch_edit_scores.py`` drives both
commands on the CPU.

  python -m consolver_torch selftest [--workdir DIR] [--keep] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import tempfile

import torch

from consolver_torch.configs.config import add_device_flag

KINDS = ("unet", "vae", "clip_text")


def synthesize_sources(src_root: str, seed: int = 0) -> None:
    """Tiny random hub checkpoints of the SD kinds under ``src_root``."""
    from consolver_torch.cli.train_sd15 import random_fill_
    from consolver_torch.models.checkpoint import hub_state_dict, save_file
    from consolver_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
    from consolver_torch.models.unet_2d import UNet2DCondition, UNetConfig
    from consolver_torch.models.vae import AutoencoderKL, VaeConfig

    gen = torch.Generator().manual_seed(seed)
    models = {"unet": UNet2DCondition(UNetConfig.tiny(), device="cpu"),
              "vae": AutoencoderKL(VaeConfig.tiny(), device="cpu"),
              "clip_text": ClipTextEncoder(ClipTextConfig.tiny(), device="cpu")}
    files = {"unet": "diffusion_pytorch_model.safetensors",
             "vae": "diffusion_pytorch_model.safetensors", "clip_text": "model.safetensors"}
    for kind, model in models.items():
        os.makedirs(os.path.join(src_root, kind), exist_ok=True)
        save_file(hub_state_dict(random_fill_(model, gen), kind),
                  os.path.join(src_root, kind, files[kind]))


def main(argv=None):
    from consolver_torch.__main__ import main as cli

    ap = argparse.ArgumentParser(prog="python -m consolver_torch selftest")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--keep", action="store_true")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = ["--device", args.device] if args.device else []

    def run(*command):
        code = cli([*command, *dev])
        if code:
            raise SystemExit(f"`{' '.join(command)}` exited {code}")

    work = args.workdir or tempfile.mkdtemp(prefix="consolver_selftest_eval_")
    src, ckpts, out = (os.path.join(work, d) for d in ("src", "ckpts", "out"))
    print(f"[1/5] synthesizing tiny hub-layout checkpoints under {src}")
    synthesize_sources(src)
    print("[2/5] converting")
    for kind in KINDS:
        run("convert", "--kind", kind, "--src", os.path.join(src, kind),
            "--dst", os.path.join(ckpts, kind), "--config", "tiny")
    print("[3/5] generating the teacher and preview sweeps")
    common = ["--pretrained", ckpts, "--latent-size", "8", "--max-prompts", "8",
              "--batch-size", "4"]
    run("generate", "--solver", "multistep-dpm", "--steps", "12",
        "--out", os.path.join(out, "teacher"), *common)
    run("generate", "--solver", "consistencysolver", "--steps", "3",
        "--out", os.path.join(out, "ours"), *common)
    print("[4/5] consistency statistics")
    stats_path = os.path.join(out, "stats.json")
    run("evaluate", "consistency", "--generated", os.path.join(out, "ours"),
        "--reference", os.path.join(out, "teacher"), "--reward", "image_psnr",
        "--out", stats_path)
    with open(stats_path) as f:
        stats = json.load(f)
    if stats["num_scored"] != 8 or stats["num_errors"] or not math.isfinite(stats["mean"]):
        raise SystemExit(f"consistency statistics: {stats}")
    print("[5/5] FID over downsampled pixels")
    run("evaluate", "fid", "--generated", os.path.join(out, "ours"),
        "--reference", os.path.join(out, "teacher"))

    print("\nSELFTEST EVAL: PASS - convert -> generate -> evaluate (SD)")
    print("With real checkpoints, the BASELINE.md reproduction is:")
    print("  python -m consolver_torch convert --kind unet --src <hub>/unet --dst ckpts/sd15/unet")
    print("  python -m consolver_torch convert --kind vae --src <hub>/vae --dst ckpts/sd15/vae")
    print("  python -m consolver_torch convert --kind clip_text --src <hub>/text_encoder "
          "--dst ckpts/sd15/clip_text")
    print("  python -m consolver_torch generate --solver consistencysolver --steps 8 "
          "--pretrained ckpts/sd15 \\")
    print("      --prompts coco_captions.json --factor-ckpt <policy> --out results/ours8")
    print("  python -m consolver_torch evaluate consistency --generated results/ours8 "
          "--reference results/teacher40 --reward dino --encoder-ckpt ckpts/dinov2")
    print("  python -m consolver_torch evaluate fid --generated results/ours8 "
          "--reference results/teacher40 --encoder-ckpt ckpts/inception")
    if not args.keep and args.workdir is None:
        shutil.rmtree(work, ignore_errors=True)
    return stats


if __name__ == "__main__":
    main()
