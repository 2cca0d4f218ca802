"""Quantized serving checkpoints: ``python -m consolver_torch quantize``.

Port of ``scripts/quantize_checkpoint.py``: runs the pipeline's
``quantize()`` once, offline, and writes the quantized components with
their ``_config.json`` (``quant_int8`` / ``quant_int4`` set), so that a
server or trainer loads the quantized weights directly::

  python -m consolver_torch quantize --family sd --pretrained ckpts/sd15 --dst ckpts/sd15_int8
  python -m consolver_torch quantize --family flux --bits 4 \\
      --pretrained ckpts/flux --dst ckpts/flux_int4

The output is a drop-in ``--pretrained`` directory (``model.pretrained_path``):
the float components (the text encoders) and the tokenizer directories are
copied as they are.  ``--bits 4`` packs the FLUX DiT's weights (W4A16,
group 128); the VAE decoder stays int8 and the SD UNet is int8 only.
"""

from __future__ import annotations

import argparse
import os
import shutil

from consolver_torch.configs.config import ExperimentConfig, add_device_flag, apply_overrides
from consolver_torch.device import resolve_device

# (family -> (quantized components, float components copied as they are))
COMPONENTS = {"sd": (("unet", "vae"), ("clip_text",)),
              "flux": (("transformer", "vae"), ("t5", "clip_text"))}


def copy_component(src_root: str, dst_root: str, name: str) -> None:
    """A component directory and its sidecar, byte for byte."""
    src, dst = os.path.join(src_root, name), os.path.join(dst_root, name)
    shutil.copytree(src, dst, dirs_exist_ok=True)
    if os.path.exists(src + "_config.json"):
        shutil.copyfile(src + "_config.json", dst + "_config.json")


def main(argv=None):
    from consolver_torch.kernels.quant import module_bytes
    from consolver_torch.models.checkpoint import save_component

    ap = argparse.ArgumentParser(prog="python -m consolver_torch quantize")
    ap.add_argument("--family", required=True, choices=["sd", "flux"])
    ap.add_argument("--pretrained", required=True,
                    help="float checkpoint dir (the convert command's layout)")
    ap.add_argument("--dst", required=True)
    ap.add_argument("--bits", type=int, default=8, choices=[4, 8],
                    help="4 = packed int4 DiT weights (flux only; the VAE decoder stays int8)")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    os.makedirs(args.dst, exist_ok=True)
    if args.family == "sd":
        from consolver_torch.cli.train_sd15 import build_pipeline

        if args.bits != 8:
            raise SystemExit("--bits 4 is a FLUX DiT option (the SD UNet is conv-dominated "
                             "and fits one card at int8)")
        cfg = apply_overrides(ExperimentConfig.sd15_ppo(),
                              {"model.pretrained_path": args.pretrained})
        pipe = build_pipeline(cfg, None, device).quantize()
        models = {"unet": pipe.unet, "vae": pipe.vae}
    else:
        from consolver_torch.cli.train_flux import build_pipeline

        cfg = apply_overrides(ExperimentConfig.flux_ppo(),
                              {"model.pretrained_path": args.pretrained})
        pipe = build_pipeline(cfg, None, device).quantize(bits=args.bits)
        models = {"transformer": pipe.transformer, "vae": pipe.vae}
    quantized, copied = COMPONENTS[args.family]
    for name in quantized:
        save_component(models[name], os.path.join(args.dst, name), models[name].cfg)
    for name in copied:
        copy_component(args.pretrained, args.dst, name)
    # the tokenizers travel with the copy (load_tokenizer falls back to the
    # hash tokenizer when they are missing)
    for tok_dir in ("tokenizer", "tokenizer_t5"):
        src = os.path.join(args.pretrained, tok_dir)
        if os.path.isdir(src):
            shutil.copytree(src, os.path.join(args.dst, tok_dir), dirs_exist_ok=True)
    total = sum(module_bytes(m) for m in models.values())
    print(f"wrote int{args.bits} serving checkpoint to {args.dst} "
          f"({total / 1e9:.2f} GB quantized compute params)")
    return pipe


if __name__ == "__main__":
    main()
