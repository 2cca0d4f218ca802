"""Hub checkpoints -> port component directories: ``python -m consolver_torch convert``.

Port of ``scripts/convert_checkpoints.py``, without jax or orbax::

  python -m consolver_torch convert --kind unet --src /path/to/sd15/unet \\
      --dst ckpts/sd15/unet
  kinds: unet | vae | clip_text | clip_vision | dinov2 | t5 | flux |
         factor_net | depth_anything | segformer | inception

``--src`` is a directory of ``*.safetensors`` (preferred; shards in sorted
order) or ``*.bin`` / ``*.pth`` / ``*.ckpt`` files, with the hub's key
names (``models/checkpoint.py``).  The module is built on ``meta``, filled
on the device (the card unless ``--device cpu``) in ``--dtype``, and written
to ``--dst`` as ``model.safetensors`` with the module's own keys and its
config as ``{dst}_config.json`` (the
``factor_net`` kind: ``{dst}_factor_net_config.json``).  ``--config`` names
a preset of the kind's config class (``sd15``, ``tiny``, ``flux_kontext``,
``xxl``, ...) or a JSON file of its fields; the default is the published
model's.  InceptionV3 keeps its classifier (the reward configuration; FID
drops it at load).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from consolver_torch.configs.config import add_device_flag
from consolver_torch.device import resolve_device
from consolver_torch.models import checkpoint as ck


def kind_config(kind: str, preset):
    """The config of ``kind``: its default, a named preset of its config
    class, or the fields in a JSON file."""
    cls, default = ck.kind_spec(kind)
    if preset is None or cls is None:
        return default
    if preset.endswith(".json"):
        with open(preset) as f:
            return ck.config_from_dict(cls, json.load(f))
    factory = getattr(cls, preset, None)
    if factory is None:
        raise SystemExit(f"no preset {preset!r} on {cls.__name__}")
    return factory()


def main(argv=None):
    from consolver_torch.kernels.quant import module_bytes
    from consolver_torch.policy.factor_net import FactorNetConfig
    from consolver_torch.policy.io import CONFIG_FILE

    ap = argparse.ArgumentParser(prog="python -m consolver_torch convert")
    ap.add_argument("--kind", required=True, choices=ck.KINDS)
    ap.add_argument("--src", required=True)
    ap.add_argument("--dst", required=True)
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--config", default=None,
                    help="a preset of the kind's config class, or a JSON file of its fields")
    # factor_net checkpoint dims (gen.sh passes these on the reference CLI)
    ap.add_argument("--order-dim", type=int, default=4)
    ap.add_argument("--scaler-dim", type=int, default=0)
    ap.add_argument("--mu-dim", type=int, default=0)
    ap.add_argument("--num-actions", type=int, default=11)
    ap.add_argument("--hidden-dim", type=int, default=256)
    ap.add_argument("--family", default="sd", choices=["sd", "fm"])
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32

    if args.kind == "factor_net":
        config = FactorNetConfig(order_dim=args.order_dim, scaler_dim=args.scaler_dim,
                                 mu_dim=args.mu_dim, num_actions=args.num_actions,
                                 hidden_dim=args.hidden_dim, family=args.family)
    else:
        config = kind_config(args.kind, args.config)
    t0 = time.perf_counter()
    module = ck.build_module(args.kind, config, device, dtype)
    try:
        ck.load_hub(module, args.kind, args.src, device=device)
    except ValueError as e:
        if args.kind != "factor_net":
            raise
        # the sidecar exists so that generation rebuilds the net at the
        # trained dims: a mismatch is an error here, where it is clear
        raise SystemExit(f"factor_net dims mismatch: {e}; pass the dims this policy was "
                         f"trained with (the reference's gen.sh values): {config}") from e
    if args.kind == "factor_net":
        module.to(dtype)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ck.save_component(module, args.dst)
    if args.kind == "factor_net":
        # a sibling sidecar ({dst}_factor_net_config.json), so two policies
        # in one parent directory keep their own dims; load_factor_ckpt reads it
        with open(args.dst.rstrip("/") + "_" + CONFIG_FILE, "w") as f:
            json.dump(dataclasses.asdict(config), f, indent=2)
    elif config is not None:
        ck.write_config(args.dst, config)
    write_s = time.perf_counter() - t0
    n = sum(t.numel() for t in module.state_dict().values())
    print(f"converted {args.kind}: {n / 1e6:.1f}M params, {module_bytes(module) / 1e9:.3f} GB "
          f"({args.dtype}) at {args.dst}; load {load_s:.2f} s, write {write_s:.2f} s")
    return module


if __name__ == "__main__":
    main()
