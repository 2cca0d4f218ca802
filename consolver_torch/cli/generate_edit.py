"""Kontext-bench edit generation: ``python -m consolver_torch generate-edit``.

Port of ``scripts/generate_edit.py`` (edit_ppo/generate_ours.py and
generate_pretrain.py)::

  python -m consolver_torch generate-edit --source kontext-bench/test \\
      --out results/ours5 --solver fmppo --steps 5 \\
      [--pretrained ckpts/flux --factor-ckpt runs/flux/checkpoint-3000]

Reads (reference image, instruction) examples (``metadata.jsonl`` or image +
``.txt`` sidecars; images by content, PNG or JPEG), runs the FLUX-Kontext
pipeline, and writes one folder per example (``ref_image.jpg`` /
``instruction.txt`` / ``edited_image.jpg``, ``eval/edit_scores.py``) named
by the record's ``key``, else by its index and a slug of the instruction.
A ragged last batch is padded with its last example (the padding's outputs
are dropped).  Each example's noise comes from a generator of its own,
seeded from ``(--seed, example index)``, so it does not depend on
``--batch-size``.  ``--shard`` runs each batch over a data mesh of every
rank of a ``torchrun`` world; rank 0 writes.  Smoke mode (no
``--pretrained``) uses tiny random models.
"""

from __future__ import annotations

import argparse
import os
import random
from typing import Sequence, Tuple

import numpy as np
import torch

from consolver_torch.configs.config import ExperimentConfig, add_device_flag, apply_overrides
from consolver_torch.device import resolve_device

BATCH_KEY_OFFSET = 10_000_000  # the policy's per-batch key, as fold_in(seed, 10_000_000 + start)


def _parser():
    ap = argparse.ArgumentParser(prog="python -m consolver_torch generate-edit")
    ap.add_argument("--source", required=True,
                    help="dir with metadata.jsonl or image+txt sidecars")
    ap.add_argument("--out", required=True)
    ap.add_argument("--solver", default="fmppo",
                    help="fmppo | euler | heun | dpm-solver | dpm-solver-multistep")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--cfg", type=float, default=2.5)
    ap.add_argument("--pretrained", default=None)
    ap.add_argument("--factor-ckpt", default=None)
    ap.add_argument("--resolution", type=int, default=None,
                    help="image H=W (default: 1024 with --pretrained, 16 smoke)")
    ap.add_argument("--seed", type=int, default=42)  # generate.py:80 fixed seed
    ap.add_argument("--max-examples", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=1,
                    help="examples per pipeline call (the noise stays per example)")
    ap.add_argument("--shard", action="store_true",
                    help="shard each batch over a data mesh of every rank")
    add_device_flag(ap)
    return ap


def _seed(seed: int, index: int) -> int:
    return random.Random(f"{seed}-{index}").getrandbits(63)


def example_noise(seed: int, indices: Sequence[int], shape: Tuple[int, ...]) -> torch.Tensor:
    """``[len(indices), *shape]`` noise, row ``j`` from a CPU generator
    seeded from ``(seed, indices[j])``."""
    from consolver_torch.serve.engine import seed_noise

    return seed_noise([_seed(seed, i) for i in indices], shape)


def example_name(record: dict, index: int, instruction: str) -> str:
    """The record's ``key`` (kontext-bench, generate_ours.py:55,67), else
    the index and a slug of the instruction."""
    return record.get("key") or (
        f"{index:05d}_" + "".join(c if c.isalnum() else "_" for c in instruction[:40]))


def main(argv=None):
    from consolver_torch.cli.generate import world_mesh
    from consolver_torch.cli.train_flux import build_pipeline
    from consolver_torch.cli.train_sd15 import make_policy
    from consolver_torch.data.edit_prep import center_crop_resize, read_instruction_records
    from consolver_torch.data.tokenizer import load_tokenizer, tokenize_batch
    from consolver_torch.dist import mesh as meshlib
    from consolver_torch.eval.edit_scores import write_example
    from consolver_torch.policy.factor_net import FactorNet, ShardedGenerator
    from consolver_torch.policy.io import load_factor_ckpt
    from consolver_torch.utils.image import read_image

    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    mesh = world_mesh(device) if args.shard else None
    if mesh is not None:
        device = mesh.device
    cfg = ExperimentConfig.flux_ppo()
    if args.pretrained:
        cfg = apply_overrides(cfg, {"model.pretrained_path": args.pretrained})
    if args.factor_ckpt:
        fcfg, state = load_factor_ckpt(args.factor_ckpt, cfg.factor_net)
        fnet = FactorNet(fcfg, device=device)
        fnet.load_state_dict(state)
    else:
        fnet = make_policy(cfg.factor_net, 0, device)
    pipe = build_pipeline(cfg, fnet, device)

    vae_factor = 2 ** (len(pipe.vae.cfg.block_out_channels) - 1)
    resolution = args.resolution or (1024 if args.pretrained else 16)
    latent = resolution // vae_factor
    shape = (latent, latent, pipe.vae.cfg.latent_channels)
    t5_tok = load_tokenizer(
        os.path.join(args.pretrained, "tokenizer_t5") if args.pretrained else None,
        kind="t5", max_length=128)
    clip_tok = load_tokenizer(
        os.path.join(args.pretrained, "tokenizer") if args.pretrained else None,
        kind="clip", max_length=77)

    records = read_instruction_records(args.source)[: args.max_examples]
    pairs = [(r["path"], r["instruction"]) for r in records]
    if not pairs:
        raise SystemExit(f"no examples under {args.source}")
    os.makedirs(args.out, exist_ok=True)

    for start in range(0, len(pairs), args.batch_size):
        chunk = pairs[start:start + args.batch_size]
        idxs = list(range(start, start + len(chunk)))
        want = args.batch_size
        if mesh is not None:
            want = max(want, mesh.dp)
            want += (-want) % mesh.dp
        while len(chunk) < want:  # one batch shape for every batch; the padding is dropped
            chunk = chunk + [chunk[-1]]
            idxs = idxs + [idxs[-1]]

        refs01 = [center_crop_resize(read_image(path), resolution) for path, _ in chunk]
        instructions = [instruction for _, instruction in chunk]
        ref = torch.from_numpy(np.stack(refs01) * 2.0 - 1.0)
        t5_ids = torch.as_tensor(tokenize_batch(t5_tok, instructions, 128,
                                                vocab_size=pipe.t5.cfg.vocab_size))
        clip_ids = torch.as_tensor(tokenize_batch(clip_tok, instructions, 77,
                                                  vocab_size=pipe.clip.cfg.vocab_size))
        noise = example_noise(args.seed, idxs, shape)
        generator = torch.Generator(device).manual_seed(
            _seed(args.seed, BATCH_KEY_OFFSET + start))
        if mesh is not None:
            ref, t5_ids, clip_ids, noise = meshlib.shard_batch(
                mesh, tuple(x.to(device) for x in (ref, t5_ids, clip_ids, noise)))
            generator = ShardedGenerator(generator, meshlib.shard_slice(mesh, len(idxs)).start,
                                         len(idxs))
        edited, _ = pipe(generator, t5_ids, clip_ids, ref, noise,
                         num_inference_steps=args.steps, guidance_scale=args.cfg,
                         solver=args.solver, record=False)
        if mesh is not None:
            edited = meshlib.gather_batch(mesh, edited)
            if mesh.rank != 0:
                continue
        edited = edited.float().cpu().numpy()
        for j in range(len(set(idxs))):
            i = idxs[j]
            write_example(args.out, example_name(records[i], i, instructions[j]), refs01[j],
                          instructions[j], edited[j])
    print(f"wrote {len(pairs)} examples to {args.out}")


if __name__ == "__main__":
    main()
