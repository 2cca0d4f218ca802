"""Teacher-trajectory sets for PPO: ``python -m consolver_torch generate-teacher``.

Port of ``scripts/generate_teacher.py`` (gen_pretrain/gen.sh ->
generate_data.py; edit_pretrain/generate.py): the teacher solver over
prompts (SD) or prepared edit samples (FLUX), saving the ``.npz`` samples
that ``data.group.TeacherDataset`` reads::

  python -m consolver_torch generate-teacher --prompts laion.parquet \\
      --out data/teacher/sd15 --solver multistep-dpm --steps 40 [--pretrained ckpts/sd15]
  python -m consolver_torch generate-teacher --family flux --source data/edit_prepared \\
      --out data/teacher/flux --steps 28 [--pretrained ckpts/flux]

``--source`` is the output of ``data.edit_prep.prepare_edit_set``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from consolver_torch.configs.config import ExperimentConfig, add_device_flag, apply_overrides
from consolver_torch.device import resolve_device


def _parser():
    ap = argparse.ArgumentParser(prog="python -m consolver_torch generate-teacher")
    ap.add_argument("--family", default="sd", choices=["sd", "flux"])
    ap.add_argument("--prompts", default=None,
                    help="sd: .parquet | .json (COCO) | .txt; default: synthetic")
    ap.add_argument("--source", default=None,
                    help="flux: dir of prepared {i}.npz (prepare_edit_set)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--solver", default=None,
                    help="default: multistep-dpm (sd) / euler (flux)")
    ap.add_argument("--steps", type=int, default=None,
                    help="default: 40 (sd, gen_pretrain/gen.sh) / 28 (flux, "
                    "edit_pretrain/generate.py)")
    ap.add_argument("--cfg", type=float, default=None)
    ap.add_argument("--pretrained", default=None)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seed", type=int, default=None,
                    help="default: 0 (sd) / 42 (flux, generate.py:80)")
    ap.add_argument("--max-prompts", type=int, default=None)
    add_device_flag(ap)
    return ap


def _config(preset, pretrained):
    cfg = preset()
    if pretrained:
        cfg = apply_overrides(cfg, {"model.pretrained_path": pretrained})
    return cfg


def main(argv=None):
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.family == "flux":
        return main_flux(args, device)
    from consolver_torch.cli.train_sd15 import build_pipeline, make_policy
    from consolver_torch.data.prompts import read_prompts
    from consolver_torch.data.teacher_gen import generate_teacher_set
    from consolver_torch.data.tokenizer import load_tokenizer, tokenize_batch, uncond_input_ids

    solver = args.solver or "multistep-dpm"
    steps = args.steps if args.steps is not None else 40
    cfg_scale = args.cfg if args.cfg is not None else 3.0
    seed = args.seed if args.seed is not None else 0
    cfg = _config(ExperimentConfig.sd15_ppo, args.pretrained)
    pipe = build_pipeline(cfg, make_policy(cfg.factor_net, 0, device), device)

    if args.prompts:
        prompts = read_prompts(args.prompts, args.max_prompts)
    else:
        prompts = [f"synthetic prompt {i}" for i in range(args.max_prompts or 16)]
    tokenizer = load_tokenizer(
        os.path.join(args.pretrained, "tokenizer") if args.pretrained else None)
    prompt_len = 77 if args.pretrained else 8
    vocab = pipe.text_encoder.cfg.vocab_size
    prompt_ids = tokenize_batch(tokenizer, prompts, prompt_len, vocab_size=vocab)
    latent = 64 if args.pretrained else 8
    # the tokenized empty prompt of the CFG negative branch (denoise_ppo.py:39-48),
    # stored per sample so the trainer conditions that branch on the same ids
    uncond_row = uncond_input_ids(tokenizer, 1, prompt_len, vocab_size=vocab)
    denoise = pipe.denoise_fn(steps, cfg_scale, record=False, solver=solver)

    def teacher_denoise(generator, noise, ids):
        uncond = torch.as_tensor(np.tile(uncond_row, (ids.shape[0], 1)), device=device)
        context, uncond_context = pipe._encode(ids, uncond)
        latents, _ = denoise(generator, noise, context, uncond_context)
        return latents

    n = generate_teacher_set(
        teacher_denoise, prompt_ids, args.out, noise_shape=(latent, latent, 4),
        batch_size=args.batch_size, seed=seed, decode_fn=pipe.decode_latents,
        uncond_ids=uncond_row, device=device)
    print(f"wrote {n} teacher samples to {args.out}")
    return n


def main_flux(args, device):
    """The FLUX edit teacher: a full-step rollout over prepared (reference,
    instruction) samples (edit_pretrain/generate.py:34-144)."""
    from consolver_torch.cli.train_flux import build_pipeline
    from consolver_torch.cli.train_sd15 import make_policy
    from consolver_torch.data.teacher_gen import generate_edit_teacher_set
    from consolver_torch.data.tokenizer import load_tokenizer, tokenize_batch

    if not args.source:
        raise SystemExit("--family flux needs --source (prepare_edit_set output)")
    solver = args.solver or "euler"
    steps = args.steps if args.steps is not None else 28
    cfg_scale = args.cfg if args.cfg is not None else 2.5
    seed = args.seed if args.seed is not None else 42
    cfg = _config(ExperimentConfig.flux_ppo, args.pretrained)
    pipe = build_pipeline(cfg, make_policy(cfg.factor_net, 0, device), device)

    vae_factor = 2 ** (len(pipe.vae.cfg.block_out_channels) - 1)
    latent_ch = pipe.vae.cfg.latent_channels
    t5_len = 128 if args.pretrained else 4
    clip_len = 77 if args.pretrained else 4
    t5_tok = load_tokenizer(
        os.path.join(args.pretrained, "tokenizer_t5") if args.pretrained else None,
        kind="t5", max_length=t5_len)
    clip_tok = load_tokenizer(
        os.path.join(args.pretrained, "tokenizer") if args.pretrained else None,
        kind="clip", max_length=clip_len)

    def tokenize(instructions):
        return (tokenize_batch(t5_tok, list(instructions), t5_len,
                               vocab_size=pipe.t5.cfg.vocab_size),
                tokenize_batch(clip_tok, list(instructions), clip_len,
                               vocab_size=pipe.clip.cfg.vocab_size))

    # the latent size from the first prepared sample's reference resolution
    first = sorted(f for f in os.listdir(args.source) if f.endswith(".npz"))[0]
    with np.load(os.path.join(args.source, first)) as z:
        latent = z["ref_image"].shape[0] // vae_factor

    def teacher_denoise(generator, noise, t5_ids, clip_ids, ref):
        latents, _ = pipe(generator, t5_ids, clip_ids, ref, noise, num_inference_steps=steps,
                          guidance_scale=cfg_scale, solver=solver, decode=False, record=False)
        return latents

    n = generate_edit_teacher_set(
        teacher_denoise, tokenize, args.source, args.out,
        noise_shape=(latent, latent, latent_ch), batch_size=args.batch_size, seed=seed,
        decode_fn=pipe.decode_latents, max_samples=args.max_prompts, device=device)
    print(f"wrote {n} edit teacher samples to {args.out}")
    return n


if __name__ == "__main__":
    main()
