"""Preview -> refine demo: ``python -m consolver_torch preview``.

Port of ``scripts/preview_demo.py``::

  python -m consolver_torch preview --prompt "a photo of a corgi" \\
      [--pretrained ckpts/sd15 --factor-ckpt runs/ppo/checkpoint-3000] \\
      --out demo/ [--candidates 4 --preview-steps 8 --refine-steps 40]

Writes ``preview_0..N.png``; ``--accept K`` also writes ``refined_K.png``,
regenerated at full steps from the SAME noise as preview K (the product
loop of the paper, readme.md:135-150).
"""

from __future__ import annotations

import argparse
import os

import torch

from consolver_torch.configs.config import ExperimentConfig, add_device_flag, apply_overrides
from consolver_torch.device import resolve_device


def main(argv=None):
    from consolver_torch.cli.train_sd15 import build_pipeline, make_policy
    from consolver_torch.data.tokenizer import load_tokenizer, tokenize_batch
    from consolver_torch.eval.gen_sweep import save_png
    from consolver_torch.pipelines.preview import PreviewSession
    from consolver_torch.policy.factor_net import FactorNet
    from consolver_torch.policy.io import load_factor_ckpt

    ap = argparse.ArgumentParser(prog="python -m consolver_torch preview")
    ap.add_argument("--prompt", default="a sample prompt")
    ap.add_argument("--out", required=True)
    ap.add_argument("--pretrained", default=None)
    ap.add_argument("--factor-ckpt", default=None)
    ap.add_argument("--candidates", type=int, default=4)
    ap.add_argument("--preview-steps", type=int, default=8)
    ap.add_argument("--refine-steps", type=int, default=40)
    ap.add_argument("--refine-solver", default="multistep-dpm")
    ap.add_argument("--cfg", type=float, default=3.0)
    ap.add_argument("--accept", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = ExperimentConfig.sd15_ppo()
    if args.pretrained:
        cfg = apply_overrides(cfg, {"model.pretrained_path": args.pretrained})
    if args.factor_ckpt:
        fcfg, state = load_factor_ckpt(args.factor_ckpt, cfg.factor_net)
        fnet = FactorNet(fcfg, device=device)
        fnet.load_state_dict(state)
    else:
        fnet = make_policy(cfg.factor_net, 0, device)
    pipe = build_pipeline(cfg, fnet, device)

    tokenizer = load_tokenizer(
        os.path.join(args.pretrained, "tokenizer") if args.pretrained else None)
    prompt_ids = tokenize_batch(tokenizer, [args.prompt], 77,
                                vocab_size=pipe.text_encoder.cfg.vocab_size)[0]
    latent = 64 if args.pretrained else 8
    session = PreviewSession(pipe, preview_steps=args.preview_steps,
                             refine_steps=args.refine_steps, refine_solver=args.refine_solver,
                             guidance_scale=args.cfg)
    os.makedirs(args.out, exist_ok=True)
    generator = torch.Generator(device).manual_seed(args.seed)
    previews = session.preview(generator, prompt_ids, latent_hw=(latent, latent),
                               num_candidates=args.candidates)
    for i, p in enumerate(previews):
        save_png(os.path.join(args.out, f"preview_{i}.png"), p.image)
    print(f"wrote {len(previews)} previews ({args.preview_steps} steps) to {args.out}")

    if args.accept is not None:
        refined = session.refine(previews[args.accept], generator)
        path = os.path.join(args.out, f"refined_{args.accept}.png")
        save_png(path, refined)
        print(f"refined preview {args.accept} at {args.refine_steps} steps -> {path}")
    return previews


if __name__ == "__main__":
    main()
