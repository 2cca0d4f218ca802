"""Consistency, FID and edit-score evaluation: ``python -m consolver_torch
evaluate``.

Port of ``scripts/evaluate.py`` (compute_reward.sh + fid_test.py +
edit_ppo/compute_score.py)::

  python -m consolver_torch evaluate consistency --generated results/ours8 \\
      --reference results/teacher40 --reward image_psnr --out stats.json
  python -m consolver_torch evaluate fid --generated results/ours8 \\
      --reference results/teacher40 --encoder-ckpt ckpts/inception
  python -m consolver_torch evaluate edit-score --results results/edits5 \\
      --judge-ckpt ckpts/llava --out edit_stats.json

``--encoder-ckpt`` is a component directory that ``convert`` wrote (kinds
dinov2 | clip_vision | inception); ``--judge-ckpt`` a local transformers
image-text-to-text checkpoint.  Images are read by their content, PNG or
JPEG, whatever their names.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from consolver_torch.configs.config import add_device_flag
from consolver_torch.device import resolve_device


def _parser():
    ap = argparse.ArgumentParser(prog="python -m consolver_torch evaluate")
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("consistency")
    c.add_argument("--generated", required=True)
    c.add_argument("--reference", required=True)
    c.add_argument("--reward", default="image_psnr")
    c.add_argument("--encoder-ckpt", default=None)
    c.add_argument("--out", default=None)
    c.add_argument("--batch-size", type=int, default=32)
    c.add_argument("--shard", action="store_true",
                   help="shard reward batches over a data mesh of every rank")
    add_device_flag(c)

    f = sub.add_parser("fid")
    f.add_argument("--generated", required=True)
    f.add_argument("--reference", required=True)
    f.add_argument("--encoder-ckpt", default=None)
    f.add_argument("--encoder-kind", default="inception", choices=("inception", "dino", "clip"),
                   help="feature stream for the Frechet distance; 'inception' uses the "
                   "clean-fid pool3 2048-d features (fid_test.py semantics)")
    f.add_argument("--batch-size", type=int, default=32)
    add_device_flag(f)

    e = sub.add_parser("edit-score",
                       help="score folder-per-example edit results with a local VLM "
                       "(EditScore stand-in, edit_ppo/compute_score.py)")
    e.add_argument("--results", required=True, help="dir of generate-edit outputs")
    e.add_argument("--judge-ckpt", required=True,
                   help="local transformers image-text-to-text checkpoint")
    e.add_argument("--out", default=None)
    add_device_flag(e)
    return ap


def main(argv=None):
    from consolver_torch.cli.train_sd15 import load_encoder
    from consolver_torch.eval.consistency import _load_image, evaluate_consistency
    from consolver_torch.eval.fid import compute_fid
    from consolver_torch.rewards.registry import RewardModel, make_reward_fn

    args = _parser().parse_args(argv)
    device = resolve_device(args.device)

    if args.cmd == "edit-score":
        from consolver_torch.eval.edit_scores import score_results
        from consolver_torch.rewards.vlm import load_transformers_edit_scorer

        stats = score_results(args.results, load_transformers_edit_scorer(args.judge_ckpt, device),
                              output_json=args.out)
        print(stats)
        return stats

    if args.cmd == "consistency":
        model = RewardModel()
        if args.reward in ("dino", "clip", "inception"):
            if not args.encoder_ckpt:
                raise SystemExit(f"--encoder-ckpt required for reward {args.reward}")
            model = RewardModel(encode=load_encoder(args.reward, args.encoder_ckpt, device))
        reward_fn = make_reward_fn(args.reward, model)
        mesh = None
        if args.shard:
            from consolver_torch.cli.generate import world_mesh

            mesh = world_mesh(device)
        stats = evaluate_consistency(reward_fn, args.generated, args.reference,
                                     batch_size=args.batch_size, output_json=args.out,
                                     mesh=mesh, device=device)
        print(stats)
        return stats

    if args.encoder_ckpt and args.encoder_kind == "inception":
        # FID takes the 2048-d pool3 features (clean-fid), not the reward's logits
        from consolver_torch.models.checkpoint import load_component
        from consolver_torch.models.inception import InceptionV3, make_inception_encoder

        model = load_component(InceptionV3(0, device="meta"), args.encoder_ckpt, device=device,
                               drop=("fc.",))
        encode = make_inception_encoder(model)
    elif args.encoder_ckpt:
        encode = load_encoder(args.encoder_kind, args.encoder_ckpt, device)
    else:
        print("[smoke] no --encoder-ckpt: FID over downsampled pixels")
        from consolver_torch.utils.resize import resize

        def encode(imgs):
            return resize(imgs, (len(imgs), 8, 8, 3), "linear").reshape(len(imgs), -1)

    def stream(d):
        files = sorted(glob.glob(os.path.join(d, "**", "*.png"), recursive=True)
                       + glob.glob(os.path.join(d, "**", "*.jpg"), recursive=True))
        for start in range(0, len(files), args.batch_size):
            yield np.stack([_load_image(p, (256, 256))
                            for p in files[start:start + args.batch_size]])

    with torch.no_grad():
        d = compute_fid(encode, stream(args.generated), stream(args.reference), device=device)
    print({"fid": d})
    return d


if __name__ == "__main__":
    main()
