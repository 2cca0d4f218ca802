"""Generation sweeps over the solver zoo: ``python -m consolver_torch generate``.

Port of ``scripts/generate.py`` (gen.sh / gen_ppo.py)::

  python -m consolver_torch generate --solver multistep-dpm --steps 8 \\
      --prompts coco_captions.json --out results/dpm8 \\
      [--pretrained ckpts/sd15] [--factor-ckpt runs/ppo/checkpoint-3000]

Solvers: consistencysolver | ddim | ipndm | unipc | deis | multistep-dpm |
amed | dmd2 | sde-dpmsolver | sde-dpmsolver++.  ``--factor-ckpt`` takes a
trainer checkpoint, a ``save_pretrained`` export or a converted
``factor_net`` component; the policy dims in its ``factor_net_config.json``
override the preset's.  ``--shard`` runs each batch over a data mesh of
every rank of a ``torchrun`` world (the reference's 8-GPU thread pool,
gen_ppo.py:446-462); rank 0 writes the images.  Smoke mode (no
``--pretrained``) uses tiny random models.
"""

from __future__ import annotations

import argparse
import os

import torch

from consolver_torch.configs.config import ExperimentConfig, add_device_flag, apply_overrides
from consolver_torch.device import resolve_device


def _parser():
    ap = argparse.ArgumentParser(prog="python -m consolver_torch generate")
    ap.add_argument("--solver", default="consistencysolver")
    ap.add_argument("--eta", type=float, default=0.0,
                    help="stochastic DDIM eta (solver=ddim/dmd2 only)")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--cfg", type=float, default=3.0)
    ap.add_argument("--prompts", default=None,
                    help="COCO captions json, or a .txt with one prompt/line")
    ap.add_argument("--out", required=True)
    ap.add_argument("--pretrained", default=None)
    ap.add_argument("--factor-ckpt", default=None)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-prompts", type=int, default=None)
    ap.add_argument("--latent-size", type=int, default=None,
                    help="latent H=W (default: 64 with --pretrained, 8 smoke)")
    ap.add_argument("--shard", action="store_true",
                    help="shard each generation batch over a data mesh of every rank")
    add_device_flag(ap)
    return ap


def world_mesh(device):
    """A data mesh over every rank of the (``torchrun``) world."""
    import torch.distributed as dist

    from consolver_torch.dist import mesh as meshlib

    meshlib.init_distributed(device)
    return meshlib.init_mesh(dist.get_world_size(), 1, device=device)


def main(argv=None):
    from consolver_torch.cli.train_sd15 import build_pipeline, make_policy
    from consolver_torch.data.tokenizer import load_tokenizer, tokenize_batch
    from consolver_torch.dist import mesh as meshlib
    from consolver_torch.eval.gen_sweep import generate_sweep, read_coco_captions
    from consolver_torch.pipelines.solver_zoo import make_baseline_denoise_fn
    from consolver_torch.policy.factor_net import FactorNet, ShardedGenerator
    from consolver_torch.policy.io import load_factor_ckpt

    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    mesh = world_mesh(device) if args.shard else None
    if mesh is not None:
        device = mesh.device
        if args.batch_size % mesh.dp:
            raise SystemExit(f"--batch-size {args.batch_size} does not split over {mesh.dp} ranks")
    cfg = ExperimentConfig.sd15_ppo()
    if args.pretrained:
        cfg = apply_overrides(cfg, {"model.pretrained_path": args.pretrained})
    if args.factor_ckpt:
        # the checkpoint's dims, not the preset's (gen.sh generates with 21
        # actions where run_ppo.sh trains 11: the dims ride with the policy)
        fcfg, state = load_factor_ckpt(args.factor_ckpt, cfg.factor_net)
        fnet = FactorNet(fcfg, device=device)
        fnet.load_state_dict(state)
    else:
        fnet = make_policy(cfg.factor_net, 0, device)
    pipe = build_pipeline(cfg, fnet, device)

    if args.prompts is None:
        prompts = [f"sample prompt {i}" for i in range(args.max_prompts or 16)]
    elif args.prompts.endswith(".json"):
        prompts = read_coco_captions(args.prompts, args.max_prompts)
    else:
        with open(args.prompts) as f:
            prompts = [line.strip() for line in f if line.strip()][: args.max_prompts]
    tokenizer = load_tokenizer(
        os.path.join(args.pretrained, "tokenizer") if args.pretrained else None)
    latent = args.latent_size or (64 if args.pretrained else 8)
    channels = pipe.unet.cfg.in_channels
    vocab = pipe.text_encoder.cfg.vocab_size

    def inputs(generator, batch_prompts):
        """The batch's ids and noise (drawn whole from the batch generator),
        and this rank's shard of both on a mesh."""
        ids = torch.as_tensor(tokenize_batch(tokenizer, batch_prompts, 77, vocab_size=vocab),
                              device=device)
        noise = torch.randn((len(batch_prompts), latent, latent, channels), device=device,
                            generator=generator)
        if mesh is not None:
            ids, noise = meshlib.shard_batch(mesh, (ids, noise))
        return ids, noise

    def policy_generator(generator, rows):
        if mesh is None:
            return generator
        return ShardedGenerator(generator, meshlib.shard_slice(mesh, rows).start, rows)

    def gathered(images):
        return images if mesh is None else meshlib.gather_batch(mesh, images)

    if args.eta > 0:
        # stochastic DDIM (the eta of the reference pipeline call)
        solver_name = args.solver if args.solver in ("ddim", "dmd2") else "ddim"
        eta_denoise = make_baseline_denoise_fn(pipe.unet, pipe.schedule, solver_name, args.steps,
                                               args.cfg, eta=args.eta)

        @torch.inference_mode()
        def generate_batch(generator, batch_prompts):
            ids, noise = inputs(generator, batch_prompts)
            context, uncond = pipe._encode(ids, pipe.uncond_ids_for(ids))
            latents = eta_denoise(policy_generator(generator, len(batch_prompts)), noise,
                                  context, uncond)
            return gathered(pipe.decode_latents(latents))
    else:
        def generate_batch(generator, batch_prompts):
            ids, noise = inputs(generator, batch_prompts)
            images, _ = pipe(policy_generator(generator, len(batch_prompts)), ids, noise,
                             args.steps, args.cfg, solver=args.solver, record=False)
            return gathered(images)

    files = generate_sweep(generate_batch, prompts, args.out, args.batch_size, args.seed,
                           device=device, mesh=mesh)
    print(f"wrote {len(files)} images to {args.out}")
    return files


if __name__ == "__main__":
    main()
