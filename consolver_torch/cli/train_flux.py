"""FLUX-Kontext editing ConsistencySolver PPO training:
``python -m consolver_torch train-flux``.

Port of ``scripts/train_flux.py`` (edit_ppo/run_ppo.sh -> train_ppo.py)::

  python -m consolver_torch train-flux --preset flux_ppo \\
      --set model.pretrained_path=ckpts/flux \\
      --set data.train_data_dir=data/teacher/flux

The layout under ``model.pretrained_path`` is ``transformer/ t5/ clip_text/
vae/`` (component directories with their ``_config.json``).  Without it the
loop runs on tiny random models (smoke mode).  ``model.quantize_rollout``
runs the frozen rollout DiT and VAE decoder through ``quantize(bits=
model.quantize_bits)``.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from consolver_torch.cli.train_sd15 import (
    SMOKE_SEED, build_reward, load_component_module, make_policy, model_dtype, random_fill_,
    teacher_batches,
)
from consolver_torch.configs.config import ExperimentConfig, parse_args
from consolver_torch.device import resolve_device


def build_pipeline(cfg: ExperimentConfig, factor_net, device):
    """The FLUX-Kontext pipeline from ``model.pretrained_path``, else the
    JAX CLI's tiny random stack seeded from :data:`SMOKE_SEED`."""
    from consolver_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
    from consolver_torch.models.flux import FluxConfig, FluxTransformer
    from consolver_torch.models.t5 import T5Config, T5Encoder
    from consolver_torch.models.vae import AutoencoderKL, VaeConfig
    from consolver_torch.pipelines.edit import FluxKontextPipeline

    device = resolve_device(device)
    dtype = model_dtype(cfg)
    pretrained = cfg.model.pretrained_path
    if pretrained:
        transformer, t5, clip, vae = (
            load_component_module(os.path.join(pretrained, name), kind, default, dtype, device)
            for name, kind, default in (
                ("transformer", "flux", FluxConfig.flux_kontext()),
                ("t5", "t5", T5Config.xxl()),
                ("clip_text", "clip_text", ClipTextConfig.sd15()),
                ("vae", "vae", VaeConfig(latent_channels=16, scaling_factor=0.3611))))
    else:
        print("[smoke mode] no pretrained_path: tiny random models")
        fcfg = FluxConfig.tiny()
        gen = torch.Generator().manual_seed(SMOKE_SEED)
        transformer, t5, clip, vae = (random_fill_(m, gen).to(device) for m in (
            FluxTransformer(fcfg, device="cpu"),
            T5Encoder(T5Config(vocab_size=64, d_model=fcfg.joint_text_dim, d_kv=8, d_ff=64,
                               num_layers=1, num_heads=4), device="cpu"),
            ClipTextEncoder(ClipTextConfig(vocab_size=64, hidden_size=fcfg.pooled_text_dim,
                                           num_layers=1, num_heads=2, intermediate_size=32),
                            device="cpu"),
            AutoencoderKL(VaeConfig(block_out_channels=(8, 16), layers_per_block=1,
                                    norm_num_groups=4, latent_channels=4), device="cpu")))
    return FluxKontextPipeline(transformer, t5, clip, vae, factor_net=factor_net, device=device)


def maybe_quantize_rollout(pipe, cfg: ExperimentConfig):
    """``model.quantize_rollout``: the frozen rollout DiT and VAE decoder on
    the quantized path (``model.quantize_bits``: 8 = W8A8, 4 = packed int4);
    a checkpoint already quantized (its sidecar sets quant_int8 / int4) is
    kept."""
    if not cfg.model.quantize_rollout:
        return pipe
    tcfg = pipe.transformer.cfg
    if tcfg.quant_int8 or tcfg.quant_int4:
        return pipe
    return pipe.quantize(bits=cfg.model.quantize_bits)


def main(argv=None):
    from consolver_torch.data.group import TeacherDataset
    from consolver_torch.dist import mesh as meshlib
    from consolver_torch.rl.train_edit import EditPPOTrainer
    from consolver_torch.utils.logging import MetricLogger

    cfg, device = parse_args(argv)
    device = resolve_device(device)
    mesh = meshlib.mesh_from_config(cfg.dist.data_parallel, cfg.dist.model_parallel,
                                    device=device)
    if mesh is not None:
        device = mesh.device
    # data.batch_size is PER SHARD (10 a process in edit_ppo/run_ppo.sh)
    global_batch = cfg.data.batch_size * meshlib.data_axis_size(mesh)
    batches = teacher_batches(TeacherDataset(cfg.data.train_data_dir), global_batch,
                              cfg.data.shuffle)
    pipe = maybe_quantize_rollout(
        build_pipeline(cfg, make_policy(cfg.factor_net, cfg.train.seed, device), device), cfg)
    reward_fn = build_reward(cfg, device)
    trainer = EditPPOTrainer(pipe, reward_fn, cfg.train, mesh=mesh,
                             dump_samples_to=os.path.join(cfg.train.output_dir, "samples"))
    trainer.resume_from_checkpoint("latest")
    logger = MetricLogger(cfg.train.output_dir, config=dataclasses.asdict(cfg))
    trainer.fit(batches, log_fn=logger.log)
    trainer.save_checkpoint()
    logger.close()
    return trainer


if __name__ == "__main__":
    main()
