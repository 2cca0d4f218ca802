"""SD-1.5 ConsistencySolver PPO training: ``python -m consolver_torch train-sd``.

Port of ``scripts/train_sd15.py`` (run_ppo.sh -> train_ppo.py)::

  python -m consolver_torch train-sd --preset sd15_ppo \\
      --set model.pretrained_path=ckpts/sd15 \\
      --set data.train_data_dir=data/teacher/sd15

The layout under ``model.pretrained_path`` is ``unet/ vae/ clip_text/``
(component directories that ``convert`` or ``quantize`` writes, each with
its ``_config.json`` beside it) and optionally ``tokenizer/``.  Without a
``pretrained_path`` the loop runs on tiny random models (smoke mode).  Runs
on the card unless ``--device cpu``; a ``dist.data_parallel`` above 1 needs
a ``torchrun`` world of that many ranks.

Unlike the JAX CLI, a teacher set smaller than one global batch raises
(``TeacherDataset.batches`` drops a partial batch, so the JAX loop waits
forever for a first batch).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from consolver_torch.configs.config import ExperimentConfig, parse_args
from consolver_torch.device import resolve_device
from consolver_torch.models.checkpoint import (
    build_module, is_quantized, load_component, load_model_config,
)
from consolver_torch.policy.factor_net import FactorNet, FactorNetConfig

SMOKE_SEED = 0  # the tiny random models of smoke mode
FILL_STD = 0.05


def model_dtype(cfg: ExperimentConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.model.dtype == "bfloat16" else torch.float32


def make_policy(config: FactorNetConfig, seed: int, device) -> FactorNet:
    """A FactorNet initialised from ``seed`` on the CPU (the same weights on
    every device), then moved to ``device``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return FactorNet(config, device="cpu").to(device)


def load_component_module(path: str, kind: str, default_config, dtype: torch.dtype, device):
    """The module of ``kind`` from the component directory ``path``, built at
    the config of its ``_config.json`` (else ``default_config``) on
    ``meta`` and filled on ``device``: float components in ``dtype`` (the
    JAX CLIs' ``cast_floating`` after load), quantized ones verbatim."""
    config = load_model_config(path, type(default_config), default_config)
    module = build_module(kind, config, device, dtype=None if is_quantized(config) else dtype)
    return load_component(module, path, device=device, verbatim=is_quantized(config))


def random_fill_(module, gen: torch.Generator, std: float = FILL_STD):
    """Smoke-mode weights: every float parameter ``std * N(0, 1)`` from
    ``gen`` (a CPU generator)."""
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(std * torch.randn(p.shape, generator=gen))
    return module


def build_pipeline(cfg: ExperimentConfig, factor_net: Optional[FactorNet], device):
    """The SD-1.5 pipeline from ``model.pretrained_path``, else tiny random
    models seeded from :data:`SMOKE_SEED`."""
    from consolver_torch.core.schedules import DiffusionSchedule
    from consolver_torch.data.tokenizer import load_tokenizer
    from consolver_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
    from consolver_torch.models.unet_2d import UNet2DCondition, UNetConfig
    from consolver_torch.models.vae import AutoencoderKL, VaeConfig
    from consolver_torch.pipelines.t2i import TextToImagePipeline

    device = resolve_device(device)
    dtype = model_dtype(cfg)
    pretrained = cfg.model.pretrained_path
    if pretrained:
        unet, vae, text = (
            load_component_module(os.path.join(pretrained, name), kind, default, dtype, device)
            for name, kind, default in (("unet", "unet", UNetConfig.sd15()),
                                        ("vae", "vae", VaeConfig.sd15()),
                                        ("clip_text", "clip_text", ClipTextConfig.sd15())))
    else:
        print("[smoke mode] no pretrained_path: tiny random models")
        gen = torch.Generator().manual_seed(SMOKE_SEED)
        unet, vae, text = (random_fill_(m, gen).to(device) for m in (
            UNet2DCondition(UNetConfig.tiny(), device="cpu"),
            AutoencoderKL(VaeConfig.tiny(), device="cpu"),
            ClipTextEncoder(ClipTextConfig.tiny(), device="cpu")))
    tokenizer = load_tokenizer(os.path.join(pretrained, "tokenizer") if pretrained else None)
    return TextToImagePipeline(unet, text, vae, DiffusionSchedule.sd15(), factor_net=factor_net,
                               tokenizer=tokenizer, device=device)


def load_encoder(reward_type: str, path: str, device, dtype: Optional[torch.dtype] = None):
    """``RewardModel.encode`` of a backbone reward (dino | clip | inception)
    from its converted component directory (kinds dinov2 | clip_vision |
    inception)."""
    from consolver_torch.rewards.registry import build_encoder_for

    encode = build_encoder_for(reward_type, device="meta", dtype=dtype)
    load_component(encode.model, path, device=device)
    return encode


def build_reward(cfg: ExperimentConfig, device):
    """The JAX CLI's reward dispatch (``scripts/train_sd15.py:114-140``): the
    backbone-cosine rewards from ``reward.encoder_checkpoint``; any reward
    other than ``image_psnr`` without a checkpoint falls back to
    ``image_psnr``.  As in JAX, no depth or segmentation model is built: a
    ``depth`` or ``segmentation`` reward WITH a checkpoint raises in
    ``make_reward_fn``."""
    from consolver_torch.rewards.registry import RewardModel, make_reward_fn

    rtype = cfg.reward.reward_type
    ckpt = cfg.reward.encoder_checkpoint
    model = RewardModel()
    if rtype in ("dino", "clip", "inception") and ckpt:
        model = RewardModel(encode=load_encoder(rtype, ckpt, device))
    elif rtype in ("llava", "qwen_vl") and ckpt:
        raise SystemExit(f"reward {rtype!r}: the VLM judges' loaders are not ported yet "
                         "(ROADMAP A.16.8)")
    elif rtype != "image_psnr" and not ckpt:
        print(f"[smoke mode] reward {rtype!r} needs encoder_checkpoint; using image_psnr")
        rtype = "image_psnr"
    return make_reward_fn(rtype, model)


def teacher_batches(dataset, global_batch: int, shuffle: bool):
    """Endless global batches of the teacher set, one epoch after another;
    raises when the set holds fewer samples than one batch."""
    if len(dataset) < global_batch:
        raise ValueError(
            f"the teacher set under {dataset.root} holds {len(dataset)} samples, fewer than one "
            f"global batch of {global_batch} (data.batch_size x data-parallel ranks): no batch "
            "could be formed")

    def batches():
        epoch = 0
        while True:
            yield from dataset.batches(global_batch, seed=epoch, shuffle=shuffle)
            epoch += 1

    return batches()


def main(argv=None):
    from consolver_torch.data.group import TeacherDataset
    from consolver_torch.dist import mesh as meshlib
    from consolver_torch.rl.train import PPOTrainer
    from consolver_torch.utils.logging import MetricLogger

    cfg, device = parse_args(argv)
    device = resolve_device(device)
    mesh = meshlib.mesh_from_config(cfg.dist.data_parallel, cfg.dist.model_parallel,
                                    device=device)
    if mesh is not None:
        device = mesh.device
    # data.batch_size is PER SHARD (the reference's per-process batch)
    global_batch = cfg.data.batch_size * meshlib.data_axis_size(mesh)
    batches = teacher_batches(TeacherDataset(cfg.data.train_data_dir), global_batch,
                              cfg.data.shuffle)
    pipe = build_pipeline(cfg, make_policy(cfg.factor_net, cfg.train.seed, device), device)
    if cfg.model.quantize_rollout and not pipe.unet.cfg.quant_int8:
        # the int8 rollout environment (the hybrid: UNet level 0 stays bf16);
        # an int8 serving checkpoint (quant_int8 in its sidecar) is kept
        pipe = pipe.quantize()
    reward_fn = build_reward(cfg, device)
    trainer = PPOTrainer(pipe, reward_fn, cfg.train, mesh=mesh)
    trainer.resume_from_checkpoint("latest")
    logger = MetricLogger(cfg.train.output_dir, config=dataclasses.asdict(cfg))
    trainer.fit(batches, log_fn=logger.log)
    trainer.save_checkpoint()
    logger.close()
    return trainer


if __name__ == "__main__":
    main()
