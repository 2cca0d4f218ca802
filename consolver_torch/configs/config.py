"""Typed experiment configuration with a thin command-line overlay.

Port of ``consolver_tpu/configs/config.py``: frozen dataclasses whose every
field is overridable as ``--set section.field=value``, and the production
presets of the reference launch scripts (run_ppo.sh, edit_ppo/run_ppo.sh).
The policy, PPO and trainer sections are the port's own
:class:`~consolver_torch.policy.factor_net.FactorNetConfig`,
:class:`~consolver_torch.rl.ppo.PPOConfig` and
:class:`~consolver_torch.rl.train.TrainConfig`, whose fields equal the JAX
package's one for one.  The port adds one flag, ``--device`` (default: the
card).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import typing
from typing import Any, Optional, get_args, get_origin

from consolver_torch.policy.factor_net import FactorNetConfig
from consolver_torch.rl.ppo import PPOConfig
from consolver_torch.rl.train import TrainConfig


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    family: str = "sd15"  # "sd15" | "flux"
    pretrained_path: Optional[str] = None  # converted checkpoint dir
    resolution: int = 512
    dtype: str = "bfloat16"
    # Run the frozen rollout denoiser and VAE decoder through the pipeline's
    # ``quantize()`` (the policy update is untouched), so the policy trains
    # against the quantized serving environment it is deployed into.
    quantize_rollout: bool = False
    # The FLUX family's bits for quantize_rollout: 8 = W8A8 int8, 4 = packed
    # int4 weights computed in bf16.  The SD UNet is int8 only.
    quantize_bits: int = 8


@dataclasses.dataclass(frozen=True)
class DataConfig:
    train_data_dir: str = "data/teacher/sd15"
    # PER-SHARD batch, like the reference's per-process train_batch_size;
    # the training CLIs feed batch_size * data_parallel to the dataset
    batch_size: int = 80
    shuffle: bool = False


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """Rank topology: ``data_parallel`` shards the group batch (one prompt
    group per shard), ``model_parallel`` splits the frozen denoiser by
    ``dist/tp.py``'s rules.  Requests larger than the world clamp to it
    (``dist.mesh.mesh_from_config``)."""

    data_parallel: int = 1
    model_parallel: int = 1


@dataclasses.dataclass(frozen=True)
class RewardConfig:
    reward_type: str = "depth"  # run_ppo.sh: depth; edit_ppo: dino
    encoder_checkpoint: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    dist: DistConfig = dataclasses.field(default_factory=DistConfig)
    reward: RewardConfig = dataclasses.field(default_factory=RewardConfig)
    factor_net: FactorNetConfig = dataclasses.field(default_factory=FactorNetConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)

    @classmethod
    def sd15_ppo(cls) -> "ExperimentConfig":
        """Production SD-1.5 PPO preset (run_ppo.sh:5-33): 1 process, bs=80,
        lr=1e-4, wd=1e-3, 3001 steps, ckpt every 100 keep 20, seed
        453645634, order_dim=4, scaler_dim=0, 11 actions, reward=depth,
        ppo_epochs=1, cfg=3."""
        return cls(
            model=ModelConfig(family="sd15", resolution=512),
            data=DataConfig(batch_size=80),
            dist=DistConfig(data_parallel=1),
            reward=RewardConfig(reward_type="depth"),
            factor_net=FactorNetConfig(
                order_dim=4, scaler_dim=0, num_actions=11, hidden_dim=256, family="sd"
            ),
            train=TrainConfig(
                max_train_steps=3001,
                guidance_scale=3.0,
                checkpointing_steps=100,
                checkpoints_total_limit=20,
                seed=453645634,
                ppo=PPOConfig(
                    ppo_epochs=1,
                    clip_range=0.2,
                    entropy_coef=0.01,
                    learning_rate=1e-4,
                    weight_decay=1e-3,
                    advantage_scale=10.0,
                ),
            ),
        )

    @classmethod
    def flux_ppo(cls) -> "ExperimentConfig":
        """Production FLUX-Kontext PPO preset (edit_ppo/run_ppo.sh:5-32):
        8 data-parallel ranks, bs=10 a rank (global 80, 8 groups), lr=1e-3,
        wd=1e-3, 1001 steps, ckpt every 100 keep 20, seed 453645634,
        order_dim=2, 11 actions, reward=dino, ppo_epochs=4, cfg=2.5, steps
        in [2, 6)."""
        return cls(
            model=ModelConfig(family="flux", resolution=1024),
            data=DataConfig(batch_size=10, train_data_dir="data/teacher/flux"),
            dist=DistConfig(data_parallel=8),
            reward=RewardConfig(reward_type="dino"),
            factor_net=FactorNetConfig(
                order_dim=2, scaler_dim=0, mu_dim=0, num_actions=11,
                hidden_dim=256, family="fm",
            ),
            train=TrainConfig(
                max_train_steps=1001,
                guidance_scale=2.5,
                min_inference_steps=2,
                max_inference_steps=6,
                checkpointing_steps=100,
                checkpoints_total_limit=20,
                seed=453645634,
                ppo=PPOConfig(
                    ppo_epochs=4,
                    clip_range=0.2,
                    entropy_coef=0.01,
                    learning_rate=1e-3,
                    weight_decay=1e-3,
                    advantage_scale=1.0,
                ),
            ),
        )


PRESETS = {"sd15_ppo": ExperimentConfig.sd15_ppo, "flux_ppo": ExperimentConfig.flux_ppo,
           "default": ExperimentConfig}


def _coerce(value: Any, typ: Any) -> Any:
    if not isinstance(value, str):
        # an already-typed value from a programmatic caller: coercion exists
        # for the command line's "--set k=v" strings
        return value
    if get_origin(typ) is not None:  # Optional[...] etc.
        args = [a for a in get_args(typ) if a is not type(None)]
        if value.lower() in ("none", "null"):
            return None
        return _coerce(value, args[0])
    if typ is bool:
        return value.lower() in ("1", "true", "yes")
    if typ in (int, float, str):
        return typ(value)
    return json.loads(value)


def apply_overrides(config: Any, overrides: dict) -> Any:
    """Apply dotted-path overrides ('train.ppo.learning_rate' -> value) to a
    frozen dataclass tree, returning a new tree."""
    for path, raw in overrides.items():
        config = _apply_one(config, path.split("."), raw)
    return config


def _apply_one(node: Any, parts: list, raw: Any) -> Any:
    name = parts[0]
    fields = {f.name for f in dataclasses.fields(node)}
    if name not in fields:
        raise KeyError(f"Unknown config field {name!r}; valid: {sorted(fields)}")
    if len(parts) == 1:
        hints = typing.get_type_hints(type(node))
        return dataclasses.replace(node, **{name: _coerce(raw, hints[name])})
    child = _apply_one(getattr(node, name), parts[1:], raw)
    return dataclasses.replace(node, **{name: child})


def add_device_flag(parser: argparse.ArgumentParser) -> None:
    """``--device``: the port's one flag beyond the JAX command line.  The
    default (None) is the card, and a command raises without one."""
    parser.add_argument("--device", default=None,
                        help="torch device (default: the GPU; 'cpu' runs the plain versions)")


def parse_args(argv: Optional[list] = None):
    """``--preset sd15_ppo|flux_ppo|default``, ``--set section.field=value``
    and ``--device``; returns ``(ExperimentConfig, device)``."""
    parser = argparse.ArgumentParser(description="consolver-torch")
    parser.add_argument("--preset", default="sd15_ppo", choices=sorted(PRESETS))
    parser.add_argument("--set", action="append", default=[], metavar="K=V")
    add_device_flag(parser)
    args = parser.parse_args(argv)
    overrides = dict(kv.split("=", 1) for kv in args.set)
    return apply_overrides(PRESETS[args.preset](), overrides), args.device


def parse_cli(argv: Optional[list] = None) -> ExperimentConfig:
    """The configuration of :func:`parse_args` alone (the JAX signature)."""
    return parse_args(argv)[0]
