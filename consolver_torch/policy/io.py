"""Policy checkpoint IO, shared by the serving engines' hot reload and the
trainers' export.

Port of ``consolver_tpu/policy/io.py`` for the port's own three formats: a
trainer ``checkpoint-{step}/state.pt`` (``rl/checkpointing.py``), a
``save_pretrained`` export (``factor_net.pt`` + ``factor_net_config.json``)
and a converted reference ``model.ckpt`` (``python -m consolver_torch
convert --kind factor_net``: ``model.safetensors`` + a sibling
``{dir}_factor_net_config.json``).
The dims ride with the checkpoint in the JSON sidecar, so a load cannot
silently mismatch the trained action grid.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Tuple

import torch

from consolver_torch.policy.factor_net import FactorNet, FactorNetConfig

CONFIG_FILE = "factor_net_config.json"
EXPORT_FILE = "factor_net.pt"
TRAINER_STATE_FILE = "state.pt"
CONVERTED_FILE = "model.safetensors"


def save_factor_net(net: FactorNet, output_dir: str) -> str:
    """The ``save_pretrained`` export: ``factor_net.pt`` (the state dict)
    and ``factor_net_config.json`` in ``output_dir``; returns the .pt path."""
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(output_dir, EXPORT_FILE))
    torch.save(net.state_dict(), path)
    with open(os.path.join(output_dir, CONFIG_FILE), "w") as f:
        json.dump(dataclasses.asdict(net.config), f, indent=2)
    return path


def _sidecar_config(path: str, default_cfg: FactorNetConfig) -> FactorNetConfig:
    stripped = path.rstrip("/")
    candidates = (
        stripped + "_" + CONFIG_FILE,  # a converter's sibling sidecar
        os.path.join(path, CONFIG_FILE),  # save_pretrained: the export directory
        os.path.join(os.path.dirname(stripped), CONFIG_FILE),  # ... or a file in it
    )
    for cfg_path in candidates:
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                return FactorNetConfig(**json.load(f))
    return default_cfg


def _state_file(path: str) -> str:
    if os.path.isfile(path):
        return path
    for name in (TRAINER_STATE_FILE, EXPORT_FILE, CONVERTED_FILE):
        if os.path.isfile(os.path.join(path, name)):
            return os.path.join(path, name)
    raise FileNotFoundError(f"no {TRAINER_STATE_FILE}, {EXPORT_FILE} or {CONVERTED_FILE} at "
                            f"{path}")


def load_factor_ckpt(path: str, default_cfg: FactorNetConfig
                     ) -> Tuple[FactorNetConfig, Dict[str, torch.Tensor]]:
    """``(FactorNetConfig, state_dict on the CPU)`` from a trainer
    ``checkpoint-{step}`` directory, a ``save_pretrained`` export (its
    directory or its ``factor_net.pt``) or a converted component.  A ``factor_net_config.json``
    beside the checkpoint (or in its parent) overrides ``default_cfg``;
    parameters whose shapes do not fit the config raise ``ValueError``."""
    cfg = _sidecar_config(path, default_cfg)
    state_file = _state_file(path)
    if state_file.endswith(".safetensors"):
        from consolver_torch.models.checkpoint import load_file

        payload = load_file(state_file)
    else:
        payload = torch.load(state_file, map_location="cpu", weights_only=True)
    # a trainer checkpoint holds the policy beside the optimizer and step
    state = payload["policy"] if "optimizer" in payload else payload
    want = {k: tuple(v.shape) for k, v in FactorNet(cfg, device="meta").state_dict().items()}
    got = {k: tuple(v.shape) for k, v in state.items()}
    if got != want:
        raise ValueError(f"checkpoint {path} does not fit {cfg}: parameters {got}, want {want}")
    return cfg, state
