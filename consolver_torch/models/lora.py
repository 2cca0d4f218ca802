"""LoRA merging for the distilled baselines (LCM-LoRA on the SD UNet).

Port of ``consolver_tpu/models/lora.py``.  A LoRA file holds low-rank pairs
``down`` / A ``[r, in]`` and ``up`` / B ``[out, r]`` per module (and, in
kohya files, an ``.alpha``); merging folds them into the weights once, at
load: ``W' = W + scale * (alpha / r) * B @ A``, computed in float32 and cast
back to the weight's dtype, so the merged model runs at full speed.

Key styles read (:func:`collect_lora_pairs`): peft ``<path>.lora_A`` /
``lora_B`` (with or without ``.default``), the old diffusers attention
processor ``<path>_lora.down`` / ``.up``, and kohya ``lora_unet_<path with
underscores>_lora_down`` / ``_lora_up`` with ``.alpha``.  The merge works
on the port's diffusers-keyed ``state_dict`` and reaches what the JAX merge
reaches: dotted paths wherever they name a weight, and kohya underscore
paths only for the attention projections of transformer blocks (the JAX
package's regex).  A target that is not in the state dict raises
``KeyError``; a conv-shaped pair (4-D down / up, LCM-LoRA's resnets) raises
``ValueError``, because the JAX merge's ``up @ down`` cannot merge it.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

_KOHYA_ATTENTION = re.compile(
    r"(down_blocks|up_blocks|mid_block)_?(\d+)?_attentions_(\d+)_transformer_blocks_(\d+)_"
    r"(attn\d)_(to_\w+?)(?:_0)?$")


def _to_tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().float()
    return torch.as_tensor(np.asarray(value, np.float32))


def collect_lora_pairs(state_dict: Mapping[str, Any]
                       ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor, float]]:
    """Group LoRA tensors into ``{module path: (down / A [r, in], up / B
    [out, r], alpha / r)}``; alpha defaults to r."""
    downs, ups, alphas = {}, {}, {}
    for key, value in state_dict.items():
        k = key
        if k.startswith("lora_unet_"):  # kohya: lora_unet_down_blocks_0_..._lora_down.weight
            k = k[len("lora_unet_"):]
            if k.endswith(".alpha"):
                alphas[k[: -len(".alpha")].replace("_lora", "")] = float(_to_tensor(value))
                continue
            m = re.match(r"(.*)_lora_(down|up)\.weight$", k)
            if m:
                (downs if m.group(2) == "down" else ups)[m.group(1)] = _to_tensor(value)
            continue
        for pattern, table in ((r"(.*)\.lora_A(?:\.default)?\.weight$", downs),
                               (r"(.*)\.lora_B(?:\.default)?\.weight$", ups),
                               (r"(.*)_lora\.down\.weight$", downs),
                               (r"(.*)_lora\.up\.weight$", ups)):
            m = re.match(pattern, k)
            if m:
                table[m.group(1)] = _to_tensor(value)
                break
        else:
            if k.endswith(".alpha"):
                alphas[k[: -len(".alpha")]] = float(_to_tensor(value))

    pairs = {}
    for base, down in downs.items():
        up = ups.get(base)
        if up is None:
            continue
        r = down.shape[0]
        pairs[base] = (down, up, alphas.get(base, float(r)) / r)
    return pairs


def target_key(base: str) -> str:
    """The ``state_dict`` weight key a LoRA module path merges into."""
    key = re.sub(r"processor\.?", "", base.replace("_lora", ""))
    if "." in key:
        return key + ".weight"
    m = _KOHYA_ATTENTION.match(key)
    if m:
        blk, bi, ai, ti, attn, proj = m.groups()
        block = f"{blk}.{bi}" if bi is not None else blk
        proj = "to_out.0" if proj.startswith("to_out") else proj
        return f"{block}.attentions.{ai}.transformer_blocks.{ti}.{attn}.{proj}.weight"
    raise KeyError(f"Cannot map LoRA key {base!r} to a state_dict key")


def merge_lora(state_dict: Mapping[str, torch.Tensor], lora_state: Mapping[str, Any],
               scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """A copy of ``state_dict`` with every LoRA pair of ``lora_state`` merged
    into its weight (new tensors for the merged weights; the others are
    shared).  Unmatched targets raise: a silent drop would change quality
    unseen."""
    out = dict(state_dict)
    for base, (down, up, alpha_scale) in collect_lora_pairs(lora_state).items():
        key = target_key(base)
        if key not in out:
            raise KeyError(f"LoRA target {key!r} (from {base!r}) not found")
        if down.ndim != 2 or up.ndim != 2:
            raise ValueError(f"LoRA pair {base!r} is conv-shaped ({tuple(down.shape)}, "
                             f"{tuple(up.shape)}): only linear pairs are merged")
        weight = out[key]
        if weight.shape != (up.shape[0], down.shape[1]):
            raise ValueError(f"LoRA pair {base!r} gives {(up.shape[0], down.shape[1])}, "
                             f"the weight {key!r} is {tuple(weight.shape)}")
        delta = (up.to(weight.device) @ down.to(weight.device)) * (alpha_scale * scale)
        out[key] = (weight.float() + delta).to(weight.dtype)
    return out
