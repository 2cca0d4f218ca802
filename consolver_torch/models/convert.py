"""JAX (flax) parameter tree -> torch state dict.

The inverse of ``consolver_tpu/models/convert.py``'s walk: a flax tree of
nested dicts of numpy arrays becomes a flat torch state dict.

  * a trailing ``_N`` on a module name becomes a ``.N`` list index;
  * a 4-D ``kernel`` (HWIO) becomes ``weight`` (OIHW);
  * a 2-D ``kernel`` (in, out) becomes ``weight`` (out, in);
  * ``scale`` (norms) and ``embedding`` (embedding tables) become ``weight``;
  * a quantized tree's integer leaves keep their dtype: an int8 ``kernel``
    keeps its name and takes the port's int8 layouts (``[out, in]`` for a
    dense kernel, ``[out, kh, kw, in]`` for a conv), an int4
    ``kernel_packed`` (uint8 ``[in // 2, out]``) and every ``kernel_scale``
    load as they are.  Float leaves become f32 as before.

:func:`load_jax_params` matches the result to a module's own key names by
merging list indices back (``linear.1`` and ``linear_1`` name one key), so
names such as diffusers' ``time_embedding.linear_1`` load as they are.  The
FactorNet's ``fc0/fc1/head`` take ``kernel.T`` and ``bias`` by the same rules,
and so do the FLUX and T5 trees: ``transformer_blocks_N`` /
``single_transformer_blocks_N`` / ``block_N`` become list indices,
``attn_to_out_0`` and ``wi_0`` match the port's attributes of those names,
``QKNorm.scale`` / ``T5LayerNorm.scale`` become ``weight``, and the
``shared`` and ``relative_attention_bias`` embeddings load untransposed.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn


def _leaf(path: Tuple[str, ...], value: np.ndarray) -> Tuple[Tuple[str, ...], np.ndarray]:
    *prefix, leaf = path
    if leaf == "kernel" and value.dtype == np.int8:
        if value.ndim == 4:  # HWIO -> OHWI
            return path, value.transpose(3, 0, 1, 2)
        if value.ndim == 2:  # (in, out) -> (out, in)
            return path, value.T
        raise ValueError(f"Unexpected int8 kernel ndim {value.ndim} at {path}")
    if leaf == "kernel":
        if value.ndim == 4:  # HWIO -> OIHW
            return (*prefix, "weight"), value.transpose(3, 2, 0, 1)
        if value.ndim == 2:  # (in, out) -> (out, in)
            return (*prefix, "weight"), value.T
        raise ValueError(f"Unexpected kernel ndim {value.ndim} at {path}")
    if leaf in ("scale", "embedding"):
        return (*prefix, "weight"), value
    return path, value


def state_dict_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax param tree (with or without the ``{"params": ...}`` wrapper) ->
    torch state dict of CPU tensors: f32, or the integer leaves' own dtype."""
    if set(tree.keys()) == {"params"}:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], prefix: Tuple[str, ...]) -> None:
        for name, child in node.items():
            if isinstance(child, Mapping):
                walk(child, prefix + (re.sub(r"_(\d+)$", r".\1", name),))
                continue
            value = np.asarray(child)
            if not np.issubdtype(value.dtype, np.integer):
                value = value.astype(np.float32)
            path, value = _leaf(prefix + (name,), value)
            out[".".join(path)] = torch.from_numpy(np.ascontiguousarray(value))

    walk(tree, ())
    return out


def _canonical(key: str) -> str:
    """Merge list indices into their parent: 'a.linear.1.weight' and
    'a.linear_1.weight' both -> 'a.linear_1.weight'."""
    parts: list[str] = []
    for comp in key.split("."):
        if comp.isdigit() and parts:
            parts[-1] = f"{parts[-1]}_{comp}"
        else:
            parts.append(comp)
    return ".".join(parts)


def load_jax_params(module: nn.Module, tree: Mapping[str, Any]) -> nn.Module:
    """Load a flax param tree into ``module`` (``strict=True``): every key of
    the module must be present, with its shape, and nothing else."""
    by_canonical = {_canonical(k): k for k in module.state_dict()}
    converted = {}
    for key, value in state_dict_from_jax(tree).items():
        target = by_canonical.get(_canonical(key), key)
        converted[target] = value
    module.load_state_dict(converted, strict=True)
    return module
