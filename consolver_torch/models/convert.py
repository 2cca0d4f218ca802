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

A module with a ``jax_renames`` attribute (the reward backbones, whose keys
are the transformers / torchvision checkpoints') is loaded the other way
round: each of its keys is renamed as the JAX converter renames a
checkpoint key (the same table, copied into the model's file) and its leaf
found in the tree.  A 4-D kernel loads HWIO -> OIHW (a ``ConvTranspose2d``'s
``[k, k, in, out]`` -> ``[in, out, k, k]``; a depthwise ``[3, 3, 1, C]`` ->
``[C, 1, 3, 3]``), a 2-D one transposed, a 1-D ``scale`` as ``weight``, and
any other leaf reshaped to the module's shape (CLIP's ``[D]`` class token
and ``[N, D]`` positions from ``[1, 1, D]`` / ``[1, N, D]``).  A
BatchNorm's ``num_batches_tracked`` has no JAX leaf and keeps its value.
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
    """Flax param tree (with or without the ``{"params": ...}`` wrapper, or
    with more leaves beside it) ->
    torch state dict of CPU tensors: f32, or the integer leaves' own dtype."""
    if isinstance(tree.get("params"), Mapping):
        # {"params": ...} alone, or beside more leaves (the continuous
        # FactorNet's log_std)
        tree = {**tree["params"], **{k: v for k, v in tree.items() if k != "params"}}
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


def jax_path(key: str, ndim: int, renames) -> Tuple[str, ...]:
    """The JAX tree path that the JAX converter gives a checkpoint ``key``
    whose tensor has ``ndim`` dimensions (``consolver_tpu/models/convert.py::
    convert_state_dict``: the renames, merged list indices, the leaf rule)."""
    for pattern, repl in renames:
        key = re.sub(pattern, repl, key)
    *prefix, leaf = _canonical(key).split(".")
    if leaf == "weight":
        leaf = "kernel" if ndim in (2, 4) else "scale"
    return (*prefix, leaf)


def _load_renamed(module: nn.Module, tree: Mapping[str, Any]) -> nn.Module:
    if set(tree.keys()) == {"params"}:
        tree = tree["params"]
    leaves: Dict[Tuple[str, ...], np.ndarray] = {}

    def walk(node: Mapping[str, Any], prefix: Tuple[str, ...]) -> None:
        for name, child in node.items():
            if isinstance(child, Mapping):
                walk(child, prefix + (name,))
            else:
                leaves[prefix + (name,)] = np.asarray(child, np.float32)

    walk(tree, ())
    owners = dict(module.named_modules())
    state = {}
    for key, current in module.state_dict().items():
        if key.endswith("num_batches_tracked"):
            state[key] = current
            continue
        path = jax_path(key, current.ndim, module.jax_renames)
        if path not in leaves:
            raise KeyError(f"{key}: no leaf {'/'.join(path)} in the JAX tree")
        value = leaves.pop(path)
        if path[-1] == "kernel" and value.ndim == 4:
            transposed = isinstance(owners[key.rsplit(".", 1)[0]], nn.ConvTranspose2d)
            value = value.transpose(2, 3, 0, 1) if transposed else value.transpose(3, 2, 0, 1)
        elif path[-1] == "kernel":
            value = value.T
        else:
            value = value.reshape(current.shape)
        state[key] = torch.from_numpy(np.ascontiguousarray(value))
    if leaves:
        raise KeyError(f"JAX leaves the module has no key for: {sorted(leaves)[:8]}")
    module.load_state_dict(state, strict=True)
    return module


def load_jax_params(module: nn.Module, tree: Mapping[str, Any]) -> nn.Module:
    """Load a flax param tree into ``module`` (``strict=True``): every key of
    the module must be present, with its shape, and nothing else."""
    if hasattr(module, "jax_renames"):
        return _load_renamed(module, tree)
    by_canonical = {_canonical(k): k for k in module.state_dict()}
    converted = {}
    for key, value in state_dict_from_jax(tree).items():
        target = by_canonical.get(_canonical(key), key)
        converted[target] = value
    module.load_state_dict(converted, strict=True)
    return module
