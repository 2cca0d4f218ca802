"""Small state-dict utilities shared by the loaders and the CLIs.

Port of ``consolver_tpu/utils/trees.py``.  Converted checkpoints are stored
in f32 (the hub's own dtype); the frozen model stack runs in
``model.dtype``, so the loaders cast once at load time, as the reference
casts its models to ``weight_dtype`` before training (train_ppo.py:156-165).
"""

from __future__ import annotations

from typing import Dict, Union

import torch
from torch import nn


def cast_floating(tree: Union[Dict[str, torch.Tensor], nn.Module, torch.Tensor], dtype):
    """Cast every floating tensor of a ``state_dict``, a module (in place;
    parameters and buffers) or a single tensor to ``dtype``; integer tensors
    (int8 kernels, packed int4 bytes, token tables) are returned untouched."""
    def cast(t: torch.Tensor) -> torch.Tensor:
        return t.to(dtype) if t.is_floating_point() else t

    if torch.is_tensor(tree):
        return cast(tree)
    if isinstance(tree, nn.Module):
        return tree._apply(cast)
    return {k: cast(v) for k, v in tree.items()}
