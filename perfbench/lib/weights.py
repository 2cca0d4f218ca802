"""Seeded weights for every model a cell runs, and the same weights again for
the plain reference.

A model's parameters fall into groups: each top-level child of the module,
and each element of a top-level ``ModuleList`` (a UNet level, a DiT block).
A group's parameters of one dtype are drawn in one call, ``torch.randn`` on
the model's device from a generator seeded by ``(seed, model tag, group,
dtype)``, and split in the module's parameter order.  Every parameter is
0.02 * N(0, 1), except a 1-D ``weight`` (a norm's scale: LayerNorm,
GroupNorm, RMS norm, QK norm), which is 1 + 0.02 * N(0, 1); norm scales of
0.02 would squash every activation and leave a near-constant image, which
no comparison could tell from a wrong one.

The layout (group -> names, shapes, dtypes) is data: :class:`WeightSource`
draws any group again from the seed and the layout, so that the reference
never reads a tensor of the program.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

import torch

STD = 0.02

Entry = Tuple[str, Tuple[int, ...], str]  # full name, shape, dtype name
Layout = Dict[str, List[Entry]]  # group -> entries in parameter order


def _group_of(name: str, list_children: set) -> str:
    parts = name.split(".")
    if parts[0] in list_children:
        return ".".join(parts[:2])
    return parts[0] if len(parts) > 1 else ""


def layout_of(module: torch.nn.Module) -> Layout:
    """The module's groups, in parameter order."""
    list_children = {n for n, c in module.named_children()
                     if isinstance(c, (torch.nn.ModuleList, torch.nn.Sequential))}
    out: Layout = {}
    for name, p in module.named_parameters():
        out.setdefault(_group_of(name, list_children), []).append(
            (name, tuple(p.shape), str(p.dtype).replace("torch.", "")))
    return out


def _seed(seed: int, tag: str, group: str, dtype: str) -> int:
    digest = hashlib.sha256(f"{int(seed)}/{tag}/{group}/{dtype}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def draw_group(seed: int, tag: str, group: str, entries: List[Entry],
               device) -> Dict[str, torch.Tensor]:
    """name -> tensor for one group: one ``randn`` per dtype."""
    out: Dict[str, torch.Tensor] = {}
    for dtype_name in sorted({e[2] for e in entries}):
        mine = [e for e in entries if e[2] == dtype_name]
        dtype = getattr(torch, dtype_name)
        gen = torch.Generator(device=device).manual_seed(_seed(seed, tag, group, dtype_name))
        total = sum(_numel(e[1]) for e in mine)
        flat = torch.randn(total, generator=gen, device=device, dtype=dtype).mul_(STD)
        offset = 0
        for name, shape, _ in mine:
            n = _numel(shape)
            t = flat[offset:offset + n].view(shape)
            if len(shape) == 1 and name.endswith("weight"):
                t.add_(1.0)
            out[name] = t
            offset += n
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


@torch.no_grad()
def fill_(module: torch.nn.Module, seed: int, tag: str) -> Layout:
    """Fill every parameter of ``module`` (already on its device) from the
    seed; returns the layout that :class:`WeightSource` draws again."""
    layout = layout_of(module)
    params = dict(module.named_parameters())
    device = next(iter(params.values())).device
    for group, entries in layout.items():
        for name, t in draw_group(seed, tag, group, entries, device).items():
            params[name].copy_(t)
    return layout


class WeightSource:
    """The weights of one model, drawn again from the seed and the layout,
    in the dtype they are served in; a group is drawn on its first use."""

    def __init__(self, seed: int, tag: str, layout: Layout, device):
        self.seed, self.tag, self.layout, self.device = int(seed), tag, layout, device
        self._owner = {e[0]: g for g, entries in layout.items() for e in entries}
        self._cache: Dict[str, Dict[str, torch.Tensor]] = {}

    def group(self, group: str) -> Dict[str, torch.Tensor]:
        if group not in self._cache:
            self._cache[group] = draw_group(self.seed, self.tag, group, self.layout[group],
                                            self.device)
        return self._cache[group]

    def get(self, name: str) -> torch.Tensor:
        if name not in self._owner:
            raise KeyError(f"{self.tag}: no parameter {name!r} in the layout")
        return self.group(self._owner[name])[name]

    def __call__(self, name: str) -> torch.Tensor:
        """The parameter as f32, the reference's precision."""
        return self.get(name).float()

    def has(self, name: str) -> bool:
        return name in self._owner
