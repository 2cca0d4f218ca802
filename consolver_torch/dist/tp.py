"""Tensor parallelism of the large denoisers by regex rules over module paths.

Port of ``consolver_tpu/dist/tp.py``.  The JAX package places parameters with
PartitionSpecs and XLA inserts the collectives; here each matched layer is
swapped in place for a wrapper that holds this rank's slice and runs the
collective itself (the Megatron cut):

* ``"column"``: the output features split; attention q/k/v and MLP
  up-projections, so each rank runs ``num_heads // tp`` heads;
* ``"row"``: the input features split; the partial products are summed by
  one all_reduce over the model group, then the bias is added.  The layer
  takes this rank's slice of its input, or the full input, which it slices;
* ``"gathered"``: a column split whose output is all_gathered back to full
  width: the adaLN modulation linears, the DiT's largest weights, whose
  six / three / two chunks modulate the full-width residual stream.

A layer whose fused output (or input) is a concatenation of parts, as
GEGLU's ``[h | gate]`` or the single-stream ``proj_out``'s ``[attn | mlp]``
input, declares them in ``tp_parts``; each part is split by rank, so that a
rank's slice is ``[h_r | gate_r]``, never the first half of the whole.

Quantized layers follow the JAX rules for their leaves
(``consolver_tpu/dist/tp.py::_spec_for_leaf``): ``Int8Linear.kernel`` is
``[out, in]`` here (``[in, out]`` in JAX), so a column split cuts its rows and
``kernel_scale [out]`` with them; a row split cuts its columns, keeps the
scale whole, takes the per-token activation scale from the all-reduced
maximum and sums the int32 accumulators (exact).  ``Int4Linear`` keeps JAX's
``kernel_packed [in // 2, out]`` and ``kernel_scale [groups, out]``: a row
split cuts whole bytes and whole scale groups.  A layer whose split does not
divide (or would cut a byte, a scale group, or an int8 GEMM dim below a
multiple of 8) stays replicated, as JAX's divisibility guard.

:data:`stats` counts the collectives the wrappers run; with
``stats.timing`` on, each is bracketed by ``torch.cuda.synchronize()`` and
its host time recorded (a measurement mode).
"""

from __future__ import annotations

import re
import time
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from consolver_torch.dist.mesh import Mesh
from consolver_torch.kernels.quant import INV127, Int4Linear, Int8Linear, _dequantize, int_mm

COLUMN, ROW, GATHERED = "column", "row", "gathered"
Rules = Sequence[Tuple[str, str]]

# The FLUX DiT (module paths of models/flux.py, the JAX module names).
FLUX_TP_RULES: Rules = (
    (r"attn_(to|add)_(q|k|v)$", COLUMN),
    (r"attn_to_out_0$", ROW),
    (r"attn_to_add_out$", ROW),
    (r"ff(_context)?_net_0_proj$", COLUMN),
    (r"ff(_context)?_net_2$", ROW),
    (r"proj_mlp$", COLUMN),
    (r"proj_out$", ROW),
    (r"norm1(_context)?_linear$", GATHERED),
    (r"norm_linear$", GATHERED),
    (r"norm_out_linear$", GATHERED),
)

# The SD UNet's transformer blocks (diffusers' names, models/layers.py);
# the convolutions stay replicated.
UNET_TP_RULES: Rules = (
    (r"\.to_(q|k|v)$", COLUMN),
    (r"\.to_out\.0$", ROW),
    (r"\.ff\.net\.0\.proj$", COLUMN),
    (r"\.ff\.net\.2$", ROW),
)

LINEAR_LAYERS = (nn.Linear, Int8Linear, Int4Linear)


class CollectiveStats:
    """Counts of the wrappers' collectives and, with ``timing``, their ms."""

    def __init__(self):
        self.timing = False
        self.reset()

    def reset(self) -> None:
        self.counts: Counter = Counter()
        self.ms: Counter = Counter()

    def run(self, kind: str, fn):
        self.counts[kind] += 1
        if not self.timing:
            return fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        self.ms[kind] += (time.perf_counter() - t0) * 1e3
        return out


stats = CollectiveStats()


def _all_reduce(mesh: Mesh, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    name = "all_reduce" if op == dist.ReduceOp.SUM else "all_reduce_max"
    return stats.run(name, lambda: mesh.all_reduce(t, "model", op))


def _part_index(parts: Sequence[int], tp: int, rank: int) -> torch.Tensor:
    """Indices of rank ``rank``'s slice of every part."""
    idx, start = [], 0
    for size in parts:
        per = size // tp
        idx.append(torch.arange(start + rank * per, start + (rank + 1) * per))
        start += size
    return torch.cat(idx)


def _param(t: torch.Tensor, like: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t.contiguous(), requires_grad=like.requires_grad)


def _splittable(layer: nn.Module, kind: str, parts: Sequence[int], tp: int) -> bool:
    """The divisibility guard: every part divides by ``tp`` and the slice is
    one the layer's format can hold."""
    if any(p % tp for p in parts):
        return False
    if isinstance(layer, Int8Linear):
        return all((p // tp) % 8 == 0 for p in parts)  # the int8 GEMM's K / N
    if isinstance(layer, Int4Linear) and kind == ROW:
        groups = layer.kernel_scale.shape[0]
        unit = 2 if groups == 1 else layer.in_features // groups
        return all((p // tp) % unit == 0 for p in parts)  # whole bytes, whole groups
    return True


def _column_slice(layer: nn.Module, idx: torch.Tensor) -> nn.Module:
    """A layer of the same kind holding output features ``idx``."""
    idx = idx.to(next(iter(layer.state_dict().values())).device)
    n = len(idx)
    if isinstance(layer, nn.Linear):
        out = nn.Linear(layer.in_features, n, bias=layer.bias is not None, device="meta")
        out.weight = _param(layer.weight[idx], layer.weight)
        if layer.bias is not None:
            out.bias = _param(layer.bias[idx], layer.bias)
        return out
    if isinstance(layer, Int8Linear):
        out = Int8Linear(layer.in_features, n, bias=layer.bias is not None)
        out.kernel, out.kernel_scale = layer.kernel[idx], layer.kernel_scale[idx]
    else:
        out = Int4Linear(layer.in_features, n, bias=layer.bias is not None,
                         group_size=layer.group_size)
        out.kernel_packed, out.kernel_scale = layer.kernel_packed[:, idx], layer.kernel_scale[:, idx]
    if layer.bias is not None:
        out.bias = layer.bias[idx]
    return out


def _row_slice(layer: nn.Module, idx: torch.Tensor) -> nn.Module:
    """A layer of the same kind holding input features ``idx`` (the bias is
    kept whole: the wrapper adds it once, after the sum)."""
    idx = idx.to(next(iter(layer.state_dict().values())).device)
    n = len(idx)
    if isinstance(layer, nn.Linear):
        out = nn.Linear(n, layer.out_features, bias=False, device="meta")
        out.weight = _param(layer.weight[:, idx], layer.weight)
        return out
    if isinstance(layer, Int8Linear):
        out = Int8Linear(n, layer.out_features, bias=False)
        out.kernel, out.kernel_scale = layer.kernel[:, idx], layer.kernel_scale
        return out
    groups = layer.kernel_scale.shape[0]
    out = Int4Linear(n, layer.out_features, bias=False, group_size=layer.group_size)
    out.kernel_packed = layer.kernel_packed[idx[::2] // 2]
    if groups > 1:
        out.kernel_scale = layer.kernel_scale[idx[::layer.in_features // groups]
                                              // (layer.in_features // groups)]
    else:
        out.kernel_scale = layer.kernel_scale
    return out


class ColumnParallel(nn.Module):
    """This rank's output features of ``layer`` (``local``); with ``gather``
    the full output, all_gathered over the model group."""

    def __init__(self, layer: nn.Module, mesh: Mesh, parts: Sequence[int], gather: bool):
        super().__init__()
        self.mesh, self.parts, self.gather = mesh, tuple(parts), gather
        self.local = _column_slice(layer, _part_index(parts, mesh.tp, mesh.model_rank))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.local(x)
        if not self.gather:
            return y
        chunks = stats.run("all_gather", lambda: self.mesh.all_gather(y[None], "model"))
        # [tp, ..., out / tp] -> [..., out]: rank r's slice of each part, in part order
        per = [p // self.mesh.tp for p in self.parts]
        pieces = [c.split(per, dim=-1) for c in chunks]
        return torch.cat([pieces[r][i] for i in range(len(per)) for r in range(self.mesh.tp)],
                         dim=-1)


class RowParallel(nn.Module):
    """This rank's input features of ``layer`` (``local``); the partial
    products are summed over the model group, then ``bias`` is added."""

    def __init__(self, layer: nn.Module, mesh: Mesh, parts: Sequence[int]):
        super().__init__()
        self.mesh, self.parts = mesh, tuple(parts)
        idx = _part_index(parts, mesh.tp, mesh.model_rank)
        self.register_buffer("index", idx.to(next(iter(layer.state_dict().values())).device),
                             persistent=False)
        self.in_features = sum(parts)
        self.local = _row_slice(layer, idx)
        bias = layer.bias
        if isinstance(layer, nn.Linear):
            self.bias = None if bias is None else _param(bias.detach(), bias)
        else:
            self.register_buffer("bias", bias)

    def partial(self, x: torch.Tensor):
        """(the partial product ``[tokens, out]`` to sum, the context
        :meth:`finish` needs)."""
        if x.shape[-1] == self.in_features:
            x = x.index_select(-1, self.index)
        lead = x.shape[:-1]
        x = x.reshape(-1, x.shape[-1])
        local = self.local
        if isinstance(local, Int8Linear):
            x32 = x.float()
            amax = _all_reduce(self.mesh, x32.abs().amax(dim=-1, keepdim=True), dist.ReduceOp.MAX)
            a_scale = amax.clamp_min(1e-8) * INV127
            xq = torch.clamp(torch.round(x32 / a_scale), -127, 127).to(torch.int8)
            return int_mm(xq, local.kernel), (lead, x.dtype, a_scale)
        if isinstance(local, Int4Linear):
            return local(x), (lead, x.dtype, None)
        return F.linear(x, local.weight.to(x.dtype)), (lead, x.dtype, None)

    def finish(self, y: torch.Tensor, ctx) -> torch.Tensor:
        lead, dtype, a_scale = ctx
        if a_scale is not None:
            y = _dequantize(y, a_scale, self.local.kernel_scale, self.bias, dtype)
        elif self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y.reshape(*lead, y.shape[-1])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, ctx = self.partial(x)
        return self.finish(_all_reduce(self.mesh, y), ctx)


def is_sharded(module: nn.Module) -> bool:
    """Whether ``module`` holds a tensor-parallel layer (its forward runs
    collectives over the model group)."""
    return any(isinstance(m, (ColumnParallel, RowParallel)) for m in module.modules())


def row_parallel_pair(layer_a: nn.Module, x_a: torch.Tensor, layer_b: nn.Module,
                      x_b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(layer_a(x_a), layer_b(x_b))``; two row-parallel layers sum their
    partial products in ONE all_reduce (the double-stream block's image and
    text projections)."""
    if not (isinstance(layer_a, RowParallel) and isinstance(layer_b, RowParallel)):
        return layer_a(x_a), layer_b(x_b)
    (ya, ca), (yb, cb) = layer_a.partial(x_a), layer_b.partial(x_b)
    if ya.dtype != yb.dtype:
        return layer_a.finish(_all_reduce(layer_a.mesh, ya), ca), layer_b.finish(
            _all_reduce(layer_b.mesh, yb), cb)
    both = _all_reduce(layer_a.mesh, torch.cat([ya, yb]))
    return layer_a.finish(both[:len(ya)], ca), layer_b.finish(both[len(ya):], cb)


def _rule_for(path: str, rules: Rules) -> Optional[str]:
    for pattern, kind in rules:
        if re.search(pattern, path):
            return kind
    return None


@torch.no_grad()
def shard_module_by_rules(mesh: Mesh, module: nn.Module, rules: Rules,
                          prefix: str = "") -> Dict[str, List[str]]:
    """Swap every linear layer whose path (``prefix`` + its name in
    ``module``) matches a rule for its column / row wrapper, in place.
    Returns the paths by kind, with ``"replicated"`` for matched layers the
    divisibility guard kept whole.  A mesh without a model axis changes
    nothing."""
    report: Dict[str, List[str]] = {COLUMN: [], ROW: [], GATHERED: [], "replicated": []}
    if mesh.tp == 1:
        return report
    for name, layer in list(module.named_modules()):
        path = prefix + name
        kind = _rule_for(path, rules) if isinstance(layer, LINEAR_LAYERS) else None
        if kind is None:
            continue
        width = layer.in_features if kind == ROW else layer.out_features
        parts = getattr(layer, "tp_parts", (width,))
        if not _splittable(layer, kind, parts, mesh.tp):
            report["replicated"].append(path)
            continue
        wrapped = (RowParallel(layer, mesh, parts) if kind == ROW
                   else ColumnParallel(layer, mesh, parts, gather=kind == GATHERED))
        parent_name, _, attr = name.rpartition(".")
        module.get_submodule(parent_name)._modules[attr] = wrapped
        report[kind].append(path)
    return report
