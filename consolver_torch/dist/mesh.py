"""The (data, model) rank mesh over ``torch.distributed``.

Port of ``consolver_tpu/dist/mesh.py``.  A rank is one process; the model
axis is the fastest, ``rank = data_rank * tp + model_rank``, the device
order of JAX's ``np.asarray(devices).reshape((dp, tp))``, so the contiguous
shard ``g`` of a batch lands on data rank ``g`` in both packages.  Each rank
belongs to one ``model_group`` (the ``tp`` ranks of its data rank, which
split the denoiser's layers) and one ``data_group`` (the ``dp`` ranks of its
model rank, which split the batch).

Device and backend: where the node has a card per rank, rank ``r`` takes
``cuda:{local_rank}`` over NCCL; where the ranks outnumber the cards they
share ``cuda:0`` over gloo (NCCL refuses two ranks on one device), and on
the CPU (``device="cpu"``) gloo carries CPU tensors.  Tensors stay where
they lie: gloo takes CUDA tensors for the three collectives used here (it
stages them through the host itself), so nothing moves to the CPU unless
the caller asked for it.

Only ``all_reduce``, ``all_gather`` and ``broadcast`` are used (gloo has no
``reduce_scatter``).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from consolver_torch.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place in a ``dp x tp`` mesh and its process groups."""

    rank: int
    world: int
    dp: int
    tp: int
    data_rank: int
    model_rank: int
    data_group: Any
    model_group: Any
    device: torch.device
    backend: str

    @property
    def axis_names(self) -> Tuple[str, ...]:
        """``("data",)``, or ``("data", "model")`` when the model axis splits."""
        return (DATA_AXIS, MODEL_AXIS) if self.tp > 1 else (DATA_AXIS,)

    @property
    def shape(self) -> dict:
        """Axis sizes by name, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, (self.dp, self.tp)))

    @property
    def is_primary(self) -> bool:
        return self.rank == 0

    # ------------------------------------------------------- collectives
    def _group(self, name: str):
        return {"world": None, "data": self.data_group, "model": self.model_group}[name]

    def all_reduce(self, t: torch.Tensor, group: str = "world", op=dist.ReduceOp.SUM) -> torch.Tensor:
        """Reduce ``t`` in place over ``group`` ("world", "data" or "model")."""
        dist.all_reduce(t, op=op, group=self._group(group))
        return t

    def all_gather(self, t: torch.Tensor, group: str = "data") -> torch.Tensor:
        """Every member's ``t`` concatenated along dim 0, in group order."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self._size(group))]
        dist.all_gather(parts, t, group=self._group(group))
        return torch.cat(parts)

    def broadcast(self, t: torch.Tensor, group: str = "world") -> torch.Tensor:
        """``t`` of the group's first member, in place on every member."""
        dist.broadcast(t, src=self._first(group), group=self._group(group))
        return t

    def broadcast_object(self, obj: Any = None) -> Any:
        """Rank 0's picklable ``obj`` on every rank (a pickle broadcast)."""
        box = [obj]
        device = self.device if self.backend == "nccl" else torch.device("cpu")
        dist.broadcast_object_list(box, src=0, device=device)
        return box[0]

    def barrier(self) -> None:
        """Every rank reaches this point (an all_reduce of one element, so
        that it also works for gloo on a card)."""
        self.all_reduce(torch.zeros(1, device=self.device))

    def _size(self, group: str) -> int:
        return {"world": self.world, "data": self.dp, "model": self.tp}[group]

    def _first(self, group: str) -> int:
        return {"world": 0, "data": self.model_rank, "model": self.data_rank * self.tp}[group]


# ---------------------------------------------------------------- setup
def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def _pick_device_and_backend(device, local_rank: int, local_world: int):
    """Card per rank over NCCL when the node has enough cards, else a shared
    ``cuda:0`` over gloo; the CPU over gloo when asked for."""
    device = resolve_device(device)
    if device.type != "cuda":
        return device, "gloo"
    if device.index is not None:
        return device, "gloo" if torch.cuda.device_count() < local_world else "nccl"
    if torch.cuda.device_count() >= local_world:
        return torch.device("cuda", local_rank), "nccl"
    return torch.device("cuda", 0), "gloo"


def init_distributed(device=None):
    """Join the process group from the torchrun environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``) over the backend the device calls for; returns
    (device, backend).  A process group already joined is reused."""
    local_rank = _env_int("LOCAL_RANK", 0)
    local_world = _env_int("LOCAL_WORLD_SIZE", _env_int("WORLD_SIZE", 1))
    device, picked = _pick_device_and_backend(device, local_rank, local_world)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
        port = os.environ["MASTER_PORT"]
        dist.init_process_group(picked, init_method=f"tcp://{addr}:{port}",
                                rank=_env_int("RANK", 0), world_size=_env_int("WORLD_SIZE", 1))
    return device, dist.get_backend()


def init_mesh(data_parallel: int, model_parallel: int = 1, device=None) -> Mesh:
    """The ``data_parallel x model_parallel`` mesh over every rank of the
    initialised world (joined from the torchrun environment when it is
    not); the product must be the world size.  Collective: every rank
    calls it."""
    device, backend = init_distributed(device)
    world, rank = dist.get_world_size(), dist.get_rank()
    dp, tp = data_parallel, model_parallel
    if dp * tp != world:
        raise ValueError(f"mesh {dp} x {tp} != world size {world}: every rank of the world "
                         "must be in the mesh")
    # every rank creates every group, in the same order (torch.distributed's rule)
    data_groups = [dist.new_group([d * tp + m for d in range(dp)]) for m in range(tp)]
    model_groups = [dist.new_group([d * tp + m for m in range(tp)]) for d in range(dp)]
    data_rank, model_rank = divmod(rank, tp)
    return Mesh(rank=rank, world=world, dp=dp, tp=tp, data_rank=data_rank, model_rank=model_rank,
                data_group=data_groups[model_rank], model_group=model_groups[data_rank],
                device=device, backend=backend)


def make_hybrid_mesh(ici_shape: Tuple[int, int], dcn_shape: Tuple[int, int],
                     device=None) -> Mesh:
    """A multi-node mesh in which only the data axis crosses nodes:
    ``ici_shape`` is one node's ``(dp, tp)``, ``dcn_shape`` the node grid
    ``(nodes, 1)``.  torchrun numbers ranks node by node and the model axis
    is the fastest, so each model group lies inside a node when ``tp``
    divides a node's ranks; a layout that would put the model axis across
    nodes raises.  On one node it is the plain mesh of the same global
    shape, as JAX's fallback."""
    (ici_dp, ici_tp), (dcn_dp, dcn_tp) = ici_shape, dcn_shape
    local_world = _env_int("LOCAL_WORLD_SIZE", _env_int("WORLD_SIZE", 1))
    if dcn_tp != 1 or local_world % ici_tp:
        raise ValueError(f"ici {tuple(ici_shape)} x dcn {tuple(dcn_shape)} with {local_world} "
                         "ranks a node puts the model axis across nodes; only the data axis "
                         "may cross them")
    return init_mesh(ici_dp * dcn_dp, ici_tp, device=device)


def mesh_from_config(data_parallel: int = 1, model_parallel: int = 1, warn=print,
                     device=None) -> Optional[Mesh]:
    """The training mesh from the config knobs: None for 1 x 1; requests
    larger than the world clamp to it with a warning, and a model axis that
    does not divide the world is dropped with a warning, as in JAX."""
    if data_parallel * model_parallel <= 1:
        return None
    init_distributed(device)
    world = dist.get_world_size()
    if model_parallel > world or world % max(model_parallel, 1):
        warn(f"[dist] model_parallel={model_parallel} does not fit {world} ranks; "
             "disabling model axis")
        model_parallel = 1
    dp = min(data_parallel, world // model_parallel)
    if dp != data_parallel:
        warn(f"[dist] clamping data_parallel {data_parallel} -> {dp} ({world} ranks, "
             f"model_parallel={model_parallel})")
    if dp * model_parallel <= 1:
        return None
    return init_mesh(dp, model_parallel, device=device)


# -------------------------------------------------------------- helpers
def data_axis_size(mesh: Optional[Mesh]) -> int:
    """Shards along the data axis: the multiple batch sizes pad to."""
    return mesh.dp if mesh is not None else 1


def resolve_num_groups(configured: Optional[int], mesh: Optional[Mesh]) -> int:
    """GRPO groups per batch: the configured count, else one per data shard
    (the reference's per-rank groups), else 1."""
    if configured:
        return configured
    return data_axis_size(mesh)


def shard_slice(mesh: Mesh, rows: int) -> slice:
    """This data rank's contiguous rows of a ``rows``-row batch."""
    if rows % mesh.dp:
        raise ValueError(f"batch of {rows} rows does not divide over {mesh.dp} data shards")
    per = rows // mesh.dp
    return slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh, tree: Any) -> Any:
    """This data rank's contiguous slice along dim 0 of every leaf (numpy
    arrays or tensors); raises when dim 0 does not divide."""
    return _tree_map(lambda x: x[shard_slice(mesh, x.shape[0])], tree)


def gather_batch(mesh: Mesh, tree: Any) -> Any:
    """Every data rank's tensors concatenated along dim 0 (an all_gather
    over the data group), on their device: the results of a sharded batch."""
    return _tree_map(lambda x: mesh.all_gather(x, "data"), tree)


@torch.no_grad()
def replicate(mesh: Mesh, module_or_tree: Any) -> Any:
    """Broadcast rank 0's tensors (a module's parameters and buffers, or a
    tree of tensors) to every rank, in place, so every rank starts
    bit-equal."""
    if isinstance(module_or_tree, torch.nn.Module):
        tensors = list(module_or_tree.parameters()) + list(module_or_tree.buffers())
    else:
        tensors = []
        _tree_map(tensors.append, module_or_tree)
    for t in tensors:
        mesh.broadcast(t.data if isinstance(t, torch.nn.Parameter) else t)
    return module_or_tree


class GradSync:
    """The ``make_update_fn(grad_sync=)`` hook over the data group: the
    update scales each rank's loss by :meth:`share` (its rows over the
    global rows), so that :meth:`__call__`, one all_reduce of the flattened
    gradients, gives the gradient of the global masked mean.  ``last_ms``
    is that all_reduce's host time: the data ranks meet at a barrier first,
    so it holds the collective alone and not the wait for a slower rank
    (bracketed by synchronises on a card)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.last_ms = 0.0

    def share(self, rows: torch.Tensor) -> torch.Tensor:
        total = self.mesh.all_reduce(rows.detach().clone(), "data")
        return rows.detach() / total.clamp_min(1.0)

    def sum(self, values: dict) -> dict:
        """The data-group sum of a dict of scalars, in one all_reduce."""
        flat = self.mesh.all_reduce(torch.stack([v.float() for v in values.values()]), "data")
        return dict(zip(values, flat))

    def __call__(self, grads: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
        on_card = grads[0].is_cuda
        self.mesh.all_reduce(torch.zeros(1, device=grads[0].device), "data")  # the barrier
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        flat = self.mesh.all_reduce(torch.cat([g.reshape(-1) for g in grads]), "data")
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))
        if on_card:
            torch.cuda.synchronize()
        self.last_ms = (time.perf_counter() - t0) * 1e3
        return grads


def make_grad_sync(mesh: Mesh) -> GradSync:
    return GradSync(mesh)


def assert_params_synced(module: torch.nn.Module, mesh: Optional[Mesh] = None) -> float:
    """The global parameter sum (the reference's DDP param-sum print).  With
    a mesh, one all_gather checks that every rank holds the same sum."""
    total = sum(p.detach().double().sum() for p in module.parameters())
    total = torch.as_tensor(total, dtype=torch.float64)
    if mesh is not None:
        sums = mesh.all_gather(total.reshape(1).to(mesh.device), "world").cpu()
        if not bool((sums == sums[0]).all()):
            raise AssertionError(f"parameters differ across ranks: sums {sums.tolist()}")
    return float(total)
