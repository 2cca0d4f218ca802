"""One process per rank on this host, for tests and smoke runs.

``spawn(fn, world)`` starts ``world`` fresh interpreters (the ``spawn``
start method), sets the torchrun environment in each (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT`` on a free local port), joins the process group over
``backend`` and calls ``fn(rank, *args)``.  It returns every rank's result
(pickled by value), raises with the failing rank's traceback, and kills the
rest on a failure or at ``timeout_s``.  ``fn`` must be importable (a
module-level function).  Real jobs launch with ``torchrun`` instead.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue
import socket
import time
import traceback
from typing import Any, Callable, List, Sequence


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_rank(fn, rank: int, world: int, backend: str, port: int, args, results) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    import torch.distributed as dist

    try:
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world)
        results.put((rank, True, pickle.dumps(fn(rank, *args))))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world: int, backend: str = "gloo", timeout_s: float = 120.0,
          args: Sequence[Any] = ()) -> List[Any]:
    """``[fn(0, *args), ..., fn(world - 1, *args)]``, each in its own
    process of a ``world``-rank group."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_run_rank, args=(fn, r, world, backend, port, tuple(args), results),
                         daemon=True, name=f"rank-{r}") for r in range(world)]
    for p in procs:
        p.start()
    out = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(out) < world:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [p.name for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"{', '.join(dead)} died without a result "
                                       f"(exit codes {[p.exitcode for p in procs]})")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world - len(out)} of {world} ranks gave no result "
                                       f"within {timeout_s:.0f} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            out[rank] = pickle.loads(payload)
    finally:
        for p in procs:
            p.join(timeout=10.0 if len(out) == world else 0.1)
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world)]
