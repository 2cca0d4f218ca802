"""Micro-batching inference engines for serving.

Port of ``consolver_tpu/serve/engine.py``.  A resident worker thread takes
requests from a queue, coalesces those that share a program key
(``(steps, cfg, solver, deterministic)``) into one batch padded to a
configured batch shape, and runs the whole hot path of the batch on the
device: per-seed noise -> prompt encode -> denoise -> decode -> uint8.  A
second thread fetches finished batches to the host and resolves the
requests' futures, so batch N's readback overlaps batch N+1's dispatch (at
most 2 batches in flight).

:class:`InferenceEngine` serves text-to-image (SD-1.5, and SD3 through
:class:`SD3InferenceEngine`'s request defaults), :class:`EditInferenceEngine`
FLUX-Kontext editing; :class:`ReplicaGroup` puts one engine on each of
several devices.  What differs between families is read from the pipeline
(:mod:`consolver_torch.pipelines.base`).

Determinism contract: a request's initial noise comes from its ``seed``
alone (drawn on the CPU, so the same on every device), and every model op is
per sample, so a request's bits never depend on its batch-mates.  Two
stochastic exceptions remain when sampling is on:

- the learnable solvers (``consistencysolver`` / ``fmppo``) *sample* policy
  actions from one batch-shared generator, so a request's actions depend on
  its batch slot.  ``deterministic=True`` takes mode actions instead, and
  the output is then a pure function of (prompt, seed, program key), served
  always at the largest batch shape (see :meth:`_BatchingEngine._pick_size`)
  through a program whose model calls do not depend on the batch slot
  either (``TextToImagePipeline.denoise_fn``: on an H100, cuDNN's batched
  bf16 3x3 convolutions reduce some slots in another order than others);
- the ``sde-*`` solvers draw their per-step noise from that generator too.

The batch generator is seeded from the first row's seed.

``mesh=`` (:mod:`consolver_torch.dist.mesh`) serves one batch over several
ranks, one process each.  Rank 0 owns the queue, the flush window and the
HTTP server; for each batch it broadcasts the request tensors (seeds,
token ids, references, the program key, and the policy's parameters when
they changed since the last batch), every data rank runs its contiguous
slice of the batch, drawing the global batch's policy samples and keeping
its rows, and rank 0 all_gathers the uint8 images.  The other ranks run a
follower loop from construction until rank 0 shuts its engine down.  On a
2-D mesh each model group splits the module that the pipeline's
``TENSOR_PARALLEL`` names in place; a pipeline without one serves on one
card.  Every batch shape must divide by the data ranks.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import heapq
import itertools
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from consolver_torch.data.tokenizer import HashTokenizer, tokenize_batch
from consolver_torch.dist.mesh import gather_batch, shard_slice
from consolver_torch.dist.tp import is_sharded, shard_module_by_rules
from consolver_torch.kernels import resize
from consolver_torch.policy import io as policy_io
from consolver_torch.policy.factor_net import ShardedGenerator
from consolver_torch.utils import profiling

# solvers with a policy whose actions the deterministic knob affects; for
# zoo solvers the knob is a no-op and must not fork programs or batches
LEARNABLE_SOLVERS = frozenset({"consistencysolver", "fmppo"})


class _Keyed:
    """The engine batches only requests with equal ``program_key``."""

    @property
    def program_key(self) -> Tuple:
        return (
            int(self.num_inference_steps),
            float(self.guidance_scale),
            str(self.solver),
            bool(self.deterministic) and self.solver in LEARNABLE_SOLVERS,
        )


@dataclasses.dataclass(frozen=True)
class GenerationRequest(_Keyed):
    """One text-to-image request; ``deterministic`` takes mode policy
    actions."""

    prompt: str
    seed: int = 0
    num_inference_steps: int = 8
    guidance_scale: float = 3.0
    solver: str = "consistencysolver"
    deterministic: bool = False


@dataclasses.dataclass(frozen=True, eq=False)
class EditRequest(_Keyed):
    """One instructional-edit request (FLUX-Kontext family).  ``image`` is
    the reference as ``[H, W, 3]`` uint8 RGB; the engine center-crop-resizes
    it to its resolution."""

    instruction: str
    image: np.ndarray
    seed: int = 0
    num_inference_steps: int = 5
    guidance_scale: float = 2.5
    solver: str = "fmppo"
    deterministic: bool = False


class EngineShutDown(RuntimeError):
    pass


class RequestExpired(RuntimeError):
    """Set on a request's future when it sat queued longer than the engine's
    ``max_wait_s`` before a batch slot opened (load shedding)."""


def _uint8_in_program(images: torch.Tensor) -> torch.Tensor:
    """[0, 1] float images -> uint8 on the device.  ``torch.round`` rounds
    half to even, as ``jnp.round`` and ``np.round`` do."""
    return torch.round(images.clamp(0.0, 1.0) * 255.0).to(torch.uint8)


def unet_graphs_allowed(module, device) -> bool:
    """Whether an engine replays a model that offers CUDA graphs
    (``module.cuda_graphs``: the UNet's) from them: on a CUDA device, for a
    module that is not tensor-parallel (its all_reduces cannot be
    captured)."""
    return torch.device(device).type == "cuda" and not is_sharded(module)


def seed_noise(seeds: Sequence[int], shape: Tuple[int, ...]) -> torch.Tensor:
    """``[len(seeds), *shape]`` f32 noise, row ``i`` drawn on the CPU from a
    generator seeded with ``seeds[i]``: the same on every device."""
    return torch.stack([torch.randn(shape, generator=torch.Generator().manual_seed(int(s)))
                        for s in seeds])


class _BatchingEngine:
    """Resident worker thread that coalesces requests into padded batches
    and serves them through ``pipeline``.

    Subclasses implement :meth:`_message` (list of requests -> the padded
    batch's host arrays, :meth:`_batch`) and set ``latent_size``.  Partial
    batches are padded by repeating the last row (pad rows are computed and
    discarded).  On a CUDA device the engine turns on the CUDA graphs of
    the pipeline's models that offer them and are not tensor-parallel (the
    UNet's, :mod:`consolver_torch.models.graphs`): the first batch of each
    (program, batch shape) captures the forward, later batches replay it.

    The worker dispatches a batch (the host launches its kernels; it may
    block where the pipeline synchronises), records a CUDA event after it
    and hands both to the fetcher thread, which waits on the event and
    copies the uint8 batch to the host on a stream of its own.  The fetch
    queue holds at most 2 batches (backpressure on the worker).

    Spans (:mod:`consolver_torch.utils.profiling`) go to the engine's own
    totals (``spans``; :meth:`stats` reports them): ``engine.queue``
    (submit to dispatch, per request), ``engine.batch`` (the worker's
    dispatch of one batch), ``engine.prep`` (:meth:`_message`; an edit's
    reference resize inside it is ``engine.resize``) and ``engine.fetch``
    (the wait for the batch and its copy to the host), plus the pipeline's
    spans inside each batch and the HTTP handler's.
    The rings ``_wait_ms`` and ``_dispatch_ms`` take the same stamps as
    ``engine.queue`` and ``engine.batch``.

    Parameters
    ----------
    pipeline : Pipeline
        Served on its device; never mutated but for the tensor-parallel
        split on a mesh.
    batch_size : int
        The largest batch shape.
    flush_ms : float
        How long the worker waits for more same-program requests after the
        first arrives before dispatching a partial batch.
    max_wait_s : float, optional
        Request deadline: a request still queued this long after submit is
        failed with :class:`RequestExpired` when the worker next forms a
        batch.  ``None`` (default) = never expire.
    batch_sizes : tuple of int, optional
        Additional (smaller) batch shapes: a partial batch pads to the
        SMALLEST listed size that fits.  Defaults to ``(batch_size,)``.
        Batches holding a ``deterministic`` request always pad to the max
        shape (see :meth:`_pick_size`).
    mesh : Mesh, optional
        Serve over the mesh's ranks (module docstring); ranks > 0 follow.
    adaptive_flush : bool
        Scale the flush window with the observed arrival rate: wait
        ``min(flush_ms, (batch_size - pending) * EMA inter-arrival gap)``,
        dispatch early at a shape boundary the next shape will not fill in
        time, split an off-boundary batch at window expiry, and keep
        collecting while the fetch queue is full.
    """

    # request type of the engine's family, the fields a request body may
    # leave out over the type's own defaults, and /v1/refine's (or
    # /v1/edit/refine's) over those; None: no refine signature
    REQUEST: type = GenerationRequest
    GENERATE_DEFAULTS: dict = {}
    REFINE_DEFAULTS: Optional[dict] = None
    # set by a subclass: latent H = W, and the pad-to-max program's length
    latent_size: int
    padded_max_steps: Optional[int] = None

    def __init__(self, pipeline, batch_size: int = 8, flush_ms: float = 30.0,
                 max_queue: int = 256, max_wait_s: Optional[float] = None,
                 batch_sizes: Optional[Tuple[int, ...]] = None,
                 adaptive_flush: bool = False, mesh=None):
        sizes = sorted({int(s) for s in (batch_sizes or (batch_size,))})
        if sizes[0] < 1:
            raise ValueError(f"batch sizes must be >= 1, got {sizes}")
        if mesh is not None:
            if pipeline.TENSOR_PARALLEL is None:
                raise ValueError(f"{type(pipeline).__name__} serves on one card; put an engine "
                                 "on each card (make_replicas) instead of a mesh")
            if any(size % mesh.dp for size in sizes):
                raise ValueError(f"batch sizes {sizes} must divide by the mesh's data axis "
                                 f"({mesh.dp})")
            name, rules = pipeline.TENSOR_PARALLEL
            shard_module_by_rules(mesh, getattr(pipeline, name), rules)
        for name in pipeline.MODULES:
            module = getattr(pipeline, name, None)
            graphs = getattr(module, "cuda_graphs", None)
            if graphs is not None and unet_graphs_allowed(module, pipeline.device):
                graphs.enabled = True
        self.pipeline = pipeline
        self._programs: dict = {}
        self.mesh = mesh
        self._mesh_lock = threading.Lock()  # one batch's collectives at a time
        self._sent_net = None  # the policy whose parameters the followers hold
        self._mesh_closed = False
        self.batch_sizes = tuple(sizes)
        self.batch_size = sizes[-1]
        self.device = torch.device(pipeline.device)
        self._adaptive = bool(adaptive_flush)
        self._ema_gap_s: Optional[float] = None
        self._last_submit: Optional[float] = None
        self._flush_s = float(flush_ms) / 1e3
        self._max_wait_s = None if max_wait_s is None else float(max_wait_s)
        self._queue: queue.Queue = queue.Queue(maxsize=max_queue)
        self._pending: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._stats = {
            "requests": 0,
            "completed": 0,
            "errors": 0,
            "expired": 0,
            "batches": 0,
            "batched_rows": 0,
            "padded_rows": 0,
            # (program, batch shape) pairs run by prewarm; prewarm batches
            # bypass the queue and count in no other field
            "prewarmed": 0,
        }
        # ring buffers of the last 512 per-request queue waits, per-batch
        # execute times (dispatch start -> host images) and per-batch
        # dispatch times (the worker's host time), in ms
        self._wait_ms: collections.deque = collections.deque(maxlen=512)
        self._exec_ms: collections.deque = collections.deque(maxlen=512)
        self._dispatch_ms: collections.deque = collections.deque(maxlen=512)
        self.spans = profiling.SpanTotals()
        self._batch_ids = itertools.count()
        self._copy_stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                             else None)
        self._stop = threading.Event()
        self._fetch_queue: queue.Queue = queue.Queue(maxsize=2)
        if self.is_follower:
            self._follower = threading.Thread(target=lambda: self._on_device(self._follow),
                                              name="consolver-serve-follower", daemon=True)
            self._follower.start()
            return
        self._fetcher = threading.Thread(target=self._fetch_loop, name="consolver-serve-fetcher",
                                         daemon=True)
        self._fetcher.start()
        self._worker = threading.Thread(target=self._run, name="consolver-serve-worker",
                                        daemon=True)
        self._worker.start()

    @property
    def is_follower(self) -> bool:
        """A rank > 0 of a mesh: it takes no requests and runs the batches
        rank 0 broadcasts."""
        return self.mesh is not None and not self.mesh.is_primary

    def _check_leader(self) -> None:
        if self.is_follower:
            raise RuntimeError("requests go to rank 0's engine; this rank follows it")

    def _follow(self) -> None:
        while True:
            msg = self.mesh.broadcast_object()
            if msg is None:  # rank 0 shut down
                return
            if "factor_state" in msg:
                self.update_factor_params(msg["factor_state"])
            self._execute(msg)

    def join(self) -> None:
        """A follower: wait until rank 0 shuts the engine down (the rank's
        next collectives must not start before)."""
        self._follower.join()

    # ------------------------------------------------------------- public
    def submit(self, request, request_id: Optional[int] = None) -> Future:
        """Enqueue; the Future resolves to an ``[H, W, 3]`` uint8 image.
        ``request_id`` (the HTTP handler's) labels the request's batch in
        a profiler trace."""
        self._check_leader()
        if self._stop.is_set():
            raise EngineShutDown("engine is shut down")
        fut: Future = Future()
        now_ns = time.monotonic_ns()
        now = now_ns / 1e9
        self._queue.put((request, fut, now_ns, request_id))  # blocks when max_queue deep
        with self._lock:
            self._stats["requests"] += 1
            # the inter-arrival EMA feeds the adaptive flush window; idle
            # gaps are clamped at the window, so that an hour-long idle gap
            # does not chop the next burst into smallest-shape batches
            if self._last_submit is not None:
                gap = min(now - self._last_submit, self._flush_s)
                self._ema_gap_s = gap if self._ema_gap_s is None else (
                    0.8 * self._ema_gap_s + 0.2 * gap)
            self._last_submit = now
        if self._stop.is_set():
            # shutdown raced the enqueue: the worker's final drain may have
            # passed this item already (a future resolved first wins)
            with contextlib.suppress(Exception):
                fut.set_exception(EngineShutDown("engine is shut down"))
        return fut

    def generate(self, request, timeout: Optional[float] = None,
                 request_id: Optional[int] = None) -> np.ndarray:
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(request, request_id).result(timeout)

    def prewarm(self, *requests, timeout: Optional[float] = None) -> int:
        """Run one padded dummy batch per distinct ``program_key`` at EVERY
        configured batch size (deterministic signatures at the max shape
        only, the one they are served at), outside the queue, before
        traffic.  ``timeout`` bounds EACH program's warm time: a dispatch
        that hangs raises ``TimeoutError`` to the caller (and is
        abandoned on a daemon thread).  Returns the number of (signature,
        batch size) programs warmed."""
        self._check_leader()
        unique = {}
        for r in requests:
            unique.setdefault(r.program_key, r)
        n = 0
        for r in unique.values():
            sizes = (self.batch_sizes[-1],) if self._wants_pinned_shape([r]) else self.batch_sizes
            for size in sizes:
                self._bounded(lambda: self._fetch(self._run_batch([r] * size)[0], 1), timeout)
                n += 1
        with self._lock:
            self._stats["prewarmed"] += n
        return n

    def _bounded(self, fn, timeout: Optional[float]):
        if timeout is None:
            return self._on_device(fn)
        box: dict = {}
        done = threading.Event()

        def runner():
            try:
                box["out"] = self._on_device(fn)
            except BaseException as exc:  # surfaced on the caller below
                box["err"] = exc
            finally:
                done.set()

        threading.Thread(target=runner, daemon=True, name="consolver-prewarm").start()
        if not done.wait(timeout):
            raise TimeoutError(f"a prewarm program exceeded {timeout:.0f}s")
        if "err" in box:
            raise box["err"]
        return box["out"]

    def stats(self) -> dict:
        with self._lock:
            s = dict(self._stats)
            rings = {"queue_wait_ms": sorted(self._wait_ms), "execute_ms": sorted(self._exec_ms),
                     "dispatch_ms": sorted(self._dispatch_ms)}
        # cumulative since the engine started, prewarm included
        s["spans"] = self.spans.snapshot()
        total_rows = s["batched_rows"] + s["padded_rows"]
        s["mean_batch_occupancy"] = s["batched_rows"] / total_rows if total_rows else 0.0
        # the share of computed rows that were padding
        s["pad_waste_pct"] = round(100.0 * s["padded_rows"] / total_rows, 2) if total_rows else 0.0
        s["batch_size"] = self.batch_size
        s["batch_sizes"] = list(self.batch_sizes)
        for name, xs in rings.items():
            if xs:
                s[f"{name}_p50"] = round(xs[len(xs) // 2], 1)
                s[f"{name}_p95"] = round(xs[int(len(xs) * 0.95)], 1)
        return s

    def shutdown(self, timeout: float = 10.0) -> None:
        """Stop accepting work, fail queued requests, join the threads.

        The worker owns ``_pending`` and drains it (and the queue) itself
        when it sees the stop flag, so a join that times out while a batch
        is in flight is safe: that batch completes through the fetcher and
        the worker fails the leftovers on its way out.  Only after the
        worker has exited does shutdown drain the queue again, to catch a
        submit that raced past the stop check.  On a mesh, rank 0 then tells
        the followers to stop, and a follower waits for that, however long."""
        self._stop.set()
        if self.is_follower:
            self.join()
            return
        deadline = time.monotonic() + timeout
        self._worker.join(timeout)
        if not self._worker.is_alive():
            self._fetcher.join(max(0.0, deadline - time.monotonic()))
            self._drain_on_stop()
        if self.mesh is not None:
            with self._mesh_lock:
                if not self._mesh_closed:
                    self._mesh_closed = True
                    self.mesh.broadcast_object(None)

    def _drain_on_stop(self) -> None:
        """Fail everything still pending or queued with EngineShutDown."""
        drained = list(self._pending)
        self._pending = collections.deque()
        while True:
            try:
                drained.append(self._queue.get_nowait())
            except queue.Empty:
                break
        for item in drained:
            if not item[1].done():
                with contextlib.suppress(Exception):
                    item[1].set_exception(EngineShutDown("engine shut down"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()

    # ------------------------------------------------------------- worker
    def _on_device(self, fn):
        """``fn()`` in inference mode, with the engine's device current and
        its span totals active (all three are per thread)."""
        ctx = torch.cuda.device(self.device) if self.device.type == "cuda" else (
            contextlib.nullcontext())
        with ctx, torch.inference_mode(), profiling.use(self.spans):
            return fn()

    def _run(self) -> None:
        self._on_device(self._loop)
        # stop flag observed: this thread owns _pending, so the final drain
        # happens here; the sentinel lets the fetcher finish what was
        # dispatched, then exit
        self._drain_on_stop()
        self._fetch_queue.put(None)

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._pending.append(self._queue.get(timeout=0.05))
            except queue.Empty:
                if not self._pending:
                    continue
            # flush window: give same-program stragglers a chance to join
            deadline = time.monotonic() + self._flush_window()
            while len(self._pending) < self.batch_size:
                remain = deadline - time.monotonic()
                # adaptive boundary stop: pending sits on a smaller batch
                # shape that the arrival rate says will not grow to the next
                # one in time: dispatch now at zero pad rows.  Never for
                # pinned (deterministic) traffic, never while the device is
                # backlogged (waiting is free then).
                if (self._boundary_stop(len(self._pending), remain)
                        and not self._fetch_queue.full()
                        and not self._wants_pinned_shape(it[0] for it in self._pending)):
                    break
                if remain > 0:
                    try:
                        self._pending.append(self._queue.get(timeout=remain))
                        continue
                    except queue.Empty:
                        pass
                # window elapsed: take what already sits in the queue first,
                # so that an instantaneous burst is not chopped
                while len(self._pending) < self.batch_size:
                    try:
                        self._pending.append(self._queue.get_nowait())
                    except queue.Empty:
                        break
                # adaptive mode: keep collecting while the device already has
                # the most batches in flight (dispatching would only block)
                if (self._adaptive and self._fetch_queue.full() and not self._stop.is_set()
                        and len(self._pending) < self.batch_size):
                    deadline = time.monotonic() + self._flush_s
                    continue
                break
            now_ns = time.monotonic_ns()
            key, batch, rest, expired = None, [], collections.deque(), 0
            for item in self._pending:
                queued_s = (now_ns - item[2]) / 1e9
                if self._max_wait_s is not None and queued_s > self._max_wait_s:
                    expired += 1
                    if not item[1].done():
                        item[1].set_exception(RequestExpired(
                            f"request queued {queued_s:.1f}s > max_wait_s={self._max_wait_s}"))
                    continue
                if key is None:
                    key = item[0].program_key
                if item[0].program_key == key and len(batch) < self.batch_size:
                    batch.append(item)
                else:
                    rest.append(item)
            self._pending = rest
            if expired:
                with self._lock:
                    self._stats["expired"] += expired
            if batch:
                # split flush: a window that expired off a shape boundary
                # dispatches the largest shape that fits and returns the
                # remainder to pending, merged back by ARRIVAL time so that
                # it cannot front-run an earlier request of another program
                keep = len(batch)
                if not self._wants_pinned_shape(it[0] for it in batch):
                    keep = self._expiry_trim(keep)
                if keep < len(batch):
                    self._pending = collections.deque(heapq.merge(
                        batch[keep:], self._pending, key=lambda it: it[2]))
                    batch = batch[:keep]
                self._serve_batch(batch)

    def _run_batch(self, requests):
        """Dispatch, then an event recorded after the batch's work on a
        CUDA device (None elsewhere)."""
        images = self._dispatch(requests)
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
        return images, ready

    def _serve_batch(self, batch) -> None:
        size = self._pick_size(len(batch), self._wants_pinned_shape([it[0] for it in batch]))
        ids = [it[3] for it in batch if it[3] is not None]
        dispatch = profiling.span("engine.batch", (next(self._batch_ids), ids))
        try:
            with dispatch:
                images, ready = self._run_batch([item[0] for item in batch])
        except Exception as exc:  # surface to every caller in the batch
            with self._lock:
                self._stats["errors"] += len(batch)
                self._stats["batches"] += 1
            for item in batch:
                item[1].set_exception(exc)
            return
        with self._lock:
            self._dispatch_ms.append(dispatch.ns / 1e6)
        # blocks at 2 batches in flight: device-memory backpressure
        self._fetch_queue.put((batch, images, ready, dispatch.start_ns, size))

    def _fetch_loop(self) -> None:
        """Fetcher thread: wait for each dispatched batch, copy it to the
        host and resolve its futures, overlapping the worker's next
        dispatch."""
        while True:
            item = self._fetch_queue.get()
            if item is None:
                return
            batch, images, ready, t0_ns, size = item
            try:
                with profiling.use(self.spans), profiling.span("engine.fetch"):
                    if ready is not None:
                        ready.synchronize()
                    stream = (torch.cuda.stream(self._copy_stream)
                              if self._copy_stream is not None else contextlib.nullcontext())
                    with stream:
                        host = self._fetch(images, len(batch))
            except Exception as exc:  # runtime errors surface at readback
                with self._lock:
                    self._stats["errors"] += len(batch)
                    self._stats["batches"] += 1
                for it in batch:
                    if not it[1].done():
                        it[1].set_exception(exc)
                continue
            t1_ns = time.monotonic_ns()
            with self._lock:
                self._stats["batches"] += 1
                self._stats["batched_rows"] += len(batch)
                self._stats["padded_rows"] += size - len(batch)
                self._stats["completed"] += len(batch)
                self._exec_ms.append((t1_ns - t0_ns) / 1e6)
                self._wait_ms.extend((t0_ns - it[2]) / 1e6 for it in batch)
            for it in batch:
                self.spans.record("engine.queue", it[2], t0_ns)
            for (_, fut, _, _), img in zip(batch, host):
                fut.set_result(img)

    def _dispatch(self, requests):
        """list of requests -> on-device uint8 image batch; on a mesh, the
        batch is broadcast to the followers first."""
        with profiling.span("engine.prep"):
            msg = self._message(requests)
        if self.mesh is None:
            return self._execute(msg)
        with self._mesh_lock:
            net = getattr(self.pipeline, "factor_net", None)
            if net is not None and net is not self._sent_net:  # first batch, or a hot reload
                msg["factor_state"] = {k: v.detach().cpu() for k, v in net.state_dict().items()}
                self._sent_net = net
            self.mesh.broadcast_object(msg)
            return self._execute(msg)

    @classmethod
    def request(cls, refine: bool = False, **fields):
        """A request of this engine's family: ``fields`` over its defaults
        (``refine``: the refine signature's).  Raises ValueError where the
        family has no refine signature."""
        if refine and cls.REFINE_DEFAULTS is None:
            raise ValueError(f"{cls.__name__} has no refine signature; ask /v1/generate "
                             "for the steps and solver you want")
        return cls.REQUEST(**{**cls.GENERATE_DEFAULTS,
                              **(cls.REFINE_DEFAULTS if refine else {}), **fields})

    def _message(self, requests) -> dict:
        """The padded batch's host arrays (:meth:`_batch`)."""
        raise NotImplementedError

    def _batch(self, requests, *inputs) -> dict:
        """The message of a batch: its program key, its padded seeds and
        ``inputs``, the padded host arrays that the pipeline's call takes
        before the noise."""
        seeds = self._pad([int(r.seed) for r in requests], requests)
        return {"key": requests[0].program_key, "seeds": np.asarray(seeds), "inputs": inputs}

    def _serve_program(self, program_key):
        """The batch's whole hot path for one program key: per-seed noise ->
        the pipeline's call (encode, denoise, decode) -> uint8, on the
        pipeline it is given (read once per batch, so that a hot reload
        applies from the next batch).  ``padded_max_steps`` serves the
        learnable solver's step counts up to it from one pad-to-max
        program."""
        if program_key not in self._programs:
            steps, cfg_scale, solver, deterministic = program_key
            padded = (self.padded_max_steps
                      if self.padded_max_steps is not None and steps <= self.padded_max_steps
                      and self.pipeline.is_learnable(solver) else None)

            def run(pipe, generator, seeds, inputs):
                shape = (self.latent_size, self.latent_size, pipe.latent_channels)
                noise = profiling.to_device(seed_noise(seeds, shape), pipe.device)
                images, _ = pipe(generator, *inputs, noise, num_inference_steps=steps,
                                 guidance_scale=cfg_scale, solver=solver,
                                 deterministic_policy=deterministic, padded_max_steps=padded,
                                 record=False)  # serving discards the RL trajectory
                return _uint8_in_program(images)

            self._programs[program_key] = run
        return self._programs[program_key]

    def _execute(self, msg: dict):
        """Run a batch message: the on-device uint8 images.  On a mesh this
        data rank runs its rows, its generator drawing for the whole batch
        and keeping its rows, and the images are gathered."""
        seeds, inputs = msg["seeds"], msg["inputs"]
        generator = torch.Generator(self.pipeline.device).manual_seed(int(seeds[0]))
        if self.mesh is not None:
            rows = shard_slice(self.mesh, len(seeds))
            generator = ShardedGenerator(generator, rows.start, len(seeds))
            seeds, inputs = seeds[rows], self._rank_inputs([x[rows] for x in inputs])
        images = self._serve_program(msg["key"])(self.pipeline, generator, seeds.tolist(), inputs)
        return images if self.mesh is None else gather_batch(self.mesh, images)

    def _rank_inputs(self, inputs: list) -> list:
        """This rank's rows of a broadcast batch's inputs as the pipeline's
        call takes them (host data that :meth:`_message` left to each rank
        is made ready here)."""
        return inputs

    # ------------------------------------------------------------ helpers
    def _flush_window(self) -> float:
        """Fixed ``flush_ms``, or in adaptive mode the EMA estimate of the
        time a full batch of arrivals needs, capped at ``flush_ms``."""
        if not self._adaptive:
            return self._flush_s
        with self._lock:
            gap = self._ema_gap_s
        if gap is None:
            return self._flush_s
        need = max(0, self.batch_size - len(self._pending)) * gap
        return min(self._flush_s, need)

    def _boundary_stop(self, n: int, remain_s: float) -> bool:
        """Adaptive early dispatch: ``n`` pending rows sit on a smaller
        configured batch shape and the EMA inter-arrival gap says the next
        shape will not fill within the remaining window."""
        if not self._adaptive or n not in self.batch_sizes or n >= self.batch_sizes[-1]:
            return False
        # requests already in the queue disprove any rate estimate
        if not self._queue.empty():
            return False
        with self._lock:
            gap = self._ema_gap_s
        if gap is None:
            return False
        nxt = min(s for s in self.batch_sizes if s > n)
        return (nxt - n) * gap > max(remain_s, 0.0)

    def _expiry_trim(self, n: int) -> int:
        """How many of ``n`` rows to dispatch when the window expires off a
        shape boundary: in adaptive mode the largest shape that fits (rows
        below the smallest shape still pad)."""
        if not self._adaptive:
            return n
        fit = [s for s in self.batch_sizes if s <= n]
        return max(fit) if fit else n

    def _pick_size(self, n: int, deterministic: bool = False) -> int:
        """Smallest configured batch shape that fits ``n`` rows.

        Batches holding a ``deterministic`` request ALWAYS pad to the max
        shape: cuBLAS and cuDNN pick their kernels per shape, so the same
        row may differ in its last bits between two batch shapes.  Pinning
        deterministic traffic to one shape keeps its output a pure function
        of (prompt, seed, program); sampled traffic takes the smallest."""
        if deterministic:
            return self.batch_sizes[-1]
        for s in self.batch_sizes:
            if s >= n:
                return s
        return self.batch_sizes[-1]

    @staticmethod
    def _wants_pinned_shape(requests) -> bool:
        return any(getattr(r, "deterministic", False) for r in requests)

    def _pad(self, items: list, requests) -> list:
        """Pad ``items`` (one per request) to the picked batch shape.
        ``requests`` carries the request objects for the deterministic pin
        (the items are derived values without the flag)."""
        size = self._pick_size(len(items), self._wants_pinned_shape(requests))
        return items + [items[-1]] * (size - len(items))

    # --------------------------------------------------------- hot reload
    def update_factor_params(self, state) -> None:
        """Swap the resident policy for one with the parameters ``state``.

        The pipeline's cached programs hold the FactorNet they were built
        with, and a batch in flight reads the resident net, so the new
        parameters go into a NEW net (a copy of the resident one) in a copy
        of the pipeline with an empty program cache (``replace``): one
        attribute assignment, atomic for the worker thread.  Batches
        already dispatched finish on the old policy."""
        old = getattr(self.pipeline, "factor_net", None)
        if old is None:
            raise ValueError("engine has no resident policy (factor_net is None)")
        want = {k: tuple(v.shape) for k, v in old.state_dict().items()}
        got = {k: tuple(v.shape) for k, v in state.items()}
        if set(got) != set(want):
            raise ValueError(f"factor state tree mismatch: {sorted(got)} != resident {sorted(want)}")
        if got != want:
            raise ValueError(f"factor param shape mismatch: {got} != resident {want}; the policy "
                             "dims are a serving-program property, restart to change them")
        net = copy.deepcopy(old)
        with torch.no_grad():
            net.load_state_dict(state)
        self.pipeline = self.pipeline.replace(factor_net=net)

    def load_factor_ckpt(self, path: str) -> dict:
        """Hot-reload the policy from a trainer ``checkpoint-{step}`` or a
        ``save_pretrained`` export (``policy/io.py``).  A config sidecar that
        differs from the resident net's config raises ``ValueError``."""
        net = getattr(self.pipeline, "factor_net", None)
        if net is None:
            raise ValueError("engine pipeline has no factor_net")
        cfg, state = policy_io.load_factor_ckpt(path, net.config)
        if cfg != net.config:
            raise ValueError(f"checkpoint FactorNetConfig {cfg} != engine's {net.config}; the "
                             "dims are a serving-program property: restart the server to change them")
        self.update_factor_params(state)
        return {"path": path, "factor_net_config": dataclasses.asdict(cfg)}

    @staticmethod
    def _fetch(images, n: int) -> list:
        """The batch's first ``n`` images (the rest are pad rows) as host
        uint8 arrays."""
        if torch.is_tensor(images):
            images = images[:n].cpu().numpy()
        return list(np.asarray(images)[:n])


class InferenceEngine(_BatchingEngine):
    """Text-to-image serving engine over a pipeline whose call takes the
    prompt's ids (``pipeline.tokenize``): SD-1.5's, or any family's.

    ``latent_size``: latent H = W (images come out 8x larger for SD-1.5).
    ``max_length``: the prompt's token count (default: the pipeline's own).
    ``padded_max_steps``: serve every ``num_inference_steps`` in ``[1,
    padded_max_steps]`` of the learnable solver from one pad-to-max
    program (zoo solvers keep per-count programs).
    ``mesh``: serve over its ranks (module docstring).
    """

    def __init__(
        self,
        pipeline,
        batch_size: int = 8,
        latent_size: int = 64,
        max_length: Optional[int] = None,
        flush_ms: float = 30.0,
        max_queue: int = 256,
        max_wait_s: Optional[float] = None,
        mesh=None,
        padded_max_steps: Optional[int] = None,
        batch_sizes: Optional[Tuple[int, ...]] = None,
        adaptive_flush: bool = False,
    ):
        self.padded_max_steps = padded_max_steps
        self.latent_size = int(latent_size)
        self.max_length = max_length
        super().__init__(pipeline, batch_size, flush_ms, max_queue, max_wait_s,
                         batch_sizes=batch_sizes, adaptive_flush=adaptive_flush, mesh=mesh)

    # SD-1.5's: GenerationRequest's own defaults, and the teacher signature
    # (40-step multistep DPM-Solver) on /v1/refine
    REFINE_DEFAULTS = {"num_inference_steps": 40, "solver": "multistep-dpm"}

    def _message(self, requests) -> dict:
        prompts = self._pad([r.prompt for r in requests], requests)
        return self._batch(requests, self.pipeline.tokenize(prompts, self.max_length))


class SD3InferenceEngine(InferenceEngine):
    """Text-to-image serving of the SD3 family
    (:class:`~consolver_torch.pipelines.sd3.SD3Pipeline`) on the same
    requests, batching, fetch and HTTP path as :class:`InferenceEngine`,
    with the SD3 model card's request defaults; ``latent_size`` is 128 for
    1024².  One card (the pipeline has no tensor-parallel rule:
    ``--replicas`` puts an engine on each card)."""

    # the model card's guidance and the learnable FM solver; no refine
    # signature (a full render is /v1/generate with euler at 28 steps)
    GENERATE_DEFAULTS = {"guidance_scale": 3.5, "solver": "fmppo"}
    REFINE_DEFAULTS = None

    def __init__(self, pipeline, batch_size: int = 1, latent_size: int = 128, **kwargs):
        super().__init__(pipeline, batch_size=batch_size, latent_size=latent_size,
                         max_length=pipeline.t5_max_length, **kwargs)


@dataclasses.dataclass
class References:
    """A batch's reference images as host data: the requests' uint8 sources
    and, per row, the index of its source (pad rows repeat the last).
    Slicing cuts the rows and keeps the sources, so that a mesh broadcasts
    the sources and each rank resizes those of its rows."""

    sources: list
    rows: np.ndarray

    def __getitem__(self, rows: slice) -> "References":
        return References(self.sources, self.rows[rows])

    def resize(self, size: int, device) -> torch.Tensor:
        """``[rows, size, size, 3]`` float32 in [-1, 1] on ``device``: each
        source its rows use is center-crop-resized once
        (:func:`~consolver_torch.kernels.resize.reference_into`: the kernel
        on a CUDA device, the host path on the CPU), and a row that repeats
        a source copies its first row."""
        with profiling.span("engine.resize"):
            out = torch.empty((len(self.rows), size, size, 3), dtype=torch.float32,
                              device=device)
            first_row: dict = {}
            for row, i in enumerate(self.rows.tolist()):
                if i in first_row:
                    out[row].copy_(out[first_row[i]])
                else:
                    resize.reference_into(self.sources[i], size, out[row])
                    first_row[i] = row
            return out


class EditInferenceEngine(_BatchingEngine):
    """FLUX-Kontext instructional-edit serving engine over a resident
    :class:`FluxKontextPipeline`.  The image resolution is pinned per
    engine.  Reference images are center-crop-resized in ``engine.prep``
    (:class:`References`): by the CUDA kernel of
    :mod:`consolver_torch.kernels.resize` on a CUDA pipeline, and on the
    host on the CPU; on a mesh the batch carries the uint8 sources and each rank
    resizes its rows.  ``t5_tokenizer`` / ``clip_tokenizer``: real
    tokenizers, else hashing.  ``mesh``: serve over its ranks (module
    docstring)."""

    REQUEST = EditRequest
    # /v1/edit/refine: the full-quality Kontext signature (28-step Euler FM
    # at guidance 2.5)
    REFINE_DEFAULTS = {"num_inference_steps": 28, "solver": "euler", "guidance_scale": 2.5}

    def __init__(
        self,
        pipeline,
        resolution: int = 1024,
        batch_size: int = 1,
        t5_tokenizer: Any = None,
        clip_tokenizer: Any = None,
        t5_max_length: int = 128,
        clip_max_length: int = 77,
        flush_ms: float = 30.0,
        max_queue: int = 256,
        max_wait_s: Optional[float] = None,
        mesh=None,
        padded_max_steps: Optional[int] = None,
        batch_sizes: Optional[Tuple[int, ...]] = None,
        adaptive_flush: bool = False,
    ):
        self.padded_max_steps = padded_max_steps
        self.resolution = int(resolution)
        vae_factor = 2 ** (len(pipeline.vae.cfg.block_out_channels) - 1)
        if self.resolution % (2 * vae_factor):
            raise ValueError(f"resolution {resolution} must be a multiple of {2 * vae_factor} "
                             "(VAE stride x 2x2 packing)")
        self.latent_size = self.resolution // vae_factor
        self.t5_tokenizer = t5_tokenizer
        self.clip_tokenizer = clip_tokenizer
        self.t5_max_length = int(t5_max_length)
        self.clip_max_length = int(clip_max_length)
        super().__init__(pipeline, batch_size, flush_ms, max_queue, max_wait_s,
                         batch_sizes=batch_sizes, adaptive_flush=adaptive_flush, mesh=mesh)

    def _message(self, requests) -> dict:
        pipe = self.pipeline
        instructions = self._pad([r.instruction for r in requests], requests)
        ref = References([r.image for r in requests],
                         np.asarray(self._pad(list(range(len(requests))), requests)))
        if self.mesh is None:
            ref = ref.resize(self.resolution, self.device)
        t5_tok = self.t5_tokenizer or HashTokenizer(max_length=self.t5_max_length)
        clip_tok = self.clip_tokenizer or HashTokenizer(max_length=self.clip_max_length)
        t5_ids = tokenize_batch(t5_tok, instructions, self.t5_max_length,
                                vocab_size=pipe.t5.cfg.vocab_size)
        clip_ids = tokenize_batch(clip_tok, instructions, self.clip_max_length,
                                  vocab_size=pipe.clip.cfg.vocab_size)
        return self._batch(requests, t5_ids, clip_ids, ref)

    def _rank_inputs(self, inputs: list) -> list:
        *text, ref = inputs
        return [*text, ref.resize(self.resolution, self.device)]


# ---------------------------------------------------------------- replicas
class ReplicaGroup:
    """One engine per device with least-loaded dispatch: each replica owns a
    full model copy and its own queue.  Quacks like an engine
    (submit / generate / prewarm / stats / shutdown / hot reload); its own
    ``spans`` take the HTTP handler's spans, and :meth:`stats` sums them with
    the replicas'."""

    def __init__(self, engines):
        engines = list(engines)
        if not engines:
            raise ValueError("ReplicaGroup needs at least one engine")
        self.engines = engines
        self.spans = profiling.SpanTotals()
        self._inflight = [0] * len(engines)
        self._rr = 0
        self._lock = threading.Lock()

    @property
    def batch_size(self) -> int:
        return self.engines[0].batch_size

    def submit(self, request, request_id: Optional[int] = None) -> Future:
        """Dispatch to the replica with the fewest in-flight requests
        (round-robin among ties)."""
        n = len(self.engines)
        with self._lock:
            order = [(self._rr + j) % n for j in range(n)]
            i = min(order, key=lambda j: self._inflight[j])
            self._rr = (i + 1) % n
            self._inflight[i] += 1
        fut = self.engines[i].submit(request, request_id)

        def _done(_fut, i=i):
            with self._lock:
                self._inflight[i] -= 1

        fut.add_done_callback(_done)
        return fut

    def generate(self, request, timeout: Optional[float] = None,
                 request_id: Optional[int] = None) -> np.ndarray:
        return self.submit(request, request_id).result(timeout)

    def request(self, refine: bool = False, **fields):
        """A request of the replicas' family (``InferenceEngine.request``)."""
        return self.engines[0].request(refine=refine, **fields)

    def prewarm(self, *requests, timeout: Optional[float] = None) -> int:
        """Warm EVERY replica."""
        return sum(eng.prewarm(*requests, timeout=timeout) for eng in self.engines)

    def stats(self) -> dict:
        per = [eng.stats() for eng in self.engines]
        agg = {k: sum(s[k] for s in per) for k in (
            "requests", "completed", "errors", "batches", "batched_rows", "padded_rows",
            "prewarmed")}
        agg["batch_size"] = self.batch_size
        agg["replicas"] = len(per)
        total_rows = agg["batched_rows"] + agg["padded_rows"]
        agg["mean_batch_occupancy"] = agg["batched_rows"] / total_rows if total_rows else 0.0
        agg["pad_waste_pct"] = (round(100.0 * agg["padded_rows"] / total_rows, 2)
                                if total_rows else 0.0)
        # latency percentiles over the replicas' pooled ring buffers
        for name, attr in (("queue_wait_ms", "_wait_ms"), ("execute_ms", "_exec_ms"),
                           ("dispatch_ms", "_dispatch_ms")):
            xs = []
            for eng in self.engines:
                with eng._lock:
                    xs.extend(getattr(eng, attr))
            xs.sort()
            if xs:
                agg[f"{name}_p50"] = round(xs[len(xs) // 2], 1)
                agg[f"{name}_p95"] = round(xs[int(len(xs) * 0.95)], 1)
        agg["spans"] = profiling.merge([self.spans.snapshot()] + [s["spans"] for s in per])
        agg["per_replica"] = per
        return agg

    def update_factor_params(self, state) -> None:
        """Hot-reload the policy on EVERY replica."""
        for eng in self.engines:
            eng.update_factor_params(state)

    def load_factor_ckpt(self, path: str) -> dict:
        # read the checkpoint once; the other replicas copy the new net's state
        out = self.engines[0].load_factor_ckpt(path)
        state = self.engines[0].pipeline.factor_net.state_dict()
        for eng in self.engines[1:]:
            eng.update_factor_params(state)
        out["replicas"] = len(self.engines)
        return out

    def shutdown(self, timeout: float = 10.0) -> None:
        for eng in self.engines:
            eng.shutdown(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()


def make_replicas(pipeline, engine_cls, n_replicas: int, devices=None,
                  **engine_kwargs) -> ReplicaGroup:
    """One ``engine_cls`` per device, each over a copy of ``pipeline``
    holding its own copy of every model of ``pipeline.MODULES`` on that
    device.  ``devices`` defaults to ``cuda:0 .. cuda:{n-1}`` of the visible cards."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    if n_replicas > len(devices):
        raise ValueError(f"{n_replicas} replicas > {len(devices)} visible devices")
    engines = []
    for device in devices[:n_replicas]:
        models = {name: copy.deepcopy(module).to(device) for name in pipeline.MODULES
                  if (module := getattr(pipeline, name, None)) is not None}
        engines.append(engine_cls(pipeline.replace(device=torch.device(device), **models),
                                  **engine_kwargs))
    return ReplicaGroup(engines)
