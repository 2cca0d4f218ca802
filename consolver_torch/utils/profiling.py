"""The port's span tracer: named spans at the layer boundaries of the
program, their running totals, and ``torch.profiler`` traces that carry them.

A span (:class:`span`) reads ``time.monotonic_ns()`` at both ends, the clock
of the benchmark's request records, and adds to the totals of its name:

- ``count`` and ``total_ms``;
- ``self_ms``: its time less the part that its child spans on the same
  thread cover;
- ``blocked_ms``: the part that ``host.sync`` spans inside it, at any depth
  and on the same thread, cover, i.e. the host waiting on the card.

The totals go to the :class:`SpanTotals` active on the thread (:func:`use`;
a serving engine activates its own on its threads), else to
:data:`DEFAULT`.  They are always kept.  While a ``torch.profiler`` records,
each span also opens a ``record_function`` range named ``<name>#<tag>`` (a
request, batch or step id, or the rows of a model call), which lands in the
exported trace on the profiler's clock beside the kernels the span launched.

Every copy from host memory that the denoise loops and their per-batch
set-up make goes through :func:`to_device`, and any other call that blocks
the host on the card through :func:`host_sync`.  Each opens a ``host.sync``
span, so that the count of blocking calls and the time blocked come from
the same totals.

:func:`trace` writes a device trace with the program's spans, the
operator's tool next to ``/v1/stats``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterable, Iterator, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

HOST_SYNC = "host.sync"
_FIELDS = ("count", "total_ms", "self_ms", "blocked_ms")


class SpanTotals:
    """Running totals per span name: count, total, self and blocked ns,
    under a lock (spans close on many threads)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rows: Dict[str, List[int]] = {}

    def add(self, name: str, total_ns: int, self_ns: int, blocked_ns: int) -> None:
        with self._lock:
            row = self._rows.get(name)
            if row is None:
                self._rows[name] = [1, total_ns, self_ns, blocked_ns]
            else:
                row[0] += 1
                row[1] += total_ns
                row[2] += self_ns
                row[3] += blocked_ns

    def record(self, name: str, start_ns: int, end_ns: int) -> None:
        """One span from a pair of ``time.monotonic_ns()`` stamps taken
        apart, such as a request's time in a queue; it has no children."""
        ns = end_ns - start_ns
        self.add(name, ns, ns, 0)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """``{name: {"count", "total_ms", "self_ms", "blocked_ms"}}``."""
        with self._lock:
            rows = {name: tuple(row) for name, row in self._rows.items()}
        return {name: {"count": c, "total_ms": t / 1e6, "self_ms": s / 1e6, "blocked_ms": b / 1e6}
                for name, (c, t, s, b) in sorted(rows.items())}


def merge(snapshots: Iterable[Dict[str, Dict[str, float]]]) -> Dict[str, Dict[str, float]]:
    """The sum of several :meth:`SpanTotals.snapshot` results."""
    out: Dict[str, Dict[str, float]] = {}
    for snap in snapshots:
        for name, row in snap.items():
            acc = out.setdefault(name, dict.fromkeys(_FIELDS, 0))
            for key in _FIELDS:
                acc[key] += row[key]
    return dict(sorted(out.items()))


# where spans go on a thread that activated no totals of its own (the PPO
# trainers, the command line, tests)
DEFAULT = SpanTotals()


class _ThreadState(threading.local):
    def __init__(self):
        self.stack: List["span"] = []
        self.totals: Optional[SpanTotals] = None


_thread = _ThreadState()


@contextlib.contextmanager
def use(totals: Optional[SpanTotals]) -> Iterator[None]:
    """Spans that open on this thread inside the block add to ``totals``
    (None: to :data:`DEFAULT`)."""
    before = _thread.totals
    _thread.totals = totals
    try:
        yield
    finally:
        _thread.totals = before


def profiler_recording() -> bool:
    """True while a ``torch.profiler`` records, on every thread (a
    process-wide flag that the profiler sets at start and clears at stop)."""
    return _autograd_profiler._is_profiler_enabled


class span:  # noqa: N801 - used as a context manager, like ``record_function``
    """``with span(name, tag):`` times the block into the active totals;
    after the block, ``start_ns`` and ``ns`` hold its stamp and duration.
    ``tag`` is formatted into the trace range's name only while a profiler
    records (:func:`_label`)."""

    __slots__ = ("name", "tag", "start_ns", "ns", "_child", "_blocked", "_totals", "_range")

    def __init__(self, name: str, tag=None):
        self.name = name
        self.tag = tag
        self.start_ns = 0
        self.ns = 0

    def __enter__(self) -> "span":
        state = _thread
        self._totals = state.totals or DEFAULT
        self._child = self._blocked = 0
        self._range = None
        if profiler_recording():
            label = self.name if self.tag is None else f"{self.name}#{_label(self.tag)}"
            self._range = _autograd_profiler.record_function(label)
            self._range.__enter__()
        state.stack.append(self)
        self.start_ns = time.monotonic_ns()
        return self

    def __exit__(self, *exc) -> None:
        ns = self.ns = time.monotonic_ns() - self.start_ns
        stack = _thread.stack
        stack.pop()
        blocked = ns if self.name == HOST_SYNC else self._blocked
        if stack:
            parent = stack[-1]
            parent._child += ns
            parent._blocked += blocked
        if self._range is not None:
            self._range.__exit__(None, None, None)
        self._totals.add(self.name, ns, ns - self._child, blocked)


def _label(tag) -> str:
    """A span's tag as its range shows it: a tuple's parts joined by ``:``,
    a list's items by ``,`` (``(12, [40, 41])`` -> ``12:40,41``)."""
    if isinstance(tag, tuple):
        return ":".join(_label(part) for part in tag)
    if isinstance(tag, list):
        return ",".join(map(str, tag))
    return str(tag)


def host_sync() -> span:
    """The span of a call that blocks the host until the card has run what
    is queued before it."""
    return span(HOST_SYNC)


def to_device(data, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``torch.as_tensor(data, dtype=dtype, device=device)``.  Host data
    (numbers, lists, arrays, CPU tensors) is copied inside a ``host.sync``
    span: on a CUDA device the copy comes from pageable memory and blocks
    the host until the card has run everything queued before it.  A tensor
    already on ``device`` passes without a span."""
    device = torch.device(device)
    if (torch.is_tensor(data) and data.device.type == device.type
            and device.index in (None, data.device.index)):
        return torch.as_tensor(data, dtype=dtype, device=device)
    with span(HOST_SYNC):
        return torch.as_tensor(data, dtype=dtype, device=device)


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """A ``torch.profiler`` trace of every thread of the process, the CPU
    and (when there is one) the card, written to ``log_dir`` as a chrome
    trace (``*.pt.trace.json``, for tensorboard or a chrome trace viewer);
    the program's spans appear in it as ranges.  A no-op when ``log_dir``
    is None."""
    if log_dir is None:
        yield
        return
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    # the serving engines' threads are not the one that starts the profiler
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir),
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)):
        yield
