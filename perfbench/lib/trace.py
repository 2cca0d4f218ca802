"""The traced slice: spans the benchmark attaches from its own files, the
profiler over a steady stretch of the window, and the reduction of its
trace to the records that the per-layer metric readers take.

Spans are ``record_function`` ranges opened by forward pre-hooks and closed
by forward hooks on the program's modules, named ``pb.<what>#<rows>`` (the
rows of the call's first input), so no program file changes.  A device
operation belongs to the innermost ``pb.`` span, one call of one module,
that was open on the thread that launched it, found through the launch's
correlation id.  The profiler runs a margin before and after the slice, so
that the calls whose device work reaches into the slice are in the trace
whole.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import threading
import time
from collections import defaultdict
from typing import Dict, List

from perfbench.lib.stats import covered, gaps

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SLICE_SPAN = "pb.slice"


class Spans:
    """Forward hooks that open a ``record_function`` range around each call
    of a module, named after the module and the rows of the call."""

    def __init__(self):
        self._local = threading.local()
        self._handles = []

    def attach(self, module, name: str) -> None:
        from torch.autograd.profiler import record_function

        def pre(mod, args, kwargs=None):
            stack = getattr(self._local, "stack", None)
            if stack is None:
                stack = self._local.stack = []
            first = args[0] if args else None
            rows = int(first.shape[0]) if hasattr(first, "shape") and first.ndim else 0
            rf = record_function(f"{name}#{rows}")
            rf.__enter__()
            stack.append(rf)

        def post(mod, args, out):
            self._local.stack.pop().__exit__(None, None, None)

        self._handles.append(module.register_forward_pre_hook(pre))
        self._handles.append(module.register_forward_hook(post))

    def detach(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []


class Profiler:
    """The profiler over every thread of the process: :meth:`trace_slice`
    while the window is open, :meth:`reduce` once it is over (exporting and
    reading the trace takes the host's time)."""

    def __init__(self):
        self._prof = None

    def trace_slice(self, t0: float, start_s: float, seconds: float, margin_s: float) -> None:
        """Profile ``[t0 + start_s, + seconds)`` (``time.monotonic()``) as
        the slice, with the profiler on ``margin_s`` before and after it."""
        import torch
        from torch.autograd.profiler import record_function
        from torch.profiler import ProfilerActivity, profile

        kwargs = {}
        try:
            from torch._C._profiler import _ExperimentalConfig

            kwargs["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
        except (ImportError, TypeError):
            pass
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        start = t0 + start_s
        time.sleep(max(0.0, start - margin_s - time.monotonic()))
        self._prof = profile(activities=activities, **kwargs)
        self._prof.__enter__()
        time.sleep(max(0.0, start - time.monotonic()))
        with record_function(SLICE_SPAN):
            time.sleep(seconds)
        time.sleep(margin_s)
        self._prof.__exit__(None, None, None)

    def reduce(self) -> dict:
        """The reduced trace (:func:`reduce_trace`)."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            self._prof = None
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return reduce_trace(events)


def _innermost(spans_by_tid, tid, ts):
    """The innermost span ``(start, end, name, ...)`` of
    ``spans_by_tid[tid]`` (sorted by start) that holds ``ts``, or None."""
    spans = spans_by_tid.get(tid)
    if not spans:
        return None
    starts, xs, longest = spans
    # spans of one thread nest, so the latest-starting span that holds ts is
    # the innermost; none that starts more than the longest span earlier can
    for j in range(bisect.bisect_right(starts, ts) - 1, -1, -1):
        start, end = xs[j][:2]
        if end >= ts:
            return xs[j]
        if ts - start > longest:
            break
    return None


def _index(spans):
    by_tid = defaultdict(list)
    for tid, *span in spans:
        by_tid[tid].append(tuple(span))
    out = {}
    for tid, xs in by_tid.items():
        xs.sort()
        out[tid] = ([x[0] for x in xs], xs, max(x[1] - x[0] for x in xs))
    return out


def reduce_trace(events: List[dict]) -> dict:
    """Reduce chrome-trace events to: the slice (us); the ``pb.`` calls
    (``span``, ``rows``); every device operation of the trace with its
    ``span`` name and ``call`` (index into the calls) where a ``pb.`` span
    launched it; device busy seconds in the slice (the union of device
    operations over every stream); and the slice's breakdown (top device
    operations, longest idle gaps labelled by the host work around them)."""
    slice_ = None
    device, launches, pb_spans, host_spans = [], {}, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            corr = (e.get("args") or {}).get("correlation")
            device.append((ts, ts + dur, e.get("name", "?"), corr))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (e.get("tid"), ts)
            host_spans.append((e.get("tid"), ts, ts + dur, e.get("name", "?")))
        elif cat == "user_annotation":
            if e.get("name") == SLICE_SPAN:
                slice_ = (ts, ts + dur)
            elif str(e.get("name", "")).startswith("pb."):
                pb_spans.append((e.get("tid"), ts, ts + dur, e["name"], len(pb_spans)))
        elif cat == "cpu_op":
            host_spans.append((e.get("tid"), ts, ts + dur, e.get("name", "?")))
    if slice_ is None:
        raise RuntimeError("the trace holds no slice span")
    calls = []
    for *_, name, _ in pb_spans:
        span, _, rows = name.partition("#")
        calls.append({"span": span, "rows": int(rows or 0)})
    pb_index, host_index = _index(pb_spans), _index(host_spans + pb_spans)

    ops = []
    for start, end, name, corr in device:
        tid, launch_ts = launches.get(corr, (None, None))
        call = _innermost(pb_index, tid, launch_ts) if tid is not None else None
        ops.append({"start": start, "end": end, "name": name, "tid": tid,
                    "span": calls[call[3]]["span"] if call else None,
                    "call": call[3] if call else None})
    ops.sort(key=lambda o: o["start"])
    in_slice = [o for o in ops if o["end"] > slice_[0] and o["start"] < slice_[1]]
    busy_us = covered(((o["start"], o["end"]) for o in in_slice), slice_)
    return {
        "slice_us": slice_, "window_s": (slice_[1] - slice_[0]) / 1e6, "busy_s": busy_us / 1e6,
        "calls": calls, "ops": ops, "breakdown": _breakdown(in_slice, slice_, host_index),
    }


def call_shares(tr: dict, pred=lambda o: True) -> Dict[int, float]:
    """Call index -> the share of its device time (of the operations that
    ``pred`` keeps) that falls inside the slice: the share of the call's
    work that the slice holds."""
    lo, hi = tr["slice_us"]
    total: Dict[int, float] = defaultdict(float)
    inside: Dict[int, float] = defaultdict(float)
    for o in tr["ops"]:
        if o["call"] is None or o["end"] <= o["start"] or not pred(o):
            continue
        total[o["call"]] += o["end"] - o["start"]
        inside[o["call"]] += max(0.0, min(o["end"], hi) - max(o["start"], lo))
    return {c: inside[c] / t for c, t in total.items()}


def busy_s_of(ops: List[dict], slice_us, pred) -> float:
    """Seconds of the union of the device operations that ``pred`` keeps."""
    return covered(((o["start"], o["end"]) for o in ops if pred(o)), slice_us) / 1e6


def _breakdown(ops, slice_, host_index) -> dict:
    by_name: Dict[str, float] = defaultdict(float)
    for o in ops:
        by_name[o["name"][:120]] += (min(o["end"], slice_[1]) - max(o["start"], slice_[0])) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    holes = sorted(gaps([(o["start"], o["end"]) for o in ops], slice_),
                   key=lambda g: g[0] - g[1])[:10]
    starts = [o["start"] for o in ops]
    labelled = []
    for a, b in holes:
        mid = (a + b) / 2
        j = bisect.bisect_left(starts, b)
        nxt = ops[j] if j < len(ops) else None
        label = "host: no launch after the gap"
        if nxt is not None and nxt["tid"] is not None:
            inner = _innermost(host_index, nxt["tid"], mid)
            label = (f"{nxt['span'] or 'outside pb spans'} / "
                     f"{inner[2] if inner else 'between host ops'}")
        labelled.append([label, (b - a) / 1e6])
    return {"device_ops": [[n, s] for n, s in top], "idle_gaps": labelled}
