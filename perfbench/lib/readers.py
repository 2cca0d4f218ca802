"""What the metric files under ``perfbench/metrics/`` read from a run's
records.  Each function takes the records and returns a number, or None
where the run holds nothing to read (the harness then leaves the metric out).

The records (``rec``), as ``perfbench/run.py`` gathers them:

``setup_s``; ``t0`` / ``t1`` (the window, ``time.monotonic()``);
``requests`` (the driver's record of every request or step due in the
window: ``due``, ``sent``, ``done``, ``ok``); the driver's counters (the
serving drivers: ``stats_before`` / ``stats_after``, the engine's counters,
and ``wait_ms`` / ``dispatch_ms``, the engine's ring entries added over the
window); with ``--trace 1``: ``trace`` (``perfbench/lib/trace.py``:
the slice, the ``pb.`` calls, the device operations) and ``work(span,
rows)`` (the operations of one call).
"""

from __future__ import annotations

import statistics
from typing import Iterable, Optional

from perfbench.lib import flops
from perfbench.lib.stats import latencies, percentile
from perfbench.lib.trace import busy_s_of, call_shares


def p95_latency_s(rec) -> Optional[float]:
    """95th percentile over all requests due in the window, due time (send
    time in a closed loop) to the last byte; a failure counts as missing."""
    reqs = rec["requests"]
    return percentile(latencies(reqs), 95.0) if reqs else None


def seconds_per_completed(rec) -> Optional[float]:
    """The window's wall time, first send to last answer, over the
    requests completed."""
    done = [r for r in rec["requests"] if r["ok"]]
    if not done:
        return None
    return (max(r["done"] for r in done) - min(r["sent"] for r in rec["requests"])) / len(done)


def median_ring_ms(rec, ring: str) -> Optional[float]:
    xs = rec.get(ring) or []
    return statistics.median(xs) if xs else None


def occupancy_pct(rec) -> Optional[float]:
    """Rows served over rows computed (padding included) over the window."""
    a, b = rec["stats_before"], rec["stats_after"]
    served = b["batched_rows"] - a["batched_rows"]
    computed = served + b["padded_rows"] - a["padded_rows"]
    return 100.0 * served / computed if computed else None


def idle_pct(rec) -> Optional[float]:
    """Share of the traced slice in which nothing ran on the device."""
    tr = rec.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def span_share_pct(rec, span: str) -> Optional[float]:
    """Share of the device's busy time in operations launched inside
    ``span``."""
    tr = rec.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    mine = busy_s_of(tr["ops"], tr["slice_us"], lambda o: o["span"] == span)
    return 100.0 * mine / tr["busy_s"] if mine > 0 else None


def roofline_pct(rec, kernels: Iterable[str], spans: Iterable[str]) -> Optional[float]:
    """The least time of the slice's attention work over the device time of
    the kernels named (substrings) that ``spans`` calls launched in the
    slice.  Each call's attention work (at the rows it computed) counts by
    the share of its kernels' device time that falls inside the slice."""
    tr = rec.get("trace")
    if not tr:
        return None
    kernels, spans = tuple(kernels), tuple(spans)
    calls = tr["calls"]

    def mine(o):
        return (o["call"] is not None and calls[o["call"]]["span"] in spans
                and any(k in o["name"] for k in kernels))

    dev_s = busy_s_of(tr["ops"], tr["slice_us"], mine)
    least = 0.0
    for c, share in call_shares(tr, mine).items():
        work = rec["work"](calls[c]["span"], calls[c]["rows"])
        least += share * sum(flops.attention_bound_s(call)[0] for call in work.attn)
    if dev_s <= 0 or least <= 0:
        return None
    return 100.0 * least / dev_s


def mfu_pct(rec, spans: Iterable[str]) -> Optional[float]:
    """Model FLOPs of the rows served in the slice over the bf16 peak times
    the device's busy seconds in the slice.  Each ``spans`` call's
    operations count by the share of its device time inside the slice,
    times the window's served share of rows computed."""
    tr = rec.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    spans, calls = tuple(spans), tr["calls"]
    share = (occupancy_pct(rec) or 100.0) / 100.0
    total = sum(inside * rec["work"](calls[c]["span"], calls[c]["rows"]).flops
                for c, inside in call_shares(tr).items() if calls[c]["span"] in spans)
    if total <= 0:
        return None
    return 100.0 * total * share / (flops.BF16_PEAK_FLOPS * tr["busy_s"])
