"""The program's span totals over a run's window, as the per-layer readers
of the program's spans take them.

The serving engines report their spans' running totals in ``stats()``
(``consolver_torch/utils/profiling.py``): ``{name: {"count", "total_ms",
"self_ms", "blocked_ms"}}``, ``blocked_ms`` being the time of the
``host.sync`` spans inside a span.  The serving drivers record ``stats()``
before and after the window (``stats_before`` / ``stats_after``); the
window's totals are the difference.  A program without spans (an older
commit) reports none, and every function here then returns None.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional


def window_spans(rec) -> Optional[Dict[str, Dict[str, float]]]:
    """``{name: {"count", "total_ms", "self_ms", "blocked_ms"}}`` over the
    window, for the spans that closed in it; None where the program reports
    no spans."""
    after = (rec.get("stats_after") or {}).get("spans")
    if after is None:
        return None
    before = (rec.get("stats_before") or {}).get("spans") or {}
    out = {}
    for name, row in after.items():
        prev = before.get(name, {})
        diff = {key: value - prev.get(key, 0) for key, value in row.items()}
        if diff["count"] > 0:
            out[name] = diff
    return out


def mean_ms(rec, names: Iterable[str], per: str, key: str = "total_ms") -> Optional[float]:
    """The window's ``key`` of the spans ``names``, summed, per closed span
    ``per``; None where the window holds none of ``names`` or no ``per``."""
    spans = window_spans(rec)
    if not spans or per not in spans:
        return None
    found = [spans[name][key] for name in names if name in spans]
    return sum(found) / spans[per]["count"] if found else None


def step_host_ms(rec) -> Optional[float]:
    """Mean per denoise step (``pipeline.step``, pad steps included) of its
    time less the ``host.sync`` time inside it: the host launching the
    step.  A launch that waits for room in a full launch queue (the FLUX
    DiT's step) waits on the card inside this time, since it is no
    ``host.sync`` call."""
    total = mean_ms(rec, ["pipeline.step"], "pipeline.step")
    blocked = step_blocked_ms(rec)
    return None if total is None or blocked is None else total - blocked


def step_blocked_ms(rec) -> Optional[float]:
    """Mean per denoise step of the ``host.sync`` time inside it: the host
    blocked in the step's copies and reads from the card (not in launches
    that wait for room in the launch queue)."""
    return mean_ms(rec, ["pipeline.step"], "pipeline.step", key="blocked_ms")


def codec_ms(rec) -> Optional[float]:
    """Mean per request (``serve.request``) of the HTTP handler's PNG work:
    the source's decode (``serve.png_decode``, edits) and the answer's
    encode (``serve.png_encode``)."""
    return mean_ms(rec, ["serve.png_decode", "serve.png_encode"], "serve.request")


def prep_ms(rec) -> Optional[float]:
    """Mean per batch of the engine's host preparation (``engine.prep``:
    tokenizing, and an edit's source resize)."""
    return mean_ms(rec, ["engine.prep"], "engine.prep")
