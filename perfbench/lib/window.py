"""What a driver hands back to the harness once its window has closed."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class Window:
    """One run's window, as a driver (``perfbench/drivers/<driver>.py``,
    ``run``) drove it.

    ``t0`` / ``t1``: the window's start and close (``time.monotonic()``);
    set-up is everything before ``t0``.  ``records``: one per unit of work
    due in the window (a request, a step), each with ``due``, ``sent``,
    ``done`` and ``ok``.  ``counters``: further records for the metric
    readers, merged into theirs (``perfbench/lib/readers.py``); a ``trace``
    there stands in for the harness's own.
    ``sample``: what the configuration's ``check`` compares with the plain
    reference.  ``missing``: sampled work that never came back, which makes
    the run incorrect.  ``memory_peak_bytes``: a peak read outside this
    process (a driver's worker on another card), 0 where there is none."""

    t0: float
    t1: float
    records: List[dict]
    counters: dict = field(default_factory=dict)
    sample: List[dict] = field(default_factory=list)
    missing: List[int] = field(default_factory=list)
    memory_peak_bytes: int = 0
