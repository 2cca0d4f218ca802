"""Profiling hooks: ``torch.profiler`` traces and per-phase step timing.

Port of ``consolver_tpu/utils/profiling.py``.  On the card the host returns
before the device finishes, so :meth:`StepTimer.phase` synchronises the
card before it reads the clock at either end of a phase: a phase's time is
its device work, not its dispatch.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """A ``torch.profiler`` trace of the CPU and (when there is one) the
    card, written to ``log_dir`` for tensorboard or a chrome trace viewer;
    a no-op when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StepTimer:
    """Wall-clock per-phase timing with running means; each phase starts and
    ends with a synchronise of the card."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        _sync()
        start = time.perf_counter()
        try:
            yield
        finally:
            _sync()
            elapsed = time.perf_counter() - start
            self.totals[name] = self.totals.get(name, 0.0) + elapsed
            self.counts[name] = self.counts.get(name, 0) + 1

    def means(self) -> Dict[str, float]:
        return {k: self.totals[k] / self.counts[k] for k in self.totals}

    def annotate(self, name: str):
        """A named region in profiler traces (``torch.profiler.record_function``)."""
        return torch.profiler.record_function(name)
