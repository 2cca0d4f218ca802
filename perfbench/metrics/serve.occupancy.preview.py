"""Rows served over rows computed across the window (engine counters)."""

from perfbench.lib.readers import occupancy_pct as read  # noqa: F401
