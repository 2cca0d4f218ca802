"""Seconds per edit: the window's wall time over the edits completed."""

from perfbench.lib.readers import seconds_per_completed as read  # noqa: F401
