"""95th percentile of preview latency over every request due in the window."""

from perfbench.lib.readers import p95_latency_s as read  # noqa: F401
