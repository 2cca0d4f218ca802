"""Median worker host time per preview batch (engine ring)."""

from perfbench.lib.readers import median_ring_ms


def read(rec):
    return median_ring_ms(rec, "dispatch_ms")
