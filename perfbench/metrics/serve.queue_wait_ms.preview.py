"""Median submit-to-dispatch wait of the window's previews (engine ring)."""

from perfbench.lib.readers import median_ring_ms


def read(rec):
    return median_ring_ms(rec, "wait_ms")
