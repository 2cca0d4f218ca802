"""Share of device busy time in kernels launched inside the MMDiT's forward."""

from perfbench.lib.readers import span_share_pct


def read(rec):
    return span_share_pct(rec, "pb.mmdit")
