"""Share of device busy time in kernels launched inside the UNet's forward."""

from perfbench.lib.readers import span_share_pct


def read(rec):
    return span_share_pct(rec, "pb.unet")
