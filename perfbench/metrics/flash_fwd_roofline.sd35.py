"""Kernel #1 (flash_fwd) against its roofline: the least time of the slice's MMDiT joint
attention (head dim 64) and VAE decoder attention calls over the device time of the kernels
named here."""

from perfbench.lib.readers import roofline_pct

KERNELS = ("flash_fwd",)
SPANS = ("pb.mmdit", "pb.vae_decode")


def read(rec):
    return roofline_pct(rec, KERNELS, SPANS)
