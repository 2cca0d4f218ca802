"""Kernel #1 (flash_fwd) against its roofline: the least time of the slice's DiT and VAE
attention calls over the device time of the kernels named here."""

from perfbench.lib.readers import roofline_pct

KERNELS = ("flash_fwd",)
SPANS = ("pb.dit", "pb.vae_encode", "pb.vae_decode")


def read(rec):
    return roofline_pct(rec, KERNELS, SPANS)
