"""Model FLOPs of the previews served in the slice (CLIP-L, bigG, T5, MMDiT, VAE decode) over
the bf16 peak times the device's busy seconds."""

from perfbench.lib.readers import mfu_pct

SPANS = ("pb.clip", "pb.clip_g", "pb.t5", "pb.mmdit", "pb.vae_decode")


def read(rec):
    return mfu_pct(rec, SPANS)
