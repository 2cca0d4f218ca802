"""Model FLOPs of the edits served in the slice (T5, CLIP, VAE encode, DiT, VAE decode) over
the bf16 peak times the device's busy seconds."""

from perfbench.lib.readers import mfu_pct

SPANS = ("pb.t5", "pb.clip", "pb.vae_encode", "pb.dit", "pb.vae_decode")


def read(rec):
    return mfu_pct(rec, SPANS)
