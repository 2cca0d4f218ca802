"""Model FLOPs of the previews served in the slice (CLIP, UNet, VAE decode) over the bf16
peak times the device's busy seconds."""

from perfbench.lib.readers import mfu_pct

SPANS = ("pb.text", "pb.unet", "pb.vae_decode")


def read(rec):
    return mfu_pct(rec, SPANS)
