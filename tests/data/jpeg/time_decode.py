"""Time the port's JPEG decoder (``consolver_torch/utils/jpeg.py``) on the
host beside PIL's, on the kind of file it reads in use: a photo-like image
of 1024 x 1024 (a colour texture with the 1/f^1.6 amplitude spectrum of
natural photographs, plus sensor-like noise) saved by PIL at quality 90
with 4:2:0 chroma, about 220 KB like a kontext-bench photo; and the 512 x
512 fixture ``big_420_512.jpg`` (flat tiles, the image ``chip_smoke.py``
times on the GPU machine's host).  Needs PIL.  Run from the repository
root::

  python tests/data/jpeg/time_decode.py [--size 1024] [--repeats 5]

Prints one JSON line per image: its bytes, the decoder's median and
minimum ms, MB/s of the compressed stream at the median, PIL's median ms,
and whether the decode is bit-equal to PIL's.
"""

import argparse
import io
import json
import os
import statistics
import sys
import time

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

from consolver_torch.utils.jpeg import decode_jpeg  # noqa: E402


def photo(size: int, seed: int, slope: float = 1.6) -> np.ndarray:
    """``[size, size, 3]`` uint8: luminance and two chroma fields of
    amplitude ``f ** -slope``, mixed into RGB, with Gaussian noise."""
    rng = np.random.default_rng(seed)
    f = np.hypot(np.fft.fftfreq(size)[:, None], np.fft.rfftfreq(size)[None, :])
    f[0, 0] = 1.0

    def field():
        spec = (rng.normal(size=f.shape) + 1j * rng.normal(size=f.shape)) * f ** -slope
        spec[0, 0] = 0
        x = np.fft.irfft2(spec, s=(size, size))
        return x / x.std()

    lum, c1, c2 = field(), field(), field()
    img = np.stack([lum + 0.4 * c1, lum - 0.2 * c1 + 0.3 * c2, lum - 0.5 * c2], axis=-1)
    img = 128 + 45 * img + rng.normal(0, 3, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def photo_jpeg(size: int, seed: int = 0) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(photo(size, seed)).save(buf, "JPEG", quality=90, subsampling=2)
    return buf.getvalue()


def time_decode(name: str, raw: bytes, repeats: int) -> dict:
    ours, theirs = [], []
    for _ in range(repeats):
        t0 = time.perf_counter()
        got = decode_jpeg(raw)
        ours.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        want = np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))
        theirs.append(time.perf_counter() - t0)
    median = statistics.median(ours)
    return {"image": name, "bytes": len(raw), "shape": list(got.shape),
            "decode_ms_median": 1e3 * median, "decode_ms_min": 1e3 * min(ours),
            "mb_per_s": len(raw) / median / 1e6,
            "pil_ms_median": 1e3 * statistics.median(theirs),
            "bit_equal": bool(np.array_equal(got, want))}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    with open(os.path.join(HERE, "big_420_512.jpg"), "rb") as fh:
        fixture = fh.read()
    rows = [time_decode(f"photo_{args.size}_q90_420", photo_jpeg(args.size), args.repeats),
            time_decode("big_420_512", fixture, args.repeats)]
    for row in rows:
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
