"""Images read by their content, never by their file name.

:func:`decode_image` picks the codec from the magic bytes, as an imaging
library's ``open`` does, and converts the result as its ``convert("RGB")``
does: gray is replicated into three channels, alpha and palettes are
resolved (``utils/png.py``), and the result is ``[H, W, 3]`` uint8.  PNG and
JPEG are read; anything else raises ``ValueError`` naming its first bytes.
"""

from __future__ import annotations

import numpy as np

from consolver_torch.utils.jpeg import decode_jpeg
from consolver_torch.utils.png import SIGNATURE as PNG_SIGNATURE
from consolver_torch.utils.png import decode_png

JPEG_MAGIC = b"\xff\xd8\xff"


def decode_image(raw: bytes) -> np.ndarray:
    """PNG or JPEG bytes -> ``[H, W, 3]`` uint8 RGB."""
    if raw.startswith(PNG_SIGNATURE):
        return decode_png(raw)
    if raw.startswith(JPEG_MAGIC):
        pixels = decode_jpeg(raw)
        return np.repeat(pixels[..., None], 3, axis=-1) if pixels.ndim == 2 else pixels
    raise ValueError(f"unknown image format (first bytes {raw[:8].hex()}): only PNG and JPEG "
                     "are read")


def read_image(path: str) -> np.ndarray:
    """The image file at ``path`` as ``[H, W, 3]`` uint8 RGB."""
    with open(path, "rb") as f:
        return decode_image(f.read())
