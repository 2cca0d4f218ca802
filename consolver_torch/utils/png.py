"""A PNG codec on ``zlib`` and ``struct``, with no imaging library.

The serving front-end takes and returns images as base64 PNG, and the sweep
and data-preparation tools read and write PNG files.  Scope:

* :func:`encode_png`: 8-bit RGB, non-interlaced, every row with the Sub
  filter;
* :func:`decode_png`: 8-bit gray, RGB, RGBA and palette images,
  non-interlaced, all five row filters, returned as ``[H, W, 3]``
  uint8 RGB (alpha dropped, palette looked up), as an imaging library's
  ``convert("RGB")`` gives them;
* :func:`png_size`: the ``(width, height)`` of the header alone, so that a
  caller can refuse a huge image before it decodes a pixel.

Anything else (interlaced or 16-bit PNG, another format, a corrupt stream)
raises ``ValueError``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels per pixel: gray, RGB, palette, RGBA
_CHANNELS = {0: 1, 2: 3, 3: 1, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray, level: int = 6) -> bytes:
    """``[H, W, 3]`` uint8 RGB -> PNG bytes."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"encode_png takes [H, W, 3] uint8, got {image.dtype} {image.shape}")
    h, w, _ = image.shape
    rows = image.reshape(h, w * 3)
    filtered = np.empty((h, w * 3 + 1), np.uint8)
    filtered[:, 0] = 1  # Sub: each byte minus the byte one pixel to its left
    filtered[:, 1:4] = rows[:, :3]
    filtered[:, 4:] = rows[:, 3:] - rows[:, :-3]  # uint8 arithmetic wraps mod 256
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(filtered.tobytes(), level)) + _chunk(b"IEND", b""))


def _chunks(raw: bytes):
    """(kind, data) of every chunk, CRCs checked."""
    if raw[:8] != SIGNATURE:
        raise ValueError("not a PNG image")
    pos = 8
    while pos + 12 <= len(raw):
        (length,) = struct.unpack(">I", raw[pos:pos + 4])
        kind, data = raw[pos + 4:pos + 8], raw[pos + 8:pos + 8 + length]
        if len(data) != length or pos + 12 + length > len(raw):
            raise ValueError("truncated PNG chunk")
        (crc,) = struct.unpack(">I", raw[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + data) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, data
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("PNG ends without IEND")


def _header(raw: bytes):
    """(width, height, bit depth, colour type, interlace) from IHDR."""
    if raw[:8] != SIGNATURE:
        raise ValueError("not a PNG image")
    if len(raw) < 33 or raw[12:16] != b"IHDR":
        raise ValueError("PNG without an IHDR header")
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", raw[16:29])
    return w, h, depth, ctype, interlace


def png_size(raw: bytes):
    """``(width, height)`` from the IHDR header alone."""
    w, h, *_ = _header(raw)
    return w, h


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters -> ``[h, stride]`` uint8."""
    rows = np.frombuffer(data, np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError(f"PNG image data holds {rows.size} bytes, want {h * (stride + 1)}")
    rows = rows.reshape(h, stride + 1)
    out = np.zeros((h + 1, stride), np.uint8)  # row 0: the zero row above the first
    for y in range(h):
        ftype, cur = int(rows[y, 0]), rows[y, 1:]
        prior = out[y]
        if ftype == 0:
            out[y + 1] = cur
        elif ftype == 1:  # Sub: a running sum over each byte's pixel column
            out[y + 1] = cur.reshape(-1, bpp).cumsum(axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            out[y + 1] = cur + prior
        elif ftype in (3, 4):  # Average, Paeth: each byte needs the one to its left
            out[y + 1] = _unfilter_left(ftype, cur.tolist(), prior.tolist(), bpp)
        else:
            raise ValueError(f"unknown PNG filter type {ftype}")
    return out[1:]


def _unfilter_left(ftype: int, cur, prior, bpp: int):
    row = [0] * len(cur)
    for i, byte in enumerate(cur):
        a = row[i - bpp] if i >= bpp else 0
        b = prior[i]
        if ftype == 3:
            row[i] = (byte + ((a + b) >> 1)) & 0xFF
            continue
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        row[i] = (byte + pred) & 0xFF
    return row


def decode_png(raw: bytes) -> np.ndarray:
    """PNG bytes -> ``[H, W, 3]`` uint8 RGB."""
    w, h, depth, ctype, interlace = _header(raw)
    if ctype not in _CHANNELS:
        raise ValueError(f"PNG colour type {ctype}: only gray, RGB, RGBA and palette are read")
    if depth != 8:
        raise ValueError(f"PNG bit depth {depth}: only 8-bit images are read")
    if interlace:
        raise ValueError("interlaced PNG is not read")
    palette, idat = None, []
    for kind, data in _chunks(raw):
        if kind == b"PLTE":
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(data)
    channels = _CHANNELS[ctype]
    try:  # inflate no more than the header's size allows (a stream may expand far past it)
        data = zlib.decompressobj().decompress(b"".join(idat), h * (w * channels + 1) + 1)
    except zlib.error as exc:
        raise ValueError(f"corrupt PNG image data: {exc}") from exc
    pixels = _unfilter(data, h, w * channels, channels).reshape(h, w, channels)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        if int(pixels.max(initial=0)) >= len(palette):
            raise ValueError("PNG palette index out of range")
        return palette[pixels[..., 0]]
    if ctype == 0:
        return np.repeat(pixels, 3, axis=-1)
    return np.ascontiguousarray(pixels[..., :3])


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def write_png(path: str, image: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(image))
