"""A JPEG decoder in numpy, with no imaging library.

The eval and data tools read the images users hand them by content, and
many of those are JPEG (kontext-bench sources, folders of generated edits).
This decoder aims at the pixels an imaging library built on libjpeg-turbo
gives with its default settings, bit for bit:

* baseline sequential (SOF0, SOF1) and progressive (SOF2) Huffman-coded
  8-bit JPEG, with 1 or 3 components and any integral sampling factors,
  restart intervals (DRI / RSTn), and APPn / COM / EXIF segments skipped;
* dequantization and the integer "islow" IDCT of ``jidctint.c``, with its
  range-limit table;
* "fancy" upsampling of subsampled chroma (``jdsample.c``: the triangle
  filters ``h2v1`` / ``h2v2`` / ``h1v2`` with their alternating rounding
  biases and replicated edges; box replication where libjpeg-turbo takes
  it: widths of 2 or less, other integral factors);
* fixed-point YCbCr -> RGB of ``jdcolor.c`` (16-bit tables), or none for
  an Adobe RGB JPEG.

The Huffman decode is a Python loop over a 16-bit lookahead table; the IDCT,
the upsampling and the colour conversion are vectorised over every block.
Arithmetic coding, 12-bit precision, lossless and hierarchical frames,
4-component (CMYK / YCCK) images, and progressive files whose scans leave
low AC coefficients unrefined (libjpeg-turbo block-smooths those) raise
``ValueError``.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SOI = b"\xff\xd8"
# zigzag position -> natural (row-major) index, with the 16 guard entries of
# libjpeg's jpeg_natural_order for corrupt runs past position 63
NATURAL_ORDER = (
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
) + (63,) * 16

_SOF_NAMES = {
    0xC3: "lossless", 0xC5: "differential sequential", 0xC6: "differential progressive",
    0xC7: "differential lossless", 0xC9: "arithmetic-coded sequential",
    0xCA: "arithmetic-coded progressive", 0xCB: "arithmetic-coded lossless",
    0xCD: "arithmetic-coded differential sequential",
    0xCE: "arithmetic-coded differential progressive",
    0xCF: "arithmetic-coded differential lossless",
}


def _sof_name(marker: int) -> str:
    return f"SOF{marker - 0xC0}"


class _Component:
    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.qtable: Optional[np.ndarray] = None  # latched at the component's first scan
        self.coef: List[int] = []
        self.bw = self.bh = self.width = self.height = 0
        self.coef_bits = [-1] * 64  # bits still missing per zigzag position (progressive)


def _huffman_lut(counts: Sequence[int], symbols: bytes) -> List[int]:
    """16-bit lookahead -> ``(code length << 8) | symbol``; codes that are
    not in the table decode as a 16-bit zero symbol, as libjpeg-turbo's
    warning path does."""
    lut = np.full(1 << 16, 16 << 8, np.int32)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            shift = 16 - length
            lut[code << shift:(code + 1) << shift] = (length << 8) | symbols[k]
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


def _windows(segment: bytes) -> List[int]:
    """Unstuffed entropy-coded bytes -> the 32-bit big-endian word at every
    byte offset (zero-padded past the end, as libjpeg feeds zeros at a
    marker)."""
    b = np.frombuffer(segment.replace(b"\xff\x00", b"\xff") + bytes(8), np.uint8).astype(np.uint32)
    return ((b[:-7] << 24) | (b[1:-6] << 16) | (b[2:-5] << 8) | b[3:-4]).tolist()


def _entropy_segments(data: bytes, pos: int) -> Tuple[List[bytes], int]:
    """The restart intervals of the scan that starts at ``pos``, and the
    offset of the marker that ends it."""
    segments, start, i = [], pos, pos
    n = len(data)
    while True:
        j = data.find(b"\xff", i)
        if j < 0 or j + 1 >= n:
            segments.append(data[start:])
            return segments, n
        nxt = data[j + 1]
        if nxt == 0x00 or nxt == 0xFF:  # stuffed byte, or a fill byte before a marker
            i = j + 1 if nxt == 0xFF else j + 2
            continue
        if 0xD0 <= nxt <= 0xD7:
            segments.append(data[start:j])
            start = i = j + 2
            continue
        segments.append(data[start:j])
        return segments, j


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


class _Scan:
    """One scan: its components, tables, spectral band and block order."""

    def __init__(self, comps, dc_luts, ac_luts, ss, se, ah, al, blocks, per_mcu):
        self.comps, self.dc_luts, self.ac_luts = comps, dc_luts, ac_luts
        self.ss, self.se, self.ah, self.al = ss, se, ah, al
        self.blocks = blocks  # [(slot in comps, block index)] in coding order
        self.per_mcu = per_mcu


def _decode_sequential(w: List[int], scan: _Scan, blocks) -> None:
    """Baseline / extended sequential Huffman blocks of one restart interval."""
    nat = NATURAL_ORDER
    coefs = [c.coef for c in scan.comps]
    dc_luts, ac_luts = scan.dc_luts, scan.ac_luts
    pred = [0] * len(scan.comps)
    p = 0
    for slot, index in blocks:
        coef = coefs[slot]
        base = index * 64
        c = dc_luts[slot][(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
        p += c >> 8
        s = c & 0xFF
        if s:
            v = (w[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
            p += s
            pred[slot] += v - (1 << s) + 1 if v < (1 << (s - 1)) else v
        coef[base] = pred[slot]
        act = ac_luts[slot]
        k = 1
        while k < 64:
            c = act[(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
            p += c >> 8
            s = c & 15
            r = (c >> 4) & 15
            if s:
                k += r
                v = (w[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
                p += s
                coef[base + nat[k]] = v - (1 << s) + 1 if v < (1 << (s - 1)) else v
                k += 1
            elif r == 15:
                k += 16
            else:
                break


def _decode_dc_first(w: List[int], scan: _Scan, blocks) -> None:
    coefs = [c.coef for c in scan.comps]
    pred = [0] * len(scan.comps)
    al, p = scan.al, 0
    for slot, index in blocks:
        c = scan.dc_luts[slot][(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
        p += c >> 8
        s = c & 0xFF
        if s:
            v = (w[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
            p += s
            pred[slot] += _extend(v, s)
        coefs[slot][index * 64] = pred[slot] << al


def _decode_dc_refine(w: List[int], scan: _Scan, blocks) -> None:
    coefs = [c.coef for c in scan.comps]
    bit, p = 1 << scan.al, 0
    for slot, index in blocks:
        if (w[p >> 3] >> (31 - (p & 7))) & 1:
            coefs[slot][index * 64] |= bit
        p += 1


def _decode_ac_first(w: List[int], scan: _Scan, blocks) -> None:
    nat = NATURAL_ORDER
    coef = scan.comps[0].coef
    act = scan.ac_luts[0]
    ss, se, al = scan.ss, scan.se, scan.al
    eobrun, p = 0, 0
    for _, index in blocks:
        if eobrun:
            eobrun -= 1
            continue
        base = index * 64
        k = ss
        while k <= se:
            c = act[(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
            p += c >> 8
            s = c & 15
            r = (c >> 4) & 15
            if s:
                k += r
                v = (w[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
                p += s
                coef[base + nat[k]] = _extend(v, s) << al
            elif r == 15:
                k += 15
            else:
                eobrun = 1 << r
                if r:
                    eobrun += (w[p >> 3] >> (32 - (p & 7) - r)) & ((1 << r) - 1)
                    p += r
                eobrun -= 1
                break
            k += 1


def _decode_ac_refine(w: List[int], scan: _Scan, blocks) -> None:
    """``jdphuff.c::decode_mcu_AC_refine``: correction bits for the
    coefficients already nonzero, new +-1 coefficients, end-of-band runs."""
    nat = NATURAL_ORDER
    coef = scan.comps[0].coef
    act = scan.ac_luts[0]
    ss, se = scan.ss, scan.se
    p1, m1 = 1 << scan.al, -1 << scan.al
    eobrun, p = 0, 0
    for _, index in blocks:
        base = index * 64
        k = ss
        if not eobrun:
            while k <= se:
                c = act[(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                p += c >> 8
                s = c & 15
                r = (c >> 4) & 15
                if s:
                    s = p1 if (w[p >> 3] >> (31 - (p & 7))) & 1 else m1
                    p += 1
                elif r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += (w[p >> 3] >> (32 - (p & 7) - r)) & ((1 << r) - 1)
                        p += r
                    break
                while k <= se:
                    pos = base + nat[k]
                    value = coef[pos]
                    if value:
                        if (w[p >> 3] >> (31 - (p & 7))) & 1 and not value & p1:
                            coef[pos] = value + (p1 if value >= 0 else m1)
                        p += 1
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                if s:
                    coef[base + nat[k]] = s
                k += 1
        if eobrun:
            while k <= se:
                pos = base + nat[k]
                value = coef[pos]
                if value:
                    if (w[p >> 3] >> (31 - (p & 7))) & 1 and not value & p1:
                        coef[pos] = value + (p1 if value >= 0 else m1)
                    p += 1
                k += 1
            eobrun -= 1


def _range_limit() -> np.ndarray:
    """``jdmaster.c::prepare_range_limit_table`` as the IDCT indexes it:
    ``table[x & 1023]`` for the IDCT output ``x`` before the +128 shift."""
    x = np.arange(1024)
    out = np.zeros(1024, np.uint8)
    out[:128] = x[:128] + 128
    out[128:512] = 255
    out[896:] = x[896:] - 896
    return out


_RANGE_LIMIT = _range_limit()
_CONST_BITS, _PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100, FIX_0_765366865 = 2446, 3196, 4433, 6270
FIX_0_899976223, FIX_1_175875602, FIX_1_501321110, FIX_1_847759065 = 7373, 9633, 12299, 15137
FIX_1_961570560, FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16069, 16819, 20995, 25172


def _idct_pass(x: Sequence[np.ndarray], shift: int) -> List[np.ndarray]:
    """One 1-D pass of ``jidctint.c::jpeg_idct_islow`` over int64 arrays
    ``x[0..7]``: the eight outputs, descaled by ``shift`` bits."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * FIX_0_541196100
    tmp2 = z1 - z3 * FIX_1_847759065
    tmp3 = z1 + z2 * FIX_0_765366865
    tmp0 = (x[0] + x[4]) << _CONST_BITS
    tmp1 = (x[0] - x[4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    tmp0, tmp1, tmp2, tmp3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = tmp0 + tmp3, tmp1 + tmp2, tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * FIX_1_175875602
    tmp0 = tmp0 * FIX_0_298631336
    tmp1 = tmp1 * FIX_2_053119869
    tmp2 = tmp2 * FIX_3_072711026
    tmp3 = tmp3 * FIX_1_501321110
    z1 = z1 * -FIX_0_899976223
    z2 = z2 * -FIX_2_562915447
    z3 = z3 * -FIX_1_961570560 + z5
    z4 = z4 * -FIX_0_390180644 + z5
    tmp0 = tmp0 + z1 + z3
    tmp1 = tmp1 + z2 + z4
    tmp2 = tmp2 + z2 + z3
    tmp3 = tmp3 + z1 + z4

    half = 1 << (shift - 1)
    return [(v + half) >> shift for v in (
        tmp10 + tmp3, tmp11 + tmp2, tmp12 + tmp1, tmp13 + tmp0,
        tmp13 - tmp0, tmp12 - tmp1, tmp11 - tmp2, tmp10 - tmp3)]


def idct_islow(coef: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """Dequantize and inverse-transform ``[N, 64]`` natural-order
    coefficients into ``[N, 8, 8]`` uint8 samples, as ``jpeg_idct_islow``
    does (columns first, then rows; its all-zero-AC shortcuts give the same
    values as the general path)."""
    blocks = (coef.astype(np.int64) * qtable.astype(np.int64)).reshape(-1, 8, 8)
    cols = _idct_pass([blocks[:, k, :] for k in range(8)], _CONST_BITS - _PASS1_BITS)
    ws = np.stack(cols, axis=1)
    rows = _idct_pass([ws[:, :, k] for k in range(8)], _CONST_BITS + _PASS1_BITS + 3)
    return _RANGE_LIMIT[np.stack(rows, axis=2) & 1023]


def _fancy_h2(x: np.ndarray) -> np.ndarray:
    """``h2v1_fancy_upsample`` along the last axis (int64 in, int64 out)."""
    left = np.concatenate([x[..., :1], x[..., :-1]], axis=-1)
    right = np.concatenate([x[..., 1:], x[..., -1:]], axis=-1)
    out = np.empty(x.shape[:-1] + (2 * x.shape[-1],), np.int64)
    out[..., 0::2] = (3 * x + left + 1) >> 2
    out[..., 1::2] = (3 * x + right + 2) >> 2
    return out


def _vertical_neighbours(x: np.ndarray):
    above = np.concatenate([x[:1], x[:-1]], axis=0)
    below = np.concatenate([x[1:], x[-1:]], axis=0)
    return above, below


def _fancy_h2v2(x: np.ndarray) -> np.ndarray:
    """``h2v2_fancy_upsample``: column sums ``3 * nearer row + further row``,
    then the horizontal triangle with biases 8 / 7."""
    above, below = _vertical_neighbours(x)
    out = np.empty((2 * x.shape[0], 2 * x.shape[1]), np.int64)
    for v, far in ((0, above), (1, below)):
        cs = 3 * x + far
        left = np.concatenate([cs[:, :1], cs[:, :-1]], axis=1)
        right = np.concatenate([cs[:, 1:], cs[:, -1:]], axis=1)
        out[v::2, 0::2] = (3 * cs + left + 8) >> 4
        out[v::2, 1::2] = (3 * cs + right + 7) >> 4
    return out


def _fancy_h1v2(x: np.ndarray) -> np.ndarray:
    above, below = _vertical_neighbours(x)
    out = np.empty((2 * x.shape[0], x.shape[1]), np.int64)
    out[0::2] = (3 * x + above + 1) >> 2
    out[1::2] = (3 * x + below + 2) >> 2
    return out


def upsample(plane: np.ndarray, hx: int, vx: int) -> np.ndarray:
    """``jdsample.c``'s choice of upsampler for an ``hx`` x ``vx`` expansion
    of a ``[downsampled_height, downsampled_width]`` plane."""
    x = plane.astype(np.int64)
    width = x.shape[1]
    if (hx, vx) == (1, 1):
        return x
    if (hx, vx) == (2, 1) and width > 2:
        return _fancy_h2(x)
    if (hx, vx) == (1, 2):
        return _fancy_h1v2(x)
    if (hx, vx) == (2, 2) and width > 2:
        return _fancy_h2v2(x)
    return np.repeat(np.repeat(x, vx, axis=0), hx, axis=1)


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """``jdcolor.c::ycc_rgb_convert`` with its 16-bit fixed-point tables."""
    one_half = 1 << 15

    def fix(v: float) -> int:
        return int(v * (1 << 16) + 0.5)

    cb, cr = cb - 128, cr - 128
    r = y + ((fix(1.40200) * cr + one_half) >> 16)
    g = y + ((-fix(0.34414) * cb + one_half - fix(0.71414) * cr) >> 16)
    b = y + ((fix(1.77200) * cb + one_half) >> 16)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


class JpegDecoder:
    """Parses one JPEG stream and decodes it with :meth:`decode`."""

    def __init__(self, data: bytes):
        if not data.startswith(SOI):
            raise ValueError(f"not a JPEG stream (starts with {data[:4].hex()})")
        self.data = data
        self.qtables: Dict[int, np.ndarray] = {}
        self.dc_luts: Dict[int, List[int]] = {}
        self.ac_luts: Dict[int, List[int]] = {}
        self.restart = 0
        self.components: List[_Component] = []
        self.progressive = False
        self.width = self.height = 0
        self.hmax = self.vmax = 1
        self.mcux = self.mcuy = 0
        self.jfif = False
        self.adobe_transform: Optional[int] = None

    # -- markers -----------------------------------------------------------

    def _segment(self, pos: int) -> Tuple[bytes, int]:
        if pos + 2 > len(self.data):
            raise ValueError("JPEG stream ends inside a marker segment")
        (length,) = struct.unpack(">H", self.data[pos:pos + 2])
        body = self.data[pos + 2:pos + length]
        if length < 2 or len(body) != length - 2:
            raise ValueError("JPEG marker segment runs past the end of the stream")
        return body, pos + length

    def _dqt(self, body: bytes) -> None:
        i = 0
        while i < len(body):
            pq, tq = body[i] >> 4, body[i] & 15
            i += 1
            size = 128 if pq else 64
            raw = np.frombuffer(body[i:i + size], ">u2" if pq else np.uint8).astype(np.int64)
            if raw.size != 64:
                raise ValueError("truncated JPEG quantization table")
            table = np.zeros(64, np.int64)
            table[list(NATURAL_ORDER[:64])] = raw
            self.qtables[tq] = table
            i += size

    def _dht(self, body: bytes) -> None:
        i = 0
        while i < len(body):
            tc, th = body[i] >> 4, body[i] & 15
            counts = body[i + 1:i + 17]
            n = sum(counts)
            symbols = body[i + 17:i + 17 + n]
            if len(counts) != 16 or len(symbols) != n:
                raise ValueError("truncated JPEG Huffman table")
            (self.ac_luts if tc else self.dc_luts)[th] = _huffman_lut(counts, symbols)
            i += 17 + n

    def _sof(self, marker: int, body: bytes) -> None:
        precision, height, width, nc = struct.unpack(">BHHB", body[:6])
        if precision != 8:
            raise ValueError(f"{_sof_name(marker)} with {precision}-bit samples: only 8-bit "
                             "JPEG is decoded")
        if nc not in (1, 3):
            raise ValueError(f"{_sof_name(marker)} with {nc} components (CMYK / YCCK): only "
                             "gray and three-component JPEG is decoded")
        if height == 0 or width == 0:
            raise ValueError(f"{_sof_name(marker)} with a zero size (DNL) is not decoded")
        self.progressive = marker == 0xC2
        self.width, self.height = width, height
        for k in range(nc):
            cid, hv, tq = body[6 + 3 * k:9 + 3 * k]
            self.components.append(_Component(cid, hv >> 4, hv & 15, tq))
        self.hmax = max(c.h for c in self.components)
        self.vmax = max(c.v for c in self.components)
        self.mcux = -(-width // (8 * self.hmax))
        self.mcuy = -(-height // (8 * self.vmax))
        for c in self.components:
            if not (1 <= c.h <= 4 and 1 <= c.v <= 4) or self.hmax % c.h or self.vmax % c.v:
                raise ValueError(f"unsupported JPEG sampling factors {c.h}x{c.v}")
            c.bw, c.bh = self.mcux * c.h, self.mcuy * c.v
            c.width = -(-width * c.h // self.hmax)
            c.height = -(-height * c.v // self.vmax)
            c.coef = [0] * (c.bw * c.bh * 64)

    def _scan(self, body: bytes) -> _Scan:
        ns = body[0]
        by_id = {c.id: c for c in self.components}
        comps, dcs, acs = [], [], []
        for k in range(ns):
            cid, tables = body[1 + 2 * k], body[2 + 2 * k]
            if cid not in by_id:
                raise ValueError(f"JPEG scan names unknown component {cid}")
            comp = by_id[cid]
            if comp.qtable is None:
                if comp.tq not in self.qtables:
                    raise ValueError(f"JPEG quantization table {comp.tq} is not defined")
                comp.qtable = self.qtables[comp.tq]
            comps.append(comp)
            dcs.append(self.dc_luts.get(tables >> 4))
            acs.append(self.ac_luts.get(tables & 15))
        ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
        ah, al = a >> 4, a & 15
        if not self.progressive:
            ss, se, ah, al = 0, 63, 0, 0
        need_dc = ss == 0 and ah == 0
        need_ac = se > 0 and (ss > 0 or not self.progressive)
        for dc, ac in zip(dcs, acs):
            if (need_dc and dc is None) or (need_ac and ac is None):
                raise ValueError("JPEG scan uses an undefined Huffman table")
        for comp in comps:
            for k in range(ss, se + 1):
                comp.coef_bits[k] = al
        blocks = []
        if ns == 1:
            comp = comps[0]
            for by in range(-(-comp.height // 8)):
                row = by * comp.bw
                blocks.extend((0, row + bx) for bx in range(-(-comp.width // 8)))
            per_mcu = 1
        else:
            per_mcu = sum(c.h * c.v for c in comps)
            for my in range(self.mcuy):
                for mx in range(self.mcux):
                    for slot, c in enumerate(comps):
                        for v in range(c.v):
                            row = (my * c.v + v) * c.bw + mx * c.h
                            blocks.extend((slot, row + h) for h in range(c.h))
        return _Scan(comps, dcs, acs, ss, se, ah, al, blocks, per_mcu)

    def _run_scan(self, scan: _Scan, segments: List[bytes]) -> None:
        if not self.progressive:
            fn = _decode_sequential
        elif scan.ss == 0:
            fn = _decode_dc_refine if scan.ah else _decode_dc_first
        else:
            if len(scan.comps) != 1:
                raise ValueError("progressive AC scan with more than one component")
            fn = _decode_ac_refine if scan.ah else _decode_ac_first
        step = self.restart * scan.per_mcu if self.restart else len(scan.blocks)
        for k, start in enumerate(range(0, len(scan.blocks), max(step, 1))):
            segment = segments[k] if k < len(segments) else b""
            try:
                fn(_windows(segment), scan, scan.blocks[start:start + step])
            except IndexError as exc:  # codes read past the zero padding
                raise ValueError("corrupt JPEG entropy-coded data") from exc

    def parse(self) -> None:
        data, pos = self.data, 2
        while pos < len(data):
            if data[pos] != 0xFF:
                pos += 1  # garbage between segments: libjpeg skips to the next marker
                continue
            marker = data[pos + 1] if pos + 1 < len(data) else 0xD9
            pos += 2
            if marker == 0xFF:
                pos -= 1
                continue
            if marker == 0xD9:
                break
            if marker in (0x01,) or 0xD0 <= marker <= 0xD7:
                continue
            body, pos = self._segment(pos)
            if marker in (0xC0, 0xC1, 0xC2):
                self._sof(marker, body)
            elif marker in _SOF_NAMES or marker == 0xCC:
                name = _SOF_NAMES.get(marker, "arithmetic conditioning (DAC)")
                label = _sof_name(marker) if marker != 0xCC else "DAC"
                raise ValueError(f"{label} ({name}) JPEG is not decoded")
            elif marker == 0xC4:
                self._dht(body)
            elif marker == 0xDB:
                self._dqt(body)
            elif marker == 0xDD:
                (self.restart,) = struct.unpack(">H", body[:2])
            elif marker == 0xE0 and body.startswith(b"JFIF\x00"):
                self.jfif = True
            elif marker == 0xEE and body.startswith(b"Adobe") and len(body) >= 12:
                self.adobe_transform = body[11]
            elif marker == 0xDA:
                if not self.components:
                    raise ValueError("JPEG scan before its frame header")
                scan = self._scan(body)
                segments, pos = _entropy_segments(data, pos)
                self._run_scan(scan, segments)
            # other APPn, COM, DNL: skipped
        if not self.components:
            raise ValueError("JPEG stream has no frame header")

    # -- pixels ------------------------------------------------------------

    def _is_rgb(self) -> bool:
        """``jdapimin.c::default_decompress_parms`` for three components."""
        if self.jfif:
            return False
        if self.adobe_transform is not None:
            return self.adobe_transform == 0
        return [c.id for c in self.components] == [82, 71, 66]

    def _plane(self, comp: _Component) -> np.ndarray:
        if comp.qtable is None:
            raise ValueError(f"JPEG component {comp.id} is in no scan")
        coef = np.asarray(comp.coef, np.int64).reshape(-1, 64)
        pixels = idct_islow(coef, comp.qtable)
        plane = pixels.reshape(comp.bh, comp.bw, 8, 8).transpose(0, 2, 1, 3)
        plane = plane.reshape(comp.bh * 8, comp.bw * 8)[:comp.height, :comp.width]
        up = upsample(plane, self.hmax // comp.h, self.vmax // comp.v)
        return up[:self.height, :self.width]

    def decode(self) -> np.ndarray:
        """``[H, W]`` uint8 for a gray JPEG, ``[H, W, 3]`` uint8 RGB else."""
        self.parse()
        if self.progressive:
            for comp in self.components:
                if any(b != 0 for b in comp.coef_bits[1:10]) and comp.coef_bits[0] >= 0:
                    raise ValueError("progressive JPEG whose scans leave low AC coefficients "
                                     "unrefined (block smoothing) is not decoded")
        planes = [self._plane(c) for c in self.components]
        if len(planes) == 1:
            return planes[0].astype(np.uint8)
        if self._is_rgb():
            return np.stack(planes, axis=-1).astype(np.uint8)
        return ycc_to_rgb(*planes)


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> ``[H, W]`` (gray) or ``[H, W, 3]`` (RGB) uint8."""
    return JpegDecoder(data).decode()
