"""Editing-dataset preparation (an OmniEdit-style folder -> the teacher's
input layout).

Port of ``consolver_tpu/data/edit_prep.py``: center-crop reference images to
a square resolution and pair them with edit instructions.  The resize is a
Lanczos-3 resample of its own that follows the imaging library the JAX
package calls: the filter's support grows with the downscale factor, each
output's weights are normalised to sum to one and then quantised to 22
fraction bits, the horizontal pass runs first, and each pass rounds to 8
bits.  Images are read as PNG (``utils/png.py``).
"""

from __future__ import annotations

import json
import math
import os
from typing import List, Optional, Tuple

import numpy as np

from consolver_torch.utils.png import read_png

_SUPPORT = 3.0  # Lanczos-3
_PRECISION_BITS = 32 - 8 - 2


def _lanczos(x: float) -> float:
    def sinc(v):
        if v == 0.0:
            return 1.0
        v = v * math.pi
        return math.sin(v) / v

    return sinc(x) * sinc(x / 3) if -_SUPPORT <= x < _SUPPORT else 0.0


def _coefficients(in_size: int, out_size: int):
    """Per output index: the first input index and the fixed-point weights
    ``[out_size, taps]`` (zero past each output's own window)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _SUPPORT * filterscale
    ss = 1.0 / filterscale
    taps = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, taps), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [_lanczos((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        total = sum(w)
        for x, wx in enumerate(w):
            wx = wx / total if total != 0.0 else wx
            # round half away from zero, as C's (int)(w * 2^22 +- 0.5)
            weights[xx, x] = int(wx * (1 << _PRECISION_BITS) + (0.5 if wx >= 0 else -0.5))
        first[xx] = xmin
    return first, weights


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One 8-bit resampling pass along ``axis`` (0 = rows, 1 = columns)."""
    in_size = img.shape[axis]
    first, weights = _coefficients(in_size, out_size)
    # 32-bit sums, as the library's: 255 * (sum of the positive weights, at
    # most about 1.1 * 2^22) stays below 2^31
    acc = np.full(img.shape[:axis] + (out_size,) + img.shape[axis + 1:],
                  1 << (_PRECISION_BITS - 1), np.int32)
    src = img.astype(np.int32)
    for k in range(weights.shape[1]):
        idx = np.minimum(first + k, in_size - 1)  # weight 0 past the window
        w = weights[:, k].astype(np.int32).reshape((-1,) + (1,) * (img.ndim - axis - 1))
        acc += np.take(src, idx, axis=axis) * w
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def lanczos_resize(image: np.ndarray, width: int, height: int) -> np.ndarray:
    """``[H, W, C]`` uint8 -> ``[height, width, C]`` uint8, horizontal pass
    first; an axis whose size does not change is not resampled."""
    out = image
    if width != image.shape[1]:
        out = _resample_axis(out, width, axis=1)
    if height != image.shape[0]:
        out = _resample_axis(out, height, axis=0)
    return out


def center_crop_resize(image: np.ndarray, size: int) -> np.ndarray:
    """``[H, W, 3]`` uint8 / float -> ``[size, size, 3]`` float32 in [0, 1]:
    scale the short side to ``size``, then crop the center."""
    img = image.astype(np.uint8) if image.dtype != np.uint8 else image
    h, w = img.shape[:2]
    scale = size / min(w, h)
    img = lanczos_resize(img, round(w * scale), round(h * scale))
    h, w = img.shape[:2]
    left, top = (w - size) // 2, (h - size) // 2
    img = img[top:top + size, left:left + size]
    return np.asarray(img, np.float32) / 255.0


def read_instruction_records(root: str) -> List[dict]:
    """``{"path", "instruction", "key"}`` records from either
    ``metadata.jsonl`` or sidecar .txt files next to images.

    The kontext-bench layout carries ``file_name`` / ``instruction`` /
    ``key`` with the image at ``<root>/images/<basename(file_name)>``;
    generic layouts (``{"image"|"ref_image": ..., "instruction"|"prompt"|
    "edit": ...}`` relative to ``root``) work too.  Entries whose image file
    does not exist are skipped."""
    jsonl = os.path.join(root, "metadata.jsonl")
    records: List[dict] = []
    if os.path.exists(jsonl):
        with open(jsonl) as f:
            for line in f:
                if not line.strip():
                    continue
                rec = json.loads(line)
                img = rec.get("image") or rec.get("ref_image") or rec.get("file_name")
                instr = rec.get("instruction") or rec.get("prompt") or rec.get("edit")
                if not (img and instr):
                    continue
                path = os.path.join(root, img)
                if not os.path.exists(path):
                    # kontext-bench: images/ subdir, basename only
                    alt = os.path.join(root, "images", os.path.basename(img))
                    if not os.path.exists(alt):
                        continue
                    path = alt
                records.append({"path": path, "instruction": instr, "key": rec.get("key")})
        return records
    for f in sorted(os.listdir(root)):
        if f.lower().endswith((".png", ".jpg", ".jpeg")):
            txt = os.path.join(root, os.path.splitext(f)[0] + ".txt")
            if os.path.exists(txt):
                with open(txt) as fh:
                    records.append({"path": os.path.join(root, f),
                                    "instruction": fh.read().strip(), "key": None})
    return records


def read_instruction_pairs(root: str) -> List[Tuple[str, str]]:
    """(image_path, instruction) pairs; see :func:`read_instruction_records`."""
    return [(r["path"], r["instruction"]) for r in read_instruction_records(root)]


def prepare_edit_set(
    source_dir: str,
    output_dir: str,
    resolution: int = 1024,
    max_samples: Optional[int] = None,
) -> int:
    """Write ``{i}.npz`` with (ref_image in [-1, 1], instruction) pairs for
    the teacher rollout.  Images that cannot be read as PNG (another format,
    a corrupt file) are skipped.  Returns the number written."""
    os.makedirs(output_dir, exist_ok=True)
    pairs = read_instruction_pairs(source_dir)[:max_samples]
    n = 0
    for i, (img_path, instruction) in enumerate(pairs):
        try:
            image = read_png(img_path)
        except (OSError, ValueError):
            continue
        cropped = center_crop_resize(image, resolution) * 2.0 - 1.0
        np.savez(os.path.join(output_dir, f"{i:06d}.npz"),
                 ref_image=cropped.astype(np.float32), instruction=np.asarray(instruction))
        n += 1
    return n
