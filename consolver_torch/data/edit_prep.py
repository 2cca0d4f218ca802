"""Editing-dataset preparation (an OmniEdit-style folder -> the teacher's
input layout).

Port of ``consolver_tpu/data/edit_prep.py``: center-crop reference images to
a square resolution and pair them with edit instructions.  The resize is
``utils/resize.lanczos_resize``, which follows the imaging library the JAX
package calls bit for bit.  Images are read by their content, PNG or JPEG
(``utils/image.py``).
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np

from consolver_torch.utils.image import read_image
from consolver_torch.utils.resize import lanczos_resize


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
    the teacher rollout.  Images that cannot be read (another format than
    PNG or JPEG, a corrupt file) are skipped.  Returns the number written."""
    os.makedirs(output_dir, exist_ok=True)
    pairs = read_instruction_pairs(source_dir)[:max_samples]
    n = 0
    for i, (img_path, instruction) in enumerate(pairs):
        try:
            image = read_image(img_path)
        except (OSError, ValueError):
            continue
        cropped = center_crop_resize(image, resolution) * 2.0 - 1.0
        np.savez(os.path.join(output_dir, f"{i:06d}.npz"),
                 ref_image=cropped.astype(np.float32), instruction=np.asarray(instruction))
        n += 1
    return n
