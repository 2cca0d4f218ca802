"""Consistency-metric evaluation: reward statistics between a generated
directory and a teacher / reference directory.

Port of ``consolver_tpu/eval/consistency.py`` (the reference's
compute_reward.py:52-465): files pair by relative path, the reward runs as
one batched call per chunk of pairs on the card, and the result holds the
same statistics (mean / std / min / max / median and counts) and per-item
``errors`` records ``{path, reason}``.  Images are read by their content,
PNG or JPEG (``utils/image.py``), and, given ``size``, resized with
``utils/resize``'s PIL-exact Lanczos.  With ``mesh=`` every rank reads
the pairs, each data rank scores its slice of every chunk (padded to a
multiple of the data ranks by repeating the last pair), the scores are
all_gathered and the padding dropped, so every rank returns the statistics
of the unsharded run; rank 0 writes ``output_json``.  A reward that fails
on one rank fails the chunk on every rank (one all_reduce of a flag before
the gather), so all ranks score it item by item together.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from consolver_torch.device import resolve_device
from consolver_torch.dist.mesh import gather_batch, shard_batch
from consolver_torch.utils.image import read_image
from consolver_torch.utils.resize import lanczos_resize

IMAGE_EXTS = (".png", ".jpg", ".jpeg")


def pair_images(dir_a: str, dir_b: str) -> List[Tuple[str, str]]:
    """Pair files by relative path (compute_reward.py:52-78)."""
    rels = []
    for root, _, files in os.walk(dir_a):
        for f in files:
            if f.lower().endswith(IMAGE_EXTS):
                rels.append(os.path.relpath(os.path.join(root, f), dir_a))
    pairs = []
    for rel in sorted(rels):
        other = os.path.join(dir_b, rel)
        if os.path.exists(other):
            pairs.append((os.path.join(dir_a, rel), other))
    return pairs


def _load_image(path: str, size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """A PNG or JPEG file, whatever its name, as ``[H, W, 3]`` float32 in
    [0, 1]; ``size`` is (width, height)."""
    img = read_image(path)
    if size is not None:
        img = lanczos_resize(img, *size)
    return np.asarray(img, np.float32) / 255.0


def _score_batch(reward_fn, gen: np.ndarray, ref: np.ndarray, device, mesh=None) -> np.ndarray:
    n = gen.shape[0]
    if mesh is not None:
        pad = (-n) % mesh.dp
        gen, ref = (np.concatenate([x, np.repeat(x[-1:], pad, axis=0)]) for x in (gen, ref))
        gen, ref = shard_batch(mesh, (gen, ref))
    failed = None
    try:
        with torch.no_grad():
            rewards = reward_fn(torch.as_tensor(gen, device=device),
                                torch.as_tensor(ref, device=device)).float().reshape(-1)
    except Exception as e:  # noqa: BLE001  (re-raised below, after the ranks agree)
        failed = e
    if mesh is not None:
        # every rank learns of a failure on any rank before the gather, so
        # that all of them fall back together and the collectives stay matched
        flag = mesh.all_reduce(torch.tensor([float(failed is not None)], device=mesh.device))
        if failed is None and float(flag) > 0:
            failed = RuntimeError("the reward failed on another rank")
    if failed is not None:
        raise failed
    if mesh is not None:
        rewards = gather_batch(mesh, rewards)
    return rewards.cpu().numpy()[:n]


def evaluate_consistency(
    reward_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    dir_generated: str,
    dir_reference: str,
    batch_size: int = 32,
    size: Optional[Tuple[int, int]] = None,
    output_json: Optional[str] = None,
    mesh=None,
    device=None,
) -> Dict[str, float]:
    """Reward statistics over all paired images, in the reference's
    aggregate shape (compute_reward.py:332-365,447-463) with per-item
    ``errors`` (compute_reward.py:171-181).  ``reward_fn`` takes two image
    batches on ``device`` (None = the GPU; the mesh's device with ``mesh``)."""
    device = mesh.device if mesh is not None else resolve_device(device)
    pairs = pair_images(dir_generated, dir_reference)
    if not pairs:
        raise FileNotFoundError(f"No paired images between {dir_generated} and {dir_reference}")
    scores: List[float] = []
    error_records: List[Dict[str, str]] = []

    def record_error(path: str, exc: Exception):
        error_records.append({"path": os.path.relpath(path, dir_generated), "reason": repr(exc)})

    for start in range(0, len(pairs), batch_size):
        loaded = []  # (gen_path, gen_img, ref_img)
        for a, b in pairs[start:start + batch_size]:
            try:
                loaded.append((a, _load_image(a, size), _load_image(b, size)))
            except (OSError, ValueError) as e:  # unreadable or not a PNG
                record_error(a, e)
        if not loaded:
            continue
        try:
            gen = np.stack([g for _, g, _ in loaded])
            ref = np.stack([r for _, _, r in loaded])
            scores.extend(float(r) for r in _score_batch(reward_fn, gen, ref, device, mesh))
        except Exception:
            # mixed shapes or a model failure: score item by item, so one bad
            # pair does not discard the chunk
            for a, g, r in loaded:
                try:
                    scores.append(float(_score_batch(reward_fn, g[None], r[None], device,
                                                     mesh)[0]))
                except Exception as e:  # recorded per item, as the reference does
                    record_error(a, e)
    arr = np.asarray(scores)
    stats = {
        "num_pairs": len(pairs),
        "num_scored": len(scores),
        "num_errors": len(error_records),
        "errors": error_records,
        "mean": float(arr.mean()) if len(arr) else float("nan"),
        "std": float(arr.std()) if len(arr) else float("nan"),
        "min": float(arr.min()) if len(arr) else float("nan"),
        "max": float(arr.max()) if len(arr) else float("nan"),
        "median": float(np.median(arr)) if len(arr) else float("nan"),
    }
    if output_json and (mesh is None or mesh.is_primary):
        with open(output_json, "w") as f:
            json.dump(stats, f, indent=2)
    return stats
