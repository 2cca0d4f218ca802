"""The one traffic generator: schedules, per-request seeds and inputs, all
from a workload file's parameters and ``--seed``.

Every seed gets the same set of gaps and sizes, in another order, so that
two seeds offer the same work and differ only in how it is arranged.
"""

from __future__ import annotations

import math
import random
from typing import List, Sequence

import numpy as np


def poisson_offsets(rate: float, seconds: float, base_seed: int, seed: int) -> List[float]:
    """Due offsets in ``[0, seconds)`` of an open loop at ``rate`` req/s.

    ``round(rate * seconds)`` exponential gaps are drawn once from
    ``base_seed`` (the cell's), scaled so that the whole schedule spans the
    window, and put in the order that ``seed`` draws.  The first request is
    due at 0."""
    n = max(1, round(rate * seconds))
    base = random.Random(int(base_seed))
    gaps = [base.expovariate(1.0) for _ in range(n)]
    scale = seconds / sum(gaps)
    gaps = [g * scale for g in gaps]
    random.Random(int(seed)).shuffle(gaps)
    offsets, t = [], 0.0
    for g in gaps:
        offsets.append(t)
        t += g
    return [o for o in offsets if o < seconds]


def request_seeds(seed: int, n: int) -> List[int]:
    """``n`` distinct per-request seeds below 2**31, drawn from ``seed``."""
    return random.Random(int(seed) ^ 0x5EED).sample(range(1, 2**31), n)


def cycle_permuted(items: Sequence, n: int, seed: int) -> list:
    """``n`` items: whole passes over ``items``, each pass in the order the
    seed draws."""
    rng = random.Random(int(seed) ^ 0xC0FFEE)
    out: list = []
    while len(out) < n:
        order = list(items)
        rng.shuffle(order)
        out.extend(order)
    return out[:n]


def sample_indices(seed: int, n: int, k: int) -> List[int]:
    """``k`` of ``range(n)`` drawn from the seed (all of them when k >= n)."""
    if k >= n:
        return list(range(n))
    return sorted(random.Random(int(seed) ^ 0xC4EC).sample(range(n), k))


def photo_like(width: int, height: int, seed: int) -> np.ndarray:
    """A ``[height, width, 3]`` uint8 image with the statistics of a photo:
    smooth colour fields at a few scales, hard-edged shapes, sensor noise."""
    rng = np.random.default_rng(int(seed))
    y = np.linspace(0.0, 1.0, height, dtype=np.float32)
    x = np.linspace(0.0, 1.0, width, dtype=np.float32)
    waves, colours = [], []
    for scale in (1.0, 3.0, 9.0, 27.0):
        for _ in range(3):
            fx, fy = (float(v) for v in rng.normal(0.0, scale, 2))
            phase = float(rng.uniform(0, 2 * math.pi))
            colours.append(rng.normal(0.0, 0.5 / scale ** 0.5, 3))
            # sin(a + b) = sin a cos b + cos a sin b: two outer products
            ax, by = 2 * math.pi * fx * x, 2 * math.pi * fy * y + phase
            waves.append(np.outer(np.cos(by), np.sin(ax)) + np.outer(np.sin(by), np.cos(ax)))
    img = np.tensordot(np.stack(waves), np.asarray(colours, np.float32), axes=(0, 0))
    for _ in range(6):  # hard-edged disks, each within its bounding box
        cx, cy, r = (float(v) for v in (rng.uniform(0, 1), rng.uniform(0, 1),
                                         rng.uniform(0.05, 0.3)))
        colour = rng.normal(0.0, 0.6, 3).astype(np.float32)
        ys = slice(int(max(cy - r, 0) * (height - 1)), int(min(cy + r, 1) * (height - 1)) + 1)
        xs = slice(int(max(cx - r, 0) * (width - 1)), int(min(cx + r, 1) * (width - 1)) + 1)
        disk = ((x[None, xs] - cx) ** 2 + (y[ys, None] - cy) ** 2) < r * r
        box = img[ys, xs]
        box[disk] = box[disk] * 0.3 + colour
    img = 0.5 + 0.35 * img / (np.abs(img).max() + 1e-6)
    img += 0.01 * rng.standard_normal(img.shape, dtype=np.float32)
    return np.clip(np.rint(img * 255.0), 0, 255).astype(np.uint8)


def sources(spec: dict, seed: int):
    """The cell's source images, one per listed size, made from the seed, as
    (uint8 arrays, base64 PNGs); None when the cell sends no images."""
    if "source_sizes" not in spec:
        return None
    import base64
    from concurrent.futures import ThreadPoolExecutor

    from perfbench.lib.png import write_png

    def one(k):
        w, h = spec["source_sizes"][k]
        im = photo_like(w, h, (int(seed) * 1000003 + k) % 2**63)
        return im, base64.b64encode(write_png(im)).decode("ascii")

    with ThreadPoolExecutor(max_workers=4) as pool:  # numpy and zlib let go of the lock
        made = list(pool.map(one, range(len(spec["source_sizes"]))))
    return [m[0] for m in made], [m[1] for m in made]


def requests_for(system, spec: dict, seed: int, n: int):
    """``n`` requests for the system: texts from the cell's list, a seed
    each, and a source image (by reference into the plan's ``images``)
    where the cell sends them.  Returns (plan requests, inputs)."""
    seeds = request_seeds(seed, n)
    texts = cycle_permuted(spec["texts"], n, seed)
    srcs = cycle_permuted(range(len(spec["source_sizes"])), n, seed + 1) \
        if "source_sizes" in spec else [None] * n
    requests, inputs = [], []
    for text, s, k in zip(texts, seeds, srcs):
        path, body = system.request(text, s, None if k is None else {"ref": k})
        requests.append({"path": path, "body": body})
        inputs.append({"text": text, "seed": s, "source": k})
    return requests, inputs
