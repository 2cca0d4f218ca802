"""Group (GRPO-style) batch construction and the teacher dataset.

Port of ``consolver_tpu/data/group.py`` (numpy and ``random`` only, so the
picks are bit-equal to the JAX package's): the PPO group batch repeats ONE
randomly chosen sample over the group, so the group-relative advantage
normalizes over rollouts of the same prompt.
"""

from __future__ import annotations

import os
import random
import zipfile
from typing import Dict, List

import numpy as np


def repeat_random_sample(batch: Dict[str, np.ndarray], rng: random.Random) -> Dict[str, np.ndarray]:
    """Pick one sample and tile it across the batch dimension."""
    return repeat_random_sample_groups(batch, rng, 1)


def repeat_random_sample_groups(
    batch: Dict[str, np.ndarray], rng: random.Random, num_groups: int
) -> Dict[str, np.ndarray]:
    """Split the batch into ``num_groups`` contiguous chunks; within each,
    pick one sample and tile it over the chunk (one group per data shard,
    as the reference's per-rank groups)."""
    some = next(iter(batch.values()))
    batch_size = some.shape[0]
    if batch_size % num_groups:
        raise ValueError(
            f"batch size {batch_size} not divisible by num_groups {num_groups}"
        )
    group = batch_size // num_groups
    picks = [g * group + rng.randint(0, group - 1) for g in range(num_groups)]
    out = {}
    for k, v in batch.items():
        reps = (group,) + (1,) * (v.ndim - 1)
        out[k] = np.concatenate([np.tile(v[i : i + 1], reps) for i in picks])
    return out


class TeacherDataset:
    """Teacher-trajectory dataset: one ``.npz`` per sample with keys
    ``noise`` (initial latent noise), ``latent`` (the teacher's final
    latent), ``prompt_ids`` and optionally more.  A sample with a NaN (or
    one that fails to load) is replaced by another, a bounded number of
    times."""

    def __init__(self, root: str, max_resample: int = 100):
        self.root = root
        self.files: List[str] = sorted(f for f in os.listdir(root) if f.endswith(".npz"))
        if not self.files:
            raise FileNotFoundError(f"No .npz samples under {root}")
        self.max_resample = max_resample

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rng = random.Random(idx)
        for _ in range(self.max_resample):
            try:
                with np.load(os.path.join(self.root, self.files[idx])) as z:
                    sample = {k: np.asarray(z[k]) for k in z.files}
                if any(
                    np.isnan(v).any()
                    for v in sample.values()
                    if np.issubdtype(v.dtype, np.floating)
                ):
                    raise ValueError("NaN in sample")
                return sample
            except (OSError, EOFError, KeyError, ValueError, zipfile.BadZipFile):
                idx = rng.randint(0, len(self.files) - 1)
        raise RuntimeError(f"Too many corrupt samples under {self.root}")

    def batches(self, batch_size: int, seed: int = 0, shuffle: bool = False):
        """Yield stacked dict batches (the last partial batch is dropped)."""
        order = list(range(len(self)))
        rng = random.Random(seed)
        if shuffle:
            rng.shuffle(order)
        for start in range(0, len(order) - batch_size + 1, batch_size):
            items = [self[i] for i in order[start : start + batch_size]]
            yield {k: np.stack([it[k] for it in items]) for k in items[0].keys()}
