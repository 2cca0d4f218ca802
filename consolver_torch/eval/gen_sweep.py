"""Generation sweep: batched image generation over prompts, saved as PNGs.

Port of ``consolver_tpu/eval/gen_sweep.py``.  Each batch gets its own
generator seeded from ``(seed, batch index)``, the analogue of the JAX
package's ``fold_in(key(seed), batch_idx)`` and of the reference's
``seed + batch_idx`` generators.
"""

from __future__ import annotations

import json
import os
import random
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from consolver_torch.device import resolve_device
from consolver_torch.utils.png import write_png


def _host(images) -> np.ndarray:
    if torch.is_tensor(images):
        return images.detach().float().cpu().numpy()
    return np.asarray(images)


def save_png(path: str, image01) -> None:
    """``[H, W, 3]`` in [0, 1] -> an 8-bit PNG, rounding ``x * 255 + 0.5``
    down after the clip."""
    arr = np.clip(_host(image01) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    write_png(path, arr)


def _batch_generator(device: torch.device, seed: int, batch_idx: int) -> torch.Generator:
    return torch.Generator(device).manual_seed(
        random.Random(f"{seed}-sweep-{batch_idx}").getrandbits(63))


def generate_sweep(
    generate_batch: Callable[[torch.Generator, Sequence[str]], object],
    prompts: Sequence[str],
    output_dir: str,
    batch_size: int = 8,
    seed: int = 0,
    device=None,
    mesh=None,
) -> List[str]:
    """Run ``generate_batch(generator, prompt_batch) -> images [B, H, W, 3]
    in [0, 1]`` over all prompts, saving ``{idx}.png`` + ``{idx}.txt`` pairs.
    The last batch is padded by repeating its last prompt.

    On a data-parallel ``mesh`` (:mod:`consolver_torch.dist.mesh`) every
    rank runs the sweep on its device and ``generate_batch`` shards each
    batch (and gathers the images); rank 0 writes the files.  The returned
    paths are the same on every rank."""
    device = mesh.device if mesh is not None else resolve_device(device)
    write = mesh is None or mesh.is_primary
    os.makedirs(output_dir, exist_ok=True)
    written = []
    for batch_idx in range(0, (len(prompts) + batch_size - 1) // batch_size):
        chunk = list(prompts[batch_idx * batch_size:(batch_idx + 1) * batch_size])
        if not chunk:
            break
        padded = chunk + [chunk[-1]] * (batch_size - len(chunk))
        images = _host(generate_batch(_batch_generator(device, seed, batch_idx), padded))
        for j, (img, prompt) in enumerate(zip(images[:len(chunk)], chunk)):
            idx = batch_idx * batch_size + j
            png = os.path.join(output_dir, f"{idx:06d}.png")
            if write:
                save_png(png, img)
                with open(os.path.join(output_dir, f"{idx:06d}.txt"), "w") as f:
                    f.write(prompt)
            written.append(png)
    if mesh is not None:
        mesh.barrier()
    return written


def read_coco_captions(json_file: str, max_captions: Optional[int] = None) -> List[str]:
    """The first caption of each image of a COCO captions annotation file."""
    with open(json_file) as f:
        data = json.load(f)
    by_image = {}
    for ann in data["annotations"]:
        by_image.setdefault(ann["image_id"], ann["caption"])
    caps = [by_image[i] for i in sorted(by_image)]
    return caps[:max_captions] if max_captions else caps
