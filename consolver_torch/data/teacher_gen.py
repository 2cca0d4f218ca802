"""Teacher-trajectory data generation.

Port of ``consolver_tpu/data/teacher_gen.py``: a batched teacher solver over
prompts (SD) or prepared edit samples (FLUX), saving the ``.npz`` samples
that :class:`consolver_torch.data.group.TeacherDataset` and the trainers
read.  The initial noise of example ``i`` comes from a CPU generator seeded
from ``(seed, i)`` (:func:`example_noise`): the same on every device and for
every batch size.  The teacher's own generator is seeded from ``(seed,
batch start)``.
"""

from __future__ import annotations

import os
import random
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from consolver_torch.device import resolve_device
from consolver_torch.eval.gen_sweep import save_png


def example_noise(seed: int, index: int, shape: Sequence[int]) -> torch.Tensor:
    """The f32 initial noise of example ``index`` (on the CPU)."""
    gen = torch.Generator().manual_seed(random.Random(f"{seed}-noise-{index}").getrandbits(63))
    return torch.randn(tuple(shape), generator=gen)


def _teacher_generator(device: torch.device, seed: int, start: int) -> torch.Generator:
    return torch.Generator(device).manual_seed(
        random.Random(f"{seed}-teacher-{start}").getrandbits(63))


def _sanity_images(decode_fn, latents: torch.Tensor, written: int, limit: int):
    """The decoded images of a batch while fewer than ``limit`` samples are
    written, else None."""
    if decode_fn is None or written >= limit:
        return None
    with torch.no_grad():
        return decode_fn(latents).float().cpu().numpy()


def _save_sanity(output_dir: str, images, idx: int, j: int, limit: int):
    if images is not None and idx < limit:
        save_png(os.path.join(output_dir, f"sanity_{idx:03d}.png"), images[j])


def _batch_noise(seed: int, start: int, count: int, shape, device) -> torch.Tensor:
    return torch.stack([example_noise(seed, start + j, shape) for j in range(count)]).to(device)


def generate_teacher_set(
    denoise_fn: Callable[[torch.Generator, torch.Tensor, torch.Tensor], torch.Tensor],
    prompt_ids: np.ndarray,
    output_dir: str,
    noise_shape: Sequence[int],
    batch_size: int = 8,
    seed: int = 0,
    decode_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    save_sanity_images: int = 10,
    uncond_ids: Optional[np.ndarray] = None,
    device=None,
) -> int:
    """For each prompt: run the teacher ``denoise_fn(generator, noise,
    prompt_ids_batch) -> final latents`` and save ``{i:06d}.npz`` with
    (noise, latent, prompt_ids [, uncond_ids]).  NaN samples are dropped.
    Returns the number of samples written.

    ``uncond_ids`` is the tokenized empty prompt ``[S]`` (or ``[1, S]``) of
    the CFG negative branch; stored in every sample, so the trainer
    conditions that branch on the ids the teacher used."""
    device = resolve_device(device)
    os.makedirs(output_dir, exist_ok=True)
    if uncond_ids is not None:
        uncond_ids = np.asarray(uncond_ids).reshape(-1)
        width = np.asarray(prompt_ids).shape[-1]
        if uncond_ids.size != width:
            raise ValueError(
                f"uncond_ids must be one [S]={width} row (the tokenized "
                f"empty prompt), got {uncond_ids.size} values — pass "
                "uncond_input_ids(tokenizer, 1, max_length)"
            )
    written = 0
    for start in range(0, len(prompt_ids), batch_size):
        ids = np.asarray(prompt_ids[start : start + batch_size])
        noise = _batch_noise(seed, start, len(ids), noise_shape, device)
        with torch.no_grad():
            latents = denoise_fn(_teacher_generator(device, seed, start), noise,
                                 torch.as_tensor(ids, device=device))
        images = _sanity_images(decode_fn, latents, written, save_sanity_images)
        latents = latents.float().cpu().numpy()
        noise = noise.cpu().numpy()
        for j in range(len(ids)):
            if np.isnan(latents[j]).any():
                continue
            sample = dict(noise=noise[j], latent=latents[j], prompt_ids=ids[j])
            if uncond_ids is not None:
                sample["uncond_ids"] = uncond_ids
            np.savez(os.path.join(output_dir, f"{start + j:06d}.npz"), **sample)
            _save_sanity(output_dir, images, start + j, j, save_sanity_images)
            written += 1
    return written


def generate_edit_teacher_set(
    denoise_fn: Callable[..., torch.Tensor],
    tokenize: Callable[[Sequence[str]], tuple],
    prepared_dir: str,
    output_dir: str,
    noise_shape: Sequence[int],
    batch_size: int = 1,
    seed: int = 42,
    decode_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    save_sanity_images: int = 10,
    max_samples: Optional[int] = None,
    device=None,
) -> int:
    """FLUX edit teacher generation: for each prepared sample (``{i}.npz``
    with ``ref_image`` in [-1, 1] and ``instruction``), run the teacher
    ``denoise_fn(generator, noise, t5_ids, clip_ids, ref_image) -> final
    latents`` (unpacked ``[B, h, w, C]``) and save the sample the edit
    trainer reads: noise / latent / ref_image / t5_ids / clip_ids /
    instruction.  ``tokenize(instructions) -> (t5_ids, clip_ids)``.  NaN
    samples are dropped.  Returns the number of samples written."""
    device = resolve_device(device)
    os.makedirs(output_dir, exist_ok=True)
    files = sorted(f for f in os.listdir(prepared_dir) if f.endswith(".npz"))[:max_samples]
    if not files:
        raise FileNotFoundError(f"No prepared .npz samples under {prepared_dir}")
    written = 0
    for start in range(0, len(files), batch_size):
        chunk = files[start : start + batch_size]
        refs, instructions = [], []
        for f in chunk:
            with np.load(os.path.join(prepared_dir, f)) as z:
                refs.append(np.asarray(z["ref_image"], np.float32))
                instructions.append(str(z["instruction"]))
        t5_ids, clip_ids = (np.asarray(a) for a in tokenize(instructions))
        noise = _batch_noise(seed, start, len(chunk), noise_shape, device)
        with torch.no_grad():
            latents = denoise_fn(
                _teacher_generator(device, seed, start), noise,
                *(torch.as_tensor(a, device=device) for a in (t5_ids, clip_ids, np.stack(refs))))
        images = _sanity_images(decode_fn, latents, written, save_sanity_images)
        latents = latents.float().cpu().numpy()
        noise = noise.cpu().numpy()
        for j in range(len(chunk)):
            if np.isnan(latents[j]).any():
                continue
            np.savez(
                os.path.join(output_dir, f"{start + j:06d}.npz"),
                noise=noise[j],
                latent=latents[j],
                ref_image=refs[j],
                t5_ids=t5_ids[j],
                clip_ids=clip_ids[j],
                instruction=np.asarray(instructions[j]),
            )
            _save_sanity(output_dir, images, start + j, j, save_sanity_images)
            written += 1
    return written
