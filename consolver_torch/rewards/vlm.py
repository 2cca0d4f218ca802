"""VLM-judge rewards (llava / qwen_vl): host-side generative scoring.

Port of the host part of ``consolver_tpu/rewards/vlm.py`` (:17-88,
:203-234): the judge scores each (prediction, target) pair on four
similarity dimensions 0-100, retrying a failed parse up to 5 times with a
50.0 fallback; the edit scorer rates an edit 0-10.  A judge is a host
callable over numpy arrays and plugs into
``rewards.registry.RewardModel.vlm_judge``; the generation callable behind
it is the caller's (a local VLM service), or a ``load_transformers_*``
loader's, which builds it from a local transformers checkpoint.

The loaders import transformers inside their bodies (the GPU host need not
have it) and hand the processor uint8 numpy arrays where the JAX package
hands it PIL images, made as the JAX package makes them: by truncation,
``(clip(x, 0, 1) * 255).astype(uint8)``.  The qwen path resizes them to
224 x 224 with ``utils/resize.bilinear_resize`` (the imaging library's
``BILINEAR``, bit for bit), embeds them in the chat messages, applies the
chat template with ``tokenize=False`` and extracts the images through
``qwen_vl_utils.process_vision_info`` only when that package imports (as
PNG data URIs, since it reads no arrays).  Each
generation takes at most 5 new tokens.  ``device=None`` means the card.
"""

from __future__ import annotations

import base64
import re
from typing import Callable, List, Optional

import numpy as np

from consolver_torch.device import resolve_device
from consolver_torch.utils.png import encode_png
from consolver_torch.utils.resize import bilinear_resize

# The four judged similarity dimensions (reward_model.py:25-30).
SIMILARITY_DIMENSIONS = (
    "overall visual similarity",
    "structural similarity",
    "color similarity",
    "semantic content similarity",
)

_PROMPT = (
    "Evaluate the {dimension} between these two images on a scale from 0 to "
    "100, where 0 means completely dissimilar and 100 means identical. "
    "Provide only the numerical score."
)


def parse_score(text: str) -> Optional[float]:
    """First number in the generation, clamped to [0, 100]."""
    m = re.search(r"-?\d+(?:\.\d+)?", text)
    if m is None:
        return None
    return float(np.clip(float(m.group()), 0.0, 100.0))


def parse_score_strict(text: str) -> Optional[float]:
    """Qwen-path parse: ``float(generated_text)`` directly
    (edit_ppo/reward_model.py:303-305): any surrounding text is a parse
    failure (retried), unlike the llava path's first-number regex; "nan" and
    "inf" are failures too, since they would poison the reward mean."""
    try:
        value = float(text.strip())
    except ValueError:
        return None
    if not np.isfinite(value):
        return None
    return float(np.clip(value, 0.0, 100.0))


def make_vlm_judge(
    generate_fn: Callable[[np.ndarray, np.ndarray, str], str],
    max_retries: int = 5,
    fallback_score: float = 50.0,
    parse: Callable[[str], Optional[float]] = parse_score,
):
    """A ``RewardModel.vlm_judge`` from a raw generation callable
    ``generate_fn(pred_image [H,W,3] in [0,1], target_image, prompt) -> text``.
    Retry-with-fallback as reward_model.py:194-206,288-310; ``parse`` picks
    the llava (regex) or qwen (strict float) score extraction."""

    def judge(pred: np.ndarray, target: np.ndarray) -> np.ndarray:
        scores: List[float] = []
        for i in range(len(pred)):
            dim_scores = []
            for dimension in SIMILARITY_DIMENSIONS:
                prompt = _PROMPT.format(dimension=dimension)
                score = None
                for _ in range(max_retries):
                    try:
                        score = parse(generate_fn(pred[i], target[i], prompt))
                    except Exception:  # a failed generation is retried, as a failed parse
                        continue
                    if score is not None:
                        break
                dim_scores.append(score if score is not None else fallback_score)
            scores.append(float(np.mean(dim_scores)))
        return np.asarray(scores, np.float32)

    return judge


def _uint8(image01: np.ndarray) -> np.ndarray:
    """[0, 1] floats -> uint8 by truncation, as the JAX loaders feed PIL."""
    return (np.clip(image01, 0, 1) * 255).astype(np.uint8)


def _load_vlm(model_path: str, device):
    from transformers import AutoModelForImageTextToText, AutoProcessor

    processor = AutoProcessor.from_pretrained(model_path, local_files_only=True)
    model = AutoModelForImageTextToText.from_pretrained(model_path, local_files_only=True)
    return processor, model.to(device)


def _generate(processor, model, device, text: str, images, **kwargs) -> str:
    import torch

    inputs = processor(text=[text], images=images, return_tensors="pt", **kwargs).to(device)
    with torch.no_grad():
        out = model.generate(**inputs, max_new_tokens=5)
    gen = out[0][inputs["input_ids"].shape[1]:]
    return processor.batch_decode(gen[None], skip_special_tokens=True)[0].strip()


def load_transformers_generate_fn(model_path: str, device=None):
    """Two-image generation callable from a local transformers checkpoint
    (LLaVA-class image-text-to-text; reward_model.py:67-87)."""
    device = resolve_device(device)
    processor, model = _load_vlm(model_path, device)

    def generate_fn(pred: np.ndarray, target: np.ndarray, prompt: str) -> str:
        messages = [{"role": "user", "content": [
            {"type": "image"}, {"type": "image"}, {"type": "text", "text": prompt}]}]
        text = processor.apply_chat_template(messages, add_generation_prompt=True)
        return _generate(processor, model, device, text, [_uint8(x) for x in (pred, target)])

    return generate_fn


def load_transformers_judge(model_path: str, device=None):
    """The llava similarity judge from a local checkpoint
    (reward_model.py:164-214)."""
    return make_vlm_judge(load_transformers_generate_fn(model_path, device))


def load_transformers_qwen_generate_fn(model_path: str, device=None, resize: int = 224):
    """Qwen2.5-VL-style two-image generation callable
    (edit_ppo/reward_model.py:258-317): the images resized to
    ``resize`` x ``resize`` and embedded in the messages."""
    device = resolve_device(device)
    processor, model = _load_vlm(model_path, device)

    def generate_fn(pred: np.ndarray, target: np.ndarray, prompt: str) -> str:
        def messages(images):
            return [{"role": "user", "content": [
                {"type": "image", "image": images[0]}, {"type": "image", "image": images[1]},
                {"type": "text", "text": prompt}]}]

        imgs = [bilinear_resize(_uint8(x), resize, resize) for x in (pred, target)]
        text = processor.apply_chat_template(messages(imgs), tokenize=False,
                                             add_generation_prompt=True)
        try:
            from qwen_vl_utils import process_vision_info
        except ImportError:
            image_inputs = imgs
        else:
            # it reads an image object of the imaging library or a string
            # (path, URL, data URI), not an array: hand it lossless PNG data URIs
            uris = ["data:image/png;base64," + base64.b64encode(encode_png(x)).decode()
                    for x in imgs]
            image_inputs, _ = process_vision_info(messages(uris))
        return _generate(processor, model, device, text, image_inputs, padding=True)

    return generate_fn


def load_transformers_qwen_judge(model_path: str, device=None):
    """The qwen_vl similarity judge: the qwen messages, the 224 resize and
    the strict float parse (edit_ppo/reward_model.py:258-317)."""
    return make_vlm_judge(load_transformers_qwen_generate_fn(model_path, device),
                          parse=parse_score_strict)


# EditScore-style instruction-following prompt (the role of the external
# EditScore / EditReward scorers, edit_ppo/compute_score.py: 0-10 like the
# published EditScore column).
_EDIT_PROMPT = (
    "The first image is the original and the second is an edited version "
    'following the instruction: "{instruction}". Rate from 0 to 10 how well '
    "the edit fulfils the instruction while preserving everything else. "
    "Provide only the numerical score."
)


def make_edit_scorer(
    generate_fn: Callable[[np.ndarray, np.ndarray, str], str],
    max_retries: int = 5,
    fallback_score: float = 5.0,
):
    """``(ref_image01, instruction, edited_image01) -> 0-10`` score, with the
    judges' retry-with-fallback."""

    def scorer(ref: np.ndarray, instruction: str, edited: np.ndarray) -> float:
        prompt = _EDIT_PROMPT.format(instruction=instruction)
        for _ in range(max_retries):
            try:
                score = parse_score(generate_fn(ref, edited, prompt))
            except Exception:  # a failed generation is retried
                continue
            if score is not None:
                return float(np.clip(score, 0.0, 10.0))
        return fallback_score

    return scorer


def load_transformers_edit_scorer(model_path: str, device=None):
    """A local-checkpoint EditScore stand-in for
    ``eval.edit_scores.score_results``."""
    return make_edit_scorer(load_transformers_generate_fn(model_path, device))
