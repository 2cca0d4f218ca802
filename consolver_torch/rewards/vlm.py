"""VLM-judge rewards (llava / qwen_vl): host-side generative scoring.

Port of the host part of ``consolver_tpu/rewards/vlm.py`` (:17-88,
:203-234): the judge scores each (prediction, target) pair on four
similarity dimensions 0-100, retrying a failed parse up to 5 times with a
50.0 fallback; the edit scorer rates an edit 0-10.  A judge is a host
callable over numpy arrays and plugs into
``rewards.registry.RewardModel.vlm_judge``; the generation callable behind
it is the caller's (a local VLM service).  The JAX module's
``load_transformers_*`` loaders, which build that callable from a local
transformers checkpoint through PIL, are not ported (ROADMAP Queue A.16).
"""

from __future__ import annotations

import re
from typing import Callable, List, Optional

import numpy as np

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
