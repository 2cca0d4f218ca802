"""EditScore / EditReward evaluation harness for the kontext-bench layout.

Port of ``consolver_tpu/eval/edit_scores.py`` (the reference's
edit_ppo/compute_score.py and compute_reward.py): one folder per example
holding ``ref_image.jpg``, ``instruction.txt`` and ``edited_image.jpg``,
scored by any ``scorer(ref_image01, instruction, edited_image01)`` callable
(``rewards.vlm.load_transformers_edit_scorer``, or a plain metric) and
aggregated into mean / std / counts.

As the JAX package does, :func:`write_example` writes PNG bytes under the
``.jpg`` names; :func:`score_results` reads each image by its content
(``utils/image.py``), so it reads those files and real JPEGs alike.  An
example whose images or scorer fail counts as an error, not a score.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional

import numpy as np

from consolver_torch.eval.consistency import _load_image
from consolver_torch.eval.gen_sweep import save_png

EXAMPLE_FILES = ("ref_image.jpg", "instruction.txt", "edited_image.jpg")


def write_example(out_dir: str, name: str, ref_image01: np.ndarray, instruction: str,
                  edited_image01: np.ndarray) -> str:
    """Write one folder-per-example result (the layout of
    edit_ppo/generate_ours.py that the scorers read)."""
    d = os.path.join(out_dir, name)
    os.makedirs(d, exist_ok=True)
    save_png(os.path.join(d, "ref_image.jpg"), ref_image01)
    with open(os.path.join(d, "instruction.txt"), "w") as f:
        f.write(instruction)
    save_png(os.path.join(d, "edited_image.jpg"), edited_image01)
    return d


def list_examples(results_dir: str) -> List[str]:
    """The example folders under ``results_dir`` that hold all three files."""
    out = []
    for name in sorted(os.listdir(results_dir)):
        d = os.path.join(results_dir, name)
        if os.path.isdir(d) and all(os.path.exists(os.path.join(d, f)) for f in EXAMPLE_FILES):
            out.append(d)
    return out


def score_results(
    results_dir: str,
    scorer: Callable[[np.ndarray, str, np.ndarray], float],
    output_json: Optional[str] = None,
) -> Dict[str, float]:
    """Score every example; the mean / std / count aggregates of
    compute_score.py:57-65."""
    dirs = list_examples(results_dir)
    if not dirs:
        raise FileNotFoundError(f"No scored examples under {results_dir}")
    scores, errors = [], 0
    for d in dirs:
        try:
            ref = _load_image(os.path.join(d, "ref_image.jpg"))
            edited = _load_image(os.path.join(d, "edited_image.jpg"))
            with open(os.path.join(d, "instruction.txt")) as f:
                instruction = f.read().strip()
            scores.append(float(scorer(ref, instruction, edited)))
        except Exception:  # noqa: BLE001  (an example that fails is counted, as in JAX)
            errors += 1
    arr = np.asarray(scores)
    stats = {
        "num_examples": len(dirs),
        "num_scored": len(scores),
        "num_errors": errors,
        "mean": float(arr.mean()) if len(arr) else float("nan"),
        "std": float(arr.std()) if len(arr) else float("nan"),
    }
    if output_json:
        with open(output_json, "w") as f:
            json.dump(stats, f, indent=2)
    return stats
