"""Prompt sources for teacher generation and evaluation sweeps.

Port of ``consolver_tpu/data/prompts.py``: LAION-aesthetic parquet captions
(gen_pretrain/generate_data.py:53-59) through pandas, COCO caption
annotations (through :func:`consolver_torch.eval.gen_sweep.read_coco_captions`)
and plain text files, one prompt a line.
"""

from __future__ import annotations

import os
from typing import List, Optional

from consolver_torch.eval.gen_sweep import read_coco_captions


def read_parquet_prompts(
    path: str, column: Optional[str] = None, max_prompts: Optional[int] = None
) -> List[str]:
    """The caption column of a parquet file (LAION-style); tries the common
    column names when none is given."""
    import pandas as pd

    df = pd.read_parquet(path)
    if column is None:
        for cand in ("TEXT", "text", "caption", "prompt"):
            if cand in df.columns:
                column = cand
                break
        else:
            raise KeyError(f"No caption column in {path}; columns: {list(df.columns)}")
    prompts = [str(p) for p in df[column].dropna().tolist()]
    return prompts[:max_prompts] if max_prompts else prompts


def read_text_prompts(path: str, max_prompts: Optional[int] = None) -> List[str]:
    with open(path) as f:
        prompts = [line.strip() for line in f if line.strip()]
    return prompts[:max_prompts] if max_prompts else prompts


def read_prompts(path: str, max_prompts: Optional[int] = None) -> List[str]:
    """Dispatch by extension: .parquet | .json (COCO) | anything else = text."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".parquet":
        return read_parquet_prompts(path, max_prompts=max_prompts)
    if ext == ".json":
        return read_coco_captions(path, max_prompts)
    return read_text_prompts(path, max_prompts)
