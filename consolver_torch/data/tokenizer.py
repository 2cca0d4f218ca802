"""Tokenizer wrappers.

Port of ``consolver_tpu/data/tokenizer.py``: a real tokenizer loads from a
LOCAL path via transformers when its files are present; a deterministic hash
tokenizer backs tests and smoke runs without vocab files.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Sequence, Union

import numpy as np


class HashTokenizer:
    """Deterministic hash-based stand-in for a CLIP/T5 tokenizer: maps words
    to stable ids so pipelines run without vocab files.  Id 0 is padding."""

    def __init__(self, vocab_size: int = 49408, max_length: int = 77,
                 bos_id: int = 1, eos_id: int = 2):
        self.vocab_size = vocab_size
        self.model_max_length = max_length
        self.bos_id = bos_id
        self.eos_id = eos_id

    def _word_id(self, word: str) -> int:
        h = int.from_bytes(hashlib.sha1(word.encode()).digest()[:4], "little")
        return 3 + h % (self.vocab_size - 3)

    def __call__(self, text: Union[str, Sequence[str]], max_length: Optional[int] = None,
                 **_) -> dict:
        if isinstance(text, str):
            text = [text]
        max_length = max_length or self.model_max_length
        ids = np.zeros((len(text), max_length), np.int64)
        for i, t in enumerate(text):
            toks = [self.bos_id] + [self._word_id(w) for w in t.split()][: max_length - 2]
            toks.append(self.eos_id)
            ids[i, : len(toks)] = toks
        return {"input_ids": ids}


def load_tokenizer(path_or_name: Optional[str], kind: str = "clip", max_length: int = 77):
    """A real tokenizer from a local path, else a :class:`HashTokenizer`."""
    if path_or_name is not None:
        try:
            from transformers import AutoTokenizer

            return AutoTokenizer.from_pretrained(path_or_name, local_files_only=True)
        except (ImportError, OSError, ValueError):
            pass
    vocab = 49408 if kind == "clip" else 32128
    return HashTokenizer(vocab_size=vocab, max_length=max_length)


def tokenize_batch(tokenizer, prompts: Sequence[str], max_length: int,
                   vocab_size: Optional[int] = None) -> np.ndarray:
    """``[len(prompts), max_length]`` int64 ids; ``vocab_size`` wraps ids
    into a smaller text encoder's embedding range."""
    if isinstance(tokenizer, HashTokenizer):
        out = tokenizer(prompts, max_length)
    else:
        out = tokenizer(
            list(prompts), padding="max_length", max_length=max_length,
            truncation=True, return_tensors="np",
        )
    ids = np.asarray(out["input_ids"], np.int64)
    if vocab_size is not None:
        ids = ids % vocab_size
    return ids


def uncond_input_ids(tokenizer, batch_size: int, max_length: int,
                     vocab_size: Optional[int] = None) -> np.ndarray:
    """The tokenized EMPTY prompt for the CFG negative branch, tiled to
    ``[batch_size, max_length]``.  Not zeros: a CLIP tokenizer maps ``""`` to
    ``[BOS, EOS, PAD, ...]`` and id 0 is an ordinary token."""
    row = tokenize_batch(tokenizer, [""], max_length, vocab_size)
    return np.tile(row, (batch_size, 1))
