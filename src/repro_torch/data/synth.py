"""Synthetic recsys id streams: a copy of ``repro.data.synth._zipf_ids``,
so both packages draw the same request streams from the same generator."""
from __future__ import annotations

from typing import Tuple

import numpy as np


def _zipf_ids(rng: np.random.Generator, vocab: int, shape: Tuple[int, ...],
              alpha: float = 1.05) -> np.ndarray:
    n = int(np.prod(shape))
    # bounded zipf via rejection-free inverse transform on a truncated tail
    u = rng.random(n)
    ids = np.floor(
        ((vocab ** (1 - alpha) - 1) * u + 1) ** (1 / (1 - alpha))) - 1
    ids = np.clip(ids.astype(np.int64), 0, vocab - 1)
    return rng.permutation(vocab)[ids].reshape(shape) if vocab <= 10_000_000 \
        else ids.reshape(shape)
