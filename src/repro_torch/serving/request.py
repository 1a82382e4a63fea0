"""One inference query (the fields of ``repro.serving.request.Request`` that
the fixed-batcher serve loop reads).

A ``Request`` carries host-side per-example features (for DLRM:
``dense (n_dense,)`` and ``indices (T, L_r)`` global row ids), its arrival
and deadline on the serving clock, and its pooling (the bucket dimension).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass
class Request:
    """One inference query travelling through the serving loop."""
    rid: int
    arrival_s: float
    deadline_s: float                 # absolute: arrival + SLO budget
    features: Dict[str, np.ndarray]   # per-example host arrays (unbatched)
    pooling: int = 1                  # lookups per bag (bucket dimension)
