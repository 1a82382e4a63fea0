"""Fixed-size micro-batcher and exact bucket padding.

A numpy copy of the fixed-batcher half of ``repro.serving.batcher``.
Padding is exact, not approximate:

  * pooling axis -- a bag with ``L_r < bucket.pooling`` entries repeats its
    first row id with SLS weight 0, so the padded lookup equals the
    unpadded one bit for bit;
  * batch axis -- missing rows replicate request 0 with all-zero weights;
    their scores are discarded.

So serve batches only ever carry weights of 0 or 1, which is what makes
the port's lookups bitwise equal to the reference (see ``ROADMAP.md``,
numerics contract).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.request import Request


@dataclasses.dataclass(frozen=True, order=True)
class Bucket:
    """One micro-batch signature: padded batch x padded pooling."""
    batch: int
    pooling: int


@dataclasses.dataclass(frozen=True)
class Flush:
    """Serve the first ``count`` queued requests, padded to ``bucket``."""
    bucket: Bucket
    count: int


@dataclasses.dataclass(frozen=True)
class Wait:
    """Idle until ``until`` (the loop wakes earlier on a new arrival)."""
    until: float


class FixedBatcher:
    """Always wait for a full fixed-size batch, flushing a partial one only
    once the stream has drained."""

    def __init__(self, batch: int, pooling: int):
        self.bucket = Bucket(batch, pooling)

    def decide(self, now: float, queued: Sequence[Request],
               next_arrival: Optional[float]):
        if not queued:
            return None
        if len(queued) >= self.bucket.batch:
            return Flush(self.bucket, self.bucket.batch)
        if next_arrival is not None:
            return Wait(next_arrival)
        return Flush(self.bucket, len(queued))  # end-of-stream drain


def pad_pooled_indices(reqs: Sequence[Request], bucket: Bucket,
                       key: str = "indices"
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Stack per-request ``(G, L_r)`` index bags into bucket-shaped
    ``indices (B, G, L)`` int32 + ``weights (B, G, L)`` float32."""
    B, L = bucket.batch, bucket.pooling
    if len(reqs) > B:
        raise ValueError(f"{len(reqs)} requests exceed bucket batch {B}")
    G = reqs[0].features[key].shape[0]
    idx = np.zeros((B, G, L), dtype=np.int32)
    w = np.zeros((B, G, L), dtype=np.float32)
    for i, r in enumerate(reqs):
        bags = np.asarray(r.features[key])
        if bags.shape[1] > L:
            raise ValueError(
                f"request pooling {bags.shape[1]} > bucket pooling {L}")
        lr = bags.shape[1]
        idx[i, :, :lr] = bags
        idx[i, :, lr:] = bags[:, :1]          # repeat first id, weight 0
        w[i, :, :lr] = 1.0
    for i in range(len(reqs), B):             # batch padding: replicate row 0
        idx[i] = idx[0]
    return idx, w


def stack_feature(reqs: Sequence[Request], bucket: Bucket, key: str,
                  dtype=None) -> np.ndarray:
    """Stack a fixed-shape per-request feature, replicating request 0 into
    padded batch rows."""
    first = np.asarray(reqs[0].features[key])
    out = np.empty((bucket.batch,) + first.shape, dtype=dtype or first.dtype)
    for i in range(bucket.batch):
        out[i] = np.asarray(reqs[i].features[key]) if i < len(reqs) else first
    return out
