"""Input pipeline: background-thread prefetch + device placement (a port
of ``repro.data.pipeline``).

Host generators (``data/synth.py``, ``data/traces.py``) produce numpy
batches; :class:`Prefetcher` overlaps generation with the step through a
bounded queue on a daemon thread.  Where the reference ``device_put``s
each array with the step's input shardings, this takes a ``device``: a
CUDA device gets each array from pinned host memory with a non-blocking
copy (one card holds the whole batch).
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def _place(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def shard_batch(batch: Dict[str, np.ndarray], device: DeviceLike = None
                ) -> Dict[str, torch.Tensor]:
    """One-shot placement of a numpy batch on ``device`` (default: the
    card; raises without CUDA)."""
    dev = resolve_device(device)
    return {k: _place(v, dev) for k, v in batch.items()}


class Prefetcher:
    """Wrap an iterator of numpy batches (dicts); prefetch ``depth``
    batches on a daemon thread; with ``device``, place each on it
    (:func:`shard_batch`), else hand the numpy batches on.  An exception
    in the wrapped iterator is raised to the consumer after the batches
    before it (the reference's thread ends the stream silently)."""

    def __init__(self, it: Iterator[Any], depth: int = 2,
                 device: Optional[DeviceLike] = None):
        self._it = it
        self._dev = None if device is None else resolve_device(device)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._done = object()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _placed(self, batch):
        if self._dev is None:
            return batch
        return {k: _place(v, self._dev) for k, v in batch.items()}

    def _worker(self):
        try:
            for batch in self._it:
                self._q.put(self._placed(batch))
        except BaseException as e:          # handed to the consumer
            self._error = e
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            self._q.put(self._done)         # later calls stop too
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item
