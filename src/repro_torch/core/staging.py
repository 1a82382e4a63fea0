"""A serve batch that reaches the device entry by entry, when a step first
reads it (the seam of ``ServeBinding.execute``).

``BatchStager.batch(host)`` wraps a host batch (numpy arrays, as the
serving padder builds it) in a read-only :class:`StagedBatch`.  An entry is
copied to the device the first time the step reads it, so what a step
reads after it has queued work (DLRM's lookup inputs, read after the
bottom MLP is launched) is copied while that work runs.

On a CUDA device each (key, shape, dtype) owns a pinned host buffer and a
device buffer, made at the first batch of that signature and reused after.
A first read copies the array into the pinned buffer, issues the DMA on the
stager's copy stream, records the buffer's event there and makes the
reading stream wait on it.  The device buffer is never taken from the
caching allocator per call: a block freed earlier in the same step may
still be read by kernels queued on the compute stream, which a write from
the copy stream would race.  Two waits keep reuse safe: each batch's copy
stream waits for the work already queued on the compute stream (a step that
raised may have left kernels that read the device buffers), and a pinned
buffer is overwritten only after its last DMA finished.

A CUDA batch of fewer than ``PINNED_MIN_BYTES`` (a serving runtime's
bucket, a mid-sized bulk batch) is copied whole before the step,
pageable, into a plain dict, as one read: the overlap cannot repay the
pinned path's extra host copy and events there.  On the CPU a first read is
``torch.as_tensor``: no copy, no stream, the same order and counters.

Counters (:meth:`BatchStager.stats`): ``calls`` (batches), ``bytes``
(numpy bytes staged) and ``late_bytes`` (those staged after the batch's
first read, the share a step's own work can hide).  Under a profiler a
batch's first read is the span ``pifs.h2d`` and every later one
``pifs.h2d_late`` (``repro_torch.trace``).
"""
from __future__ import annotations

from collections.abc import ItemsView, Mapping, ValuesView

import numpy as np
import torch

from repro_torch.trace import span

# Against the up-front copy on an H100 (RMC1, RMC3-int8, RMC4, fused and
# split): up to 2.3 MB (4,096 items) the pinned path was 7-47 % slower; at
# 4.6 MB RMC4 was 7-13 % faster and RMC3-int8 13-15 % slower; at 9.2 MB
# RMC3-int8 and RMC4 were 18-28 % faster, RMC1 (a small bottom MLP) even.
PINNED_MIN_BYTES = 6 << 20


def _nbytes(host: Mapping) -> int:
    return sum(x.nbytes for x in host.values() if isinstance(x, np.ndarray))


class BatchStager:
    """Stages host batches onto ``device``; owns the buffers, the copy
    stream and the counters."""

    def __init__(self, device: torch.device):
        self.device = device
        self._buffers: dict = {}   # (key, shape, dtype): pinned, dev, event
        self._stream = None        # the copy stream, made at the first batch
        self.reset_stats()

    def reset_stats(self) -> None:
        self.calls = self.bytes = self.late_bytes = 0

    def stats(self) -> dict:
        return {"calls": self.calls, "bytes": self.bytes,
                "late_bytes": self.late_bytes}

    def batch(self, host: Mapping) -> Mapping:
        """``host`` as a :class:`StagedBatch`, nothing copied yet; on a
        CUDA device under ``PINNED_MIN_BYTES``, a dict of every entry
        copied now, pageable, as one read."""
        self.calls += 1
        if self.device.type == "cuda":
            nbytes = _nbytes(host)
            if nbytes < PINNED_MIN_BYTES:
                self.bytes += nbytes
                with span("pifs.h2d"):
                    return {k: torch.as_tensor(v, device=self.device)
                            for k, v in host.items()}
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        return StagedBatch(self, host)

    def stage(self, host: Mapping, keys, late: bool) -> dict:
        """The device tensors of ``host[k]`` for ``keys``, as one read."""
        with span("pifs.h2d_late" if late else "pifs.h2d"):
            out = {}
            for k in keys:
                x = host[k]
                if isinstance(x, np.ndarray):
                    self.bytes += x.nbytes
                    self.late_bytes += x.nbytes if late else 0
                    if self.device.type == "cuda":
                        out[k] = self._copy(k, x)
                        continue
                out[k] = torch.as_tensor(x, device=self.device)
            return out

    def _copy(self, key, x: np.ndarray) -> torch.Tensor:
        sig = (key, x.shape, x.dtype)
        buf = self._buffers.get(sig)
        if buf is None:
            # made outside the step's inference mode, so a later read from
            # a step without it may still write them
            with torch.inference_mode(False):
                src = torch.from_numpy(x)
                buf = self._buffers[sig] = (
                    torch.empty(x.shape, dtype=src.dtype, pin_memory=True),
                    torch.empty(x.shape, dtype=src.dtype, device=self.device),
                    torch.cuda.Event())
        pinned, dev, done = buf
        done.synchronize()               # the buffer's last DMA has read it
        pinned.copy_(torch.from_numpy(x))
        with torch.cuda.stream(self._stream):
            dev.copy_(pinned, non_blocking=True)
            done.record(self._stream)
        torch.cuda.current_stream(self.device).wait_event(done)
        return dev


class StagedBatch(Mapping):
    """A read-only mapping over a host batch whose entries are staged by
    their :class:`BatchStager` when first read; later reads return the same
    tensor.  ``in``, ``len``, ``keys`` and iteration copy nothing;
    ``items()`` and ``values()`` stage every entry not yet read, as one
    read."""

    def __init__(self, stager: BatchStager, host: Mapping):
        self._stager = stager
        self._host = host
        self._staged: dict = {}

    def _stage(self, keys) -> None:
        self._staged.update(self._stager.stage(self._host, keys,
                                               late=bool(self._staged)))

    def __getitem__(self, key):
        if key not in self._staged:
            if key not in self._host:
                raise KeyError(key)
            self._stage([key])
        return self._staged[key]

    def __contains__(self, key) -> bool:
        return key in self._host

    def __iter__(self):
        return iter(self._host)

    def __len__(self) -> int:
        return len(self._host)

    def _stage_rest(self) -> None:
        rest = [k for k in self._host if k not in self._staged]
        if rest:
            self._stage(rest)

    def items(self):
        self._stage_rest()
        return ItemsView(self)

    def values(self):
        self._stage_rest()
        return ValuesView(self)
