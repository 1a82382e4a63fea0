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

A large batch runs as a pipeline of sub-batches
(:meth:`BatchStager.pipeline`).  What a step reads late is still its own
batch's, and a batch whose lookup inputs outweigh its bottom MLP
(DLRM-DCNv2: 28 MB of ids and weights against a 0.22 ms MLP) leaves the
card idle while the host copies them.  A step whose every score depends
on its own item alone runs on slices of the batch instead, one after
another with no wait between them, so that the host copies and launches
sub-batch j+1 while the card runs sub-batch j.  :func:`sub_batches` picks
k from what the batch shows: as many slices as its numpy bytes hold
``SPLIT_MIN_BYTES``, at most ``SPLIT_MAX``, none under ``SPLIT_MIN_ITEMS``
items, and 1 where its arrays differ in length along axis 0 or a CUDA
batch takes the up-front copy.  The slices are numpy views along axis 0,
cut the same for every batch of one size (:func:`split_edges`), so a
warm-up on one batch makes every signature its sub-batches use.  On a
CUDA device sub-batch j runs on compute stream ``j % SPLIT_LANES`` of the
stager's, so that sub-batch j+1's lookup runs beside sub-batch j's GEMMs
and not after them.  The streams first wait for the work queued on the
current stream, and the current stream waits for them when the pipeline
is left, a step that raised included: what follows on it (the scores'
join, a state update) is ordered after every sub-batch's kernels.  At
k = 1 nothing of this happens.

Sub-batch j stages into slot j: its own pinned and device buffers, keyed
(slot, key, shape, dtype), so equal slices of one batch never share one.
The copy stream waits for the current stream once a batch, before the
first sub-batch's first copy.  That covers every kernel that may still
read any slot's device buffer: all were queued by an earlier batch, and
that batch's streams were joined to the current stream on its way out.
Within a batch slot j's buffers are written once, before sub-batch j's
step, the only step of the batch that reads them; so no sub-batch's copy
waits for another sub-batch's step, and a pinned buffer is still
overwritten only after its last DMA finished.

Counters (:meth:`BatchStager.stats`): ``calls`` (batches), ``bytes``
(numpy bytes staged), ``late_bytes`` (those staged after a (sub-)batch's
first read, the share a step's own work can hide), ``split_calls``
(batches run as more than one sub-batch) and ``sub_batches`` (the steps
those batches ran).  Under a profiler a (sub-)batch's first read is the
span ``pifs.h2d`` and every later one ``pifs.h2d_late``
(``repro_torch.trace``).
"""
from __future__ import annotations

import contextlib
from collections.abc import ItemsView, Mapping, ValuesView
from typing import List, Optional

import numpy as np
import torch

from repro_torch.trace import span

# Against the up-front copy on an H100 (RMC1, RMC3-int8, RMC4, fused and
# split): up to 2.3 MB (4,096 items) the pinned path was 7-47 % slower; at
# 4.6 MB RMC4 was 7-13 % faster and RMC3-int8 13-15 % slower; at 9.2 MB
# RMC3-int8 and RMC4 were 18-28 % faster, RMC1 (a small bottom MLP) even.
PINNED_MIN_BYTES = 6 << 20
# The sub-batch pipeline, on an H100 at 700 W.  DLRM-DCNv2's batch of
# 16,384 items (28.9 MB) on one stream at k = 1 / 2 / 3 / 4 / 6 / 8 ran
# 942,588 / 983,528 / 913,713 / 938,284 / 881,381 / 845,901 items/s: at
# k = 2 half the ids' host copy hides behind the first half's work; each
# further sub-batch adds ~2.4 ms of launches on the host, and GEMMs of
# M <= 5,462 fill fewer waves of the card.  With two compute streams k = 2
# ran 989,491 against 972,682 on one and 919,996 whole (k = 3 956,715,
# k = 4 968,507).  RMC3-int8 and RMC4 at 9.2 MB lost at k = 2 (5.52 M to
# 4.63 M, 3.32 M to 3.25 M items/s).  Sub-batches of at least 12 MiB give
# DLRM-DCNv2 k = 2 and keep every RMC batch whole.
SPLIT_MIN_BYTES = 12 << 20
SPLIT_MAX = 4
SPLIT_MIN_ITEMS = 2048
SPLIT_LANES = 2


def _nbytes(host: Mapping) -> int:
    return sum(x.nbytes for x in host.values() if isinstance(x, np.ndarray))


def _items(host: Mapping) -> Optional[int]:
    """The length along axis 0 that every entry of ``host`` shares, if
    every entry is a numpy array with one; else None."""
    lengths = {x.shape[0] if isinstance(x, np.ndarray) and x.ndim else None
               for x in host.values()}
    return lengths.pop() if len(lengths) == 1 else None


def sub_batches(host: Mapping) -> int:
    """How many sub-batches a host batch runs as: as many as its bytes
    hold ``SPLIT_MIN_BYTES``, at most ``SPLIT_MAX``, each of at least
    ``SPLIT_MIN_ITEMS`` items; 1 where its entries do not share a length
    along axis 0."""
    n = _items(host)
    if n is None:
        return 1
    return max(1, min(SPLIT_MAX, _nbytes(host) // SPLIT_MIN_BYTES,
                      n // SPLIT_MIN_ITEMS))


def split_edges(n: int, k: int) -> List[int]:
    """Where ``k`` sub-batches of ``n`` items start, and ``n``:
    sub-batch j holds items ``edges[j]`` to ``edges[j + 1]``."""
    return [n * j // k for j in range(k + 1)]


class BatchStager:
    """Stages host batches onto ``device``; owns the buffers, the copy
    stream and the counters."""

    def __init__(self, device: torch.device):
        self.device = device
        # (slot, key, shape, dtype): pinned buffer, device buffer, event
        self._buffers: dict = {}
        self._stream = None        # the copy stream, made at the first batch
        self._lanes: list = []     # compute streams of split batches
        self.reset_stats()

    def reset_stats(self) -> None:
        self.calls = self.bytes = self.late_bytes = 0
        self.split_calls = self.sub_batches = 0

    def stats(self) -> dict:
        return {"calls": self.calls, "bytes": self.bytes,
                "late_bytes": self.late_bytes,
                "split_calls": self.split_calls,
                "sub_batches": self.sub_batches}

    def _pinned(self, host: Mapping) -> bool:
        """Whether ``host`` is staged entry by entry at first read (on the
        CPU always, as the pinned path's stand-in)."""
        return (self.device.type != "cuda"
                or _nbytes(host) >= PINNED_MIN_BYTES)

    def _start(self) -> None:
        """A batch on the pinned path begins: counted, and on a CUDA device
        the copy stream made to wait for the work queued so far."""
        self.calls += 1
        if self.device.type == "cuda":
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            self._stream.wait_stream(torch.cuda.current_stream(self.device))

    def batch(self, host: Mapping) -> Mapping:
        """``host`` as a :class:`StagedBatch`, nothing copied yet; on a
        CUDA device under ``PINNED_MIN_BYTES``, a dict of every entry
        copied now, pageable, as one read."""
        if not self._pinned(host):
            self.calls += 1
            self.bytes += _nbytes(host)
            with span("pifs.h2d"):
                return {k: torch.as_tensor(v, device=self.device)
                        for k, v in host.items()}
        self._start()
        return StagedBatch(self, host)

    def batches(self, host: Mapping) -> List[Mapping]:
        """The mappings a step runs on for ``host``, in item order:
        ``[batch(host)]``, or on the pinned path the
        :func:`sub_batches` slices of ``host`` along axis 0, each a
        :class:`StagedBatch` of its own slot, nothing copied yet."""
        k = sub_batches(host) if self._pinned(host) else 1
        if k == 1:
            return [self.batch(host)]
        self._start()
        self.split_calls += 1
        self.sub_batches += k
        edges = split_edges(_items(host), k)
        return [StagedBatch(self, {key: x[a:b] for key, x in host.items()},
                            slot=j)
                for j, (a, b) in enumerate(zip(edges[:-1], edges[1:]))]

    @contextlib.contextmanager
    def pipeline(self, host: Mapping):
        """:meth:`batches` of ``host``, each beside the context its step
        runs in.  On a CUDA device a split batch's sub-batch j runs on
        compute stream ``j % SPLIT_LANES`` of the stager's, so one
        sub-batch's lookup can run beside the previous one's GEMMs; the
        streams wait for the work queued before the batch, and on leaving
        (a step that raised too) the current stream waits for them."""
        subs = self.batches(host)
        if len(subs) == 1 or self.device.type != "cuda":
            yield [(sub, contextlib.nullcontext()) for sub in subs]
            return
        cur = torch.cuda.current_stream(self.device)
        while len(self._lanes) < SPLIT_LANES:
            self._lanes.append(torch.cuda.Stream(self.device))
        for lane in self._lanes:
            lane.wait_stream(cur)
        try:
            yield [(sub, torch.cuda.stream(self._lanes[j % SPLIT_LANES]))
                   for j, sub in enumerate(subs)]
        finally:
            for lane in self._lanes:
                cur.wait_stream(lane)

    def join(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """The sub-batches' scores as one tensor, made on the current
        stream (after :meth:`pipeline`)."""
        if len(parts) == 1:
            return parts[0]
        if self.device.type == "cuda":
            cur = torch.cuda.current_stream(self.device)
            for x in parts:
                x.record_stream(cur)
        return torch.cat(parts)

    def stage(self, host: Mapping, keys, late: bool, slot: int = 0) -> dict:
        """The device tensors of ``host[k]`` for ``keys``, as one read,
        through ``slot``'s buffers."""
        with span("pifs.h2d_late" if late else "pifs.h2d"):
            out = {}
            for k in keys:
                x = host[k]
                if isinstance(x, np.ndarray):
                    self.bytes += x.nbytes
                    self.late_bytes += x.nbytes if late else 0
                    if self.device.type == "cuda":
                        out[k] = self._copy(slot, k, x)
                        continue
                out[k] = torch.as_tensor(x, device=self.device)
            return out

    def _copy(self, slot: int, key, x: np.ndarray) -> torch.Tensor:
        sig = (slot, key, x.shape, x.dtype)
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
    their :class:`BatchStager` when first read, through the buffers of
    ``slot``; later reads return the same tensor.  ``in``, ``len``,
    ``keys`` and iteration copy nothing; ``items()`` and ``values()`` stage
    every entry not yet read, as one read."""

    def __init__(self, stager: BatchStager, host: Mapping, slot: int = 0):
        self._stager = stager
        self._host = host
        self._slot = slot
        self._staged: dict = {}

    def _stage(self, keys) -> None:
        self._staged.update(self._stager.stage(
            self._host, keys, late=bool(self._staged), slot=self._slot))

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
