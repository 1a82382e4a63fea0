"""Named spans of the serve path, on the profiler's clock.

``span(name)`` is a ``record_function`` range while ``torch.profiler``
records, and one shared no-op context otherwise (a check of the profiler's
flag, well under a microsecond).  The profiler collects the spans beside
the CUDA runtime calls and the kernels they launch, so a reduction of its
trace (``bench/spans.py``) attributes device time and idle gaps to them.

The serve path's spans, all named ``pifs.*``: ``ServeBinding.execute``
(``core/pifs.py``) holds ``pifs.execute`` around ``pifs.step`` (the serve
step) and ``pifs.sync`` (the wait for the card); ``DLRM.forward``
(``models/dlrm.py``) holds ``pifs.bottom_mlp``, ``pifs.front_end`` (lookup
and interaction, either route) and ``pifs.top_mlp``, and for DLRM-DCNv2
``pifs.cross`` (the low-rank cross layers) between the last two.  The
batch's copies
to the device open where the step first reads an entry
(``core/staging.py``): ``pifs.h2d`` for the step's first read (a DLRM's
``dense``, under ``pifs.bottom_mlp``) and ``pifs.h2d_late`` for each later
one (its ``indices`` and ``weights``, under ``pifs.front_end``).
"""
from __future__ import annotations

import contextlib

from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: the range ``name`` while a profiler records."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _OFF
