"""Named spans of the serve path, on the profiler's clock.

``span(name)`` is a ``record_function`` range while ``torch.profiler``
records, and one shared no-op context otherwise (a check of the profiler's
flag, well under a microsecond).  The profiler collects the spans beside
the CUDA runtime calls and the kernels they launch, so a reduction of its
trace (``bench/spans.py``) attributes device time and idle gaps to them.

The serve path's spans, all named ``pifs.*``: ``ServeBinding.execute``
(``core/pifs.py``) holds ``pifs.execute`` around ``pifs.h2d`` (the batch's
copy to the device), ``pifs.step`` (the serve step) and ``pifs.sync``
(the wait for the card); ``DLRM.forward`` (``models/dlrm.py``) holds
``pifs.bottom_mlp``, ``pifs.front_end`` (lookup and interaction, either
route) and ``pifs.top_mlp``.
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
