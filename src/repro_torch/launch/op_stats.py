"""Operation statistics of one step: matmul FLOPs and bytes, kernel calls
and peak memory -- the port's counterpart of ``repro.launch.hlo_stats``.

The reference lowers a step to HLO and parses the text: dot FLOPs, dot
operand bytes and collective wire bytes, with while bodies multiplied by
their trip counts.  Here the step runs (on real tensors, or on the fake
tensors of a dry-run) under :class:`OpStats`, a ``TorchDispatchMode`` that
sees every ATen operation after autograd (outside inference mode, after
the composite decompositions too: ``torch.matmul``, ``F.linear`` and
``einsum`` arrive as the ops they lower to).  It counts:

* the matmul family (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``,
  ``addmv``, ``dot``, and ``matmul`` / ``linear`` where inference mode
  leaves them whole): ``2 * numel(out) * k`` FLOPs by the first
  operand's dtype, and the two operands' and the output's bytes (a bias
  is not a dot operand, as in HLO);
* hand-written kernel calls, one event each on any route
  (``kernels/build.py: kernel_call``): a kernel is one opaque op, as a
  Pallas custom call is to ``hlo_stats``, so the dots of a plain version
  running inside one are not counted;
* memory: every storage that an op's output brings into being is an
  allocation, freed when the storage dies; the peak of the live sum is
  the step's peak above its arguments.  Storages the step was given
  (:meth:`OpStats.arguments`) or that existed before it are not counted.

One card has no collectives: ``collectives`` is ``{}``.  A
``FlopCounterMode`` costs more per op than this mode and is not used.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, Iterator, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import build

aten = torch.ops.aten
# op -> index of its first matrix operand (the second follows it).
# ``matmul`` and ``linear`` arrive undecomposed under inference mode.
DOTS = {aten.mm.default: 0, aten.addmm.default: 1, aten.bmm.default: 0,
        aten.baddbmm.default: 1, aten.mv.default: 0, aten.addmv.default: 1,
        aten.dot.default: 0, aten.vdot.default: 0, aten.matmul.default: 0,
        aten.linear.default: 0}


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tensors_of(tree: Any) -> Iterator[torch.Tensor]:
    """Every tensor of a nest of dicts, lists, tuples, dataclasses and
    modules."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensors_of(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensors_of(v)
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from tensors_of(getattr(tree, f.name))


def storage_bytes(tree: Any) -> int:
    """Bytes of the distinct storages under ``tree``."""
    seen: Dict[int, int] = {}
    for t in tensors_of(tree):
        st = t.untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


@dataclasses.dataclass
class OpSummary:
    """What :class:`OpStats` counted over one step."""
    flops_by_dtype: Dict[str, float]
    dot_bytes: float
    kernels: Dict[str, int]
    argument_bytes: int
    output_bytes: int
    peak_bytes: int          # the most the step held above its arguments
    n_ops: int
    dots: Dict[str, List[float]]   # signature -> [count, flops, bytes]
    collectives: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def flops(self) -> float:
        return float(sum(self.flops_by_dtype.values()))

    def combine(self, terms: List[Tuple[float, "OpSummary"]]
                ) -> "OpSummary":
        """``self + sum_i c_i * s_i`` in every count (the per-layer
        multiplier: a base trace plus a layer's difference times its
        count)."""
        def lin(get, ints=False):
            v = get(self) + sum(c * get(s) for c, s in terms)
            return int(round(v)) if ints else v

        def keyed(get, ints=False):
            keys = set(get(self)).union(*(get(s) for _, s in terms))
            out = {k: lin(lambda s: get(s).get(k, 0), ints)
                   for k in sorted(keys)}
            return {k: v for k, v in out.items() if v}
        dots = {}
        for k in set(self.dots).union(*(s.dots for _, s in terms)):
            row = [lin(lambda s: s.dots.get(k, [0, 0, 0])[i])
                   for i in range(3)]
            if row[0]:
                dots[k] = row
        return OpSummary(
            flops_by_dtype=keyed(lambda s: s.flops_by_dtype),
            dot_bytes=lin(lambda s: s.dot_bytes),
            kernels=keyed(lambda s: s.kernels, ints=True),
            argument_bytes=self.argument_bytes,
            output_bytes=lin(lambda s: s.output_bytes, ints=True),
            peak_bytes=lin(lambda s: s.peak_bytes, ints=True),
            n_ops=lin(lambda s: s.n_ops, ints=True), dots=dots)


class OpStats(TorchDispatchMode):
    """Count a step's matmuls, kernel calls and memory (module docstring).
    Enter it inside a ``FakeTensorMode`` for a dry-run, alone for a real
    run::

        with OpStats() as st:
            st.arguments(args)
            out = fn(*args)
        summary = st.summary(out)
    """

    def __init__(self):
        super().__init__()
        self.flops_by_dtype: Dict[str, float] = {}
        self.dot_bytes = 0.0
        self.dots: Dict[str, List[float]] = {}
        self.kernels: Dict[str, int] = {}
        self.n_ops = 0
        self.argument_bytes = 0
        self.live = 0
        self.peak = 0
        self._depth = 0                 # inside a kernel call
        self._known: Dict[int, bool] = {}   # storage id -> counted

    # -------------------------------------------------------------- events
    def kernel_enter(self, name: str) -> None:
        if self._depth == 0:
            self.kernels[name] = self.kernels.get(name, 0) + 1
        self._depth += 1

    def kernel_exit(self, name: str) -> None:
        self._depth -= 1

    def __enter__(self):
        build.SINKS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        build.SINKS.remove(self)
        return super().__exit__(*exc)

    # -------------------------------------------------------------- memory
    def _free(self, key: int, nbytes: int) -> None:
        self._known.pop(key, None)
        self.live -= nbytes

    def _see(self, t: torch.Tensor, counted: bool) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._known:
            return
        self._known[key] = counted
        if counted:
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, n)
        else:
            weakref.finalize(st, self._known.pop, key, None)

    def arguments(self, args: Any) -> int:
        """Register the step's arguments (never counted as allocations);
        returns their bytes (distinct storages)."""
        for t in tensors_of(args):
            st = t.untyped_storage()
            if id(st) not in self._known:
                self.argument_bytes += st.nbytes()
                self._see(t, counted=False)
        return self.argument_bytes

    # ------------------------------------------------------------ dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for a in args:
            if isinstance(a, torch.Tensor):
                self._see(a, counted=False)
        out = func(*args, **kwargs)
        self.n_ops += 1
        i = DOTS.get(func)
        if i is not None and self._depth == 0:
            a, b = args[i], args[i + 1]
            flops = 2.0 * out.numel() * a.shape[-1]
            nb = _nbytes(a) + _nbytes(b) + _nbytes(out)
            dt = _dtype(a)
            self.flops_by_dtype[dt] = self.flops_by_dtype.get(dt, 0.0) + flops
            self.dot_bytes += nb
            key = (f"{func.__name__.split('.')[0]} {dt} "
                   f"{tuple(a.shape)}x{tuple(b.shape)}")
            row = self.dots.setdefault(key, [0, 0.0, 0.0])
            row[0] += 1
            row[1] += flops
            row[2] += nb
        if isinstance(out, torch.Tensor):
            self._see(out, counted=True)
        elif isinstance(out, (list, tuple)):
            for o in out:
                if isinstance(o, torch.Tensor):
                    self._see(o, counted=True)
        return out

    def summary(self, out: Any = None) -> OpSummary:
        """The counts so far; ``out`` (the step's result) gives
        ``output_bytes``: its storages that the step allocated."""
        outs: Dict[int, int] = {}
        for t in tensors_of(out):
            st = t.untyped_storage()
            if self._known.get(id(st)):
                outs[id(st)] = st.nbytes()
        return OpSummary(
            flops_by_dtype=dict(sorted(self.flops_by_dtype.items())),
            dot_bytes=self.dot_bytes, kernels=dict(sorted(
                self.kernels.items())),
            argument_bytes=self.argument_bytes,
            output_bytes=sum(outs.values()), peak_bytes=self.peak,
            n_ops=self.n_ops, dots={k: list(v) for k, v in self.dots.items()})


def summarize(fn, *args, **kwargs) -> Tuple[OpSummary, Any]:
    """Run ``fn(*args, **kwargs)`` under :class:`OpStats` (inside the
    caller's ``FakeTensorMode``, if any): (summary, result)."""
    with OpStats() as st:
        st.arguments((args, kwargs))
        out = fn(*args, **kwargs)
    return st.summary(out), out


def top_dots(summary: OpSummary, k: int = 12) -> List[Tuple[float, str]]:
    """The k largest dot signatures by FLOPs: (flops, "op dtype shapes
    xcount")."""
    rows = [(v[1], f"{sig} x{int(v[0])}") for sig, v in summary.dots.items()]
    rows.sort(key=lambda t: -t[0])
    return rows[:k]
