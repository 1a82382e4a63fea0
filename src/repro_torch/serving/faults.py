"""Serving-side fault injection: deterministic chaos for the serving loop
(a port of ``repro.serving.faults``).

``FaultInjectingExecutor`` wraps an executor (``BindingExecutor`` or
``SimulatedExecutor``) and injects the reference's fault classes, each
driven by its own ``runtime.fault_tolerance.FailureInjector`` (scheduled
attempts plus seeded-hash chaos, reproducible across runs):

  * **straggler** -- the batch's service time times ``straggler_factor``;
    the batch still succeeds.
  * **transient** -- ``run_batch`` raises :class:`TransientServingFailure`;
    ``transient_runs`` > 1 makes it persist across that many attempts.
  * **stall** -- maintenance (``observe`` / ``replan``) takes ``stall_s``
    more seconds.
  * **shard_loss** -- a shard's device is gone: once fired, every attempt
    through the cross-shard datapath raises :class:`ShardLossFailure`
    (carrying the shard) until the runtime re-meshes onto the survivors
    and calls :meth:`FaultInjectingExecutor.on_remesh`.
  * **corruption** -- ids pushed out of range (``corrupt_oob``; the
    lookup would serve a clamped row, ``validate_ids`` catches it) or
    dense rows set to NaN (``corrupt_nan``; the score scrub catches the
    fallout), on a copy of the batch, so a retry sees the original data.
  * **bit_flip** -- silent store corruption: seeded bit flips in live page
    content (:func:`flip_store_bits`), finite wrong values only the
    checksum ledger and scrub (``core/integrity.py``,
    ``serving/scrub.py``) can see.

Every ``run_batch`` attempt advances the fault step, so a retried batch
rolls again.  :func:`corrupt_store` and :func:`flip_store_bits` draw from
the reference's numpy generators and touch the reference's elements, but
change them in place on the engine's device: only the touched elements
cross to the host, never a tier (RMC4's fp32 tiers are 5.8 GB).

The port's ``BindingExecutor`` is also the runtime's padder (it keeps
scores by request id), so the wrapper forwards ``pad`` and ``scores``
where the wrapped executor has them.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.paging import HOT_SHARD, host
from repro_torch.runtime.fault_tolerance import (FailureInjector,
                                                 SimulatedFailure)


class TransientServingFailure(SimulatedFailure):
    """A retryable serving-path failure (transient device/RPC error)."""


class ShardLossFailure(TransientServingFailure):
    """A tp shard's device is gone.  Unlike a transient, it persists until
    the dead shard leaves the mesh (an elastic re-mesh); ``shard`` lets
    the degradation controller attribute consecutive failures to one shard
    and escalate to the ``remesh`` recovery."""

    def __init__(self, msg: str, shard: int):
        super().__init__(msg)
        self.shard = int(shard)


# distinct per-class seed salts: one FaultConfig.seed gives independent
# (each reproducible) schedules per fault class
_SALTS = {"straggler": 0x57A6, "transient": 0x7EA4, "stall": 0x57A1,
          "corrupt_oob": 0x00B0, "corrupt_nan": 0x0A17,
          "shard_loss": 0x10AD, "bit_flip": 0xB17F}


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Per-class fire schedules: explicit steps and/or chaos probability.

    ``*_at`` steps index ``run_batch`` *attempts* (straggler, transient,
    corruption, shard loss, bit flip) or maintenance calls (stall), from
    0; install the wrapper after warmup so warmup stays fault-free.
    ``shard_loss_shard`` -1 kills the highest shard of the bound engine;
    each bit-flip firing flips ``bit_flip_rows`` rows of
    ``bit_flip_tier`` ('hot', 'cold' or 'both')."""
    seed: int = 0
    straggler_prob: float = 0.0
    straggler_at: Tuple[int, ...] = ()
    straggler_factor: float = 8.0
    transient_prob: float = 0.0
    transient_at: Tuple[int, ...] = ()
    transient_runs: int = 1          # consecutive failing attempts per firing
    stall_prob: float = 0.0
    stall_at: Tuple[int, ...] = ()
    stall_s: float = 0.25
    corrupt_oob_prob: float = 0.0
    corrupt_oob_at: Tuple[int, ...] = ()
    corrupt_nan_prob: float = 0.0
    corrupt_nan_at: Tuple[int, ...] = ()
    shard_loss_prob: float = 0.0
    shard_loss_at: Tuple[int, ...] = ()
    shard_loss_shard: int = -1
    bit_flip_prob: float = 0.0
    bit_flip_at: Tuple[int, ...] = ()
    bit_flip_rows: int = 2
    bit_flip_tier: str = "both"

    def injectors(self) -> Dict[str, FailureInjector]:
        def inj(name: str, prob: float, at: Tuple[int, ...]):
            return FailureInjector(fail_at_steps=tuple(at), fail_prob=prob,
                                   seed=hash((self.seed, _SALTS[name])))
        return {
            "straggler": inj("straggler", self.straggler_prob,
                             self.straggler_at),
            "transient": inj("transient", self.transient_prob,
                             self.transient_at),
            "stall": inj("stall", self.stall_prob, self.stall_at),
            "corrupt_oob": inj("corrupt_oob", self.corrupt_oob_prob,
                               self.corrupt_oob_at),
            "corrupt_nan": inj("corrupt_nan", self.corrupt_nan_prob,
                               self.corrupt_nan_at),
            "shard_loss": inj("shard_loss", self.shard_loss_prob,
                              self.shard_loss_at),
            "bit_flip": inj("bit_flip", self.bit_flip_prob,
                            self.bit_flip_at),
        }


class FaultInjectingExecutor:
    """Wraps an executor, injecting the :class:`FaultConfig` classes.

    Duck-types the executor protocol (``run_batch`` / ``observe`` /
    ``replan``, and ``pad`` / ``scores`` / ``binding`` where the wrapped
    executor has them), so the runtime cannot tell it from the real one.
    ``fired`` counts injections per class; ``corrupted_batches`` the
    attempt steps that carried poisoned data; ``bit_flip_events`` the
    pages each bit-flip firing touched."""

    def __init__(self, inner, cfg: FaultConfig,
                 idx_key: Optional[str] = "indices",
                 dense_key: Optional[str] = "dense",
                 oob_id: int = 2 ** 31 - 2):
        self.inner = inner
        self.cfg = cfg
        self.idx_key = idx_key
        self.dense_key = dense_key
        self.oob_id = oob_id
        self._inj = cfg.injectors()
        self._step = 0           # run_batch attempts
        self._mstep = 0          # maintenance calls (observe + replan)
        self._transient_left = 0
        self.lost_shard: Optional[int] = None   # armed by shard_loss
        self.fired: Dict[str, int] = {k: 0 for k in self._inj}
        self.corrupted_batches: list = []
        self.bit_flip_events: list = []   # [{step, pages}] per firing

    # ---------------------------------------- the wrapped executor's seams
    @property
    def pad(self):
        """The wrapped executor's padder (AttributeError where it has
        none, so the runtime asks for a padder of its own)."""
        return self.inner.pad

    @property
    def scores(self):
        return self.inner.scores

    @property
    def binding(self):
        return getattr(self.inner, "binding", None)

    # ------------------------------------------------------------- helpers
    def _fire(self, name: str, step: int) -> bool:
        if self._inj[name].fires(step):
            self.fired[name] += 1
            return True
        return False

    def _corrupt(self, step: int, batch: dict) -> dict:
        """A (possibly) corrupted shallow copy; never the caller's arrays:
        a retry must see the original data."""
        oob = (self.idx_key and self.idx_key in batch
               and self._fire("corrupt_oob", step))
        nan = (self.dense_key and self.dense_key in batch
               and self._fire("corrupt_nan", step))
        if not (oob or nan):
            return batch
        rng = np.random.default_rng([self.cfg.seed & 0x7FFFFFFF, step])
        batch = copy.copy(batch)       # keeps a PaddedBatch's request ids
        if oob:
            idx = np.array(batch[self.idx_key], copy=True)
            flat = idx.reshape(-1)
            k = max(1, flat.size // 64)
            pos = rng.choice(flat.size, size=k, replace=False)
            flat[pos] = self.oob_id
            batch[self.idx_key] = idx
        if nan:
            dense = np.array(batch[self.dense_key], copy=True,
                             dtype=np.float32)
            rows = rng.choice(dense.shape[0],
                              size=max(1, dense.shape[0] // 8),
                              replace=False)
            dense[rows] = np.nan
            batch[self.dense_key] = dense
        self.corrupted_batches.append(step)
        return batch

    def _resolve_lost_shard(self) -> int:
        """The configured shard, else the bound engine's highest shard,
        else 0."""
        if self.cfg.shard_loss_shard >= 0:
            return self.cfg.shard_loss_shard
        binding = self.binding
        if binding is not None:
            return max(0, int(binding.engine.cfg.n_shards) - 1)
        return 0

    def on_remesh(self, event=None) -> None:
        """The dead shard left the mesh: the persistent failure clears."""
        self.lost_shard = None

    # ------------------------------------------------ executor protocol
    def run_batch(self, bucket, batch) -> float:
        step = self._step
        self._step += 1
        if self.lost_shard is None and self._inj["shard_loss"].fires(step):
            self.lost_shard = self._resolve_lost_shard()
        if self.lost_shard is not None:
            # persistent until on_remesh(): every attempt that crosses
            # shards dies; the hot-only and shed rungs read the hot tier
            # only, so a dead cold shard is invisible to them
            rung = getattr(self.binding, "active", None)
            if rung not in ("hot_only", "shed"):
                self.fired["shard_loss"] += 1
                raise ShardLossFailure(
                    f"injected shard loss: tp shard {self.lost_shard} "
                    f"dead at attempt {step}", shard=self.lost_shard)
        if self._transient_left > 0:
            self._transient_left -= 1
            self.fired["transient"] += 1
            raise TransientServingFailure(
                f"injected transient failure (burst) at attempt {step}")
        if self._fire("transient", step):
            self._transient_left = self.cfg.transient_runs - 1
            raise TransientServingFailure(
                f"injected transient failure at attempt {step}")
        if self._fire("bit_flip", step):
            # silent store corruption before this attempt serves: the
            # batch succeeds with finite wrong scores
            binding = self.binding
            if binding is not None:
                pages = flip_store_bits(
                    binding, n_rows=self.cfg.bit_flip_rows,
                    seed=hash((self.cfg.seed, _SALTS["bit_flip"], step))
                    & 0x7FFFFFFF,
                    tier=self.cfg.bit_flip_tier)
                self.bit_flip_events.append(
                    {"step": step, "pages": [int(p) for p in pages]})
        batch = self._corrupt(step, batch)
        svc = self.inner.run_batch(bucket, batch)
        if self._fire("straggler", step):
            svc *= self.cfg.straggler_factor
        return svc

    def observe(self, batch) -> float:
        dt = self.inner.observe(batch)
        step = self._mstep
        self._mstep += 1
        if self._fire("stall", step):
            dt += self.cfg.stall_s
        return dt

    def replan(self) -> float:
        dt = self.inner.replan()
        step = self._mstep
        self._mstep += 1
        if self._fire("stall", step):
            dt += self.cfg.stall_s
        return dt

    def report(self) -> Dict[str, int]:
        return dict(self.fired)


def _flip_bits(tier: torch.Tensor, rows, cols, masks) -> None:
    """XOR ``masks`` into the bit patterns of ``tier[rows, cols]`` in place
    (unique positions; float32 through an int32 view, int8 codes through a
    uint8 view)."""
    view = tier.view(torch.uint8 if tier.dtype == torch.int8 else torch.int32)
    dev = tier.device
    r = torch.as_tensor(np.asarray(rows, np.int64), device=dev)
    c = torch.as_tensor(np.asarray(cols, np.int64), device=dev)
    m = torch.as_tensor(np.asarray(masks).astype(
        np.uint8 if tier.dtype == torch.int8 else np.int32), device=dev)
    view[r, c] = view[r, c] ^ m


def corrupt_store(binding, frac: float = 0.25, seed: int = 0,
                  mode: str = "nan") -> int:
    """Corrupt a fraction of the binding's hot tier in place (the stand-in
    for a corrupted fabric-attached memory page).  Returns the number of
    poisoned rows.

    ``mode='nan'``: rows become NaN -- lookups hitting them give
    non-finite scores, which ``scrub_scores`` catches (only
    ``binding.restore()`` heals).  ``mode='finite'``: one mantissa bit of
    each chosen row flips -- finite wrong values the score scrub cannot
    see; only a checksum audit (``core/integrity.py``) can.  The
    reference's draws, on the device: only the chosen elements move."""
    hot = binding.state.hot
    n_rows, dim = hot.shape
    n = max(1, int(n_rows * frac))
    rng = np.random.default_rng(seed)
    rows = rng.choice(n_rows, size=n, replace=False)
    if mode == "nan":
        hot[torch.as_tensor(rows, device=hot.device)] = float("nan")
    elif mode == "finite":
        cols = rng.integers(0, dim, size=n)
        bits = (np.uint32(1) << rng.integers(0, 23, size=n,
                                             dtype=np.uint32))
        _flip_bits(hot, rows, cols, bits.view(np.int32))
    else:
        raise ValueError(f"unknown corrupt_store mode {mode!r} "
                         "(expected 'nan' or 'finite')")
    return n


def flip_store_bits(binding, n_rows: int = 2, seed: int = 0,
                    tier: str = "both") -> list:
    """Flip one bit in each of ``n_rows`` live store rows -- seeded,
    always finite (fp32 flips stay in the mantissa; an int8 code flip is
    a code).  Returns the sorted global page ids touched (what a scrub
    sweep must detect).

    ``tier`` picks victim pages: 'hot' (the fp32 tier), 'cold' (the
    sharded fp32-or-int8 tier) or 'both'.  The flip lands in the page's
    native-domain content, the bytes its checksum covers.  The reference's
    draws, in its order; the flips are folded per element (XOR is
    associative) and applied on the device, one gather and one scatter
    per tier."""
    eng = binding.engine
    cfg = eng.cfg
    ps = cfg.page_size
    rng = np.random.default_rng(seed)
    p2s = host(binding.state.page_to_shard)
    p2slot = host(binding.state.page_to_slot)
    hot_pages = np.nonzero(p2s == HOT_SHARD)[0]
    cold_pages = np.nonzero(p2s != HOT_SHARD)[0]
    if tier == "hot":
        candidates = hot_pages
    elif tier == "cold":
        candidates = cold_pages
    elif tier == "both":
        candidates = np.concatenate([hot_pages, cold_pages])
    else:
        raise ValueError(f"unknown tier {tier!r} "
                         "(expected 'hot', 'cold', or 'both')")
    if candidates.size == 0:
        raise ValueError(f"no pages resident in tier {tier!r} to corrupt")
    int8 = binding.state.cold.dtype == torch.int8
    masks = {"hot": {}, "cold": {}}
    touched = set()
    for _ in range(int(n_rows)):
        page = int(rng.choice(candidates))
        off = int(rng.integers(0, ps))
        col = int(rng.integers(0, cfg.dim))
        touched.add(page)
        if p2s[page] == HOT_SHARD:
            key = ("hot", int(p2slot[page]) * ps + off)
            bit = int(np.uint32(1) << rng.integers(0, 23, dtype=np.uint32))
        else:
            key = ("cold", int(p2s[page]) * cfg.rows_per_shard
                   + int(p2slot[page]) * ps + off)
            if int8:
                bit = int(np.uint8(1) << rng.integers(0, 8, dtype=np.uint8))
            else:
                bit = int(np.uint32(1) << rng.integers(0, 23,
                                                       dtype=np.uint32))
        acc = masks[key[0]]
        acc[key[1], col] = acc.get((key[1], col), 0) ^ bit
    for name, acc in masks.items():
        if acc:
            (rows, cols), bits = zip(*acc.keys()), list(acc.values())
            _flip_bits(getattr(binding.state, name), rows, cols, bits)
    return sorted(int(p) for p in touched)
