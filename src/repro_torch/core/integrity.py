"""Per-page checksum ledger: silent-corruption detection for the store (a
port of ``repro.core.integrity``).

``validate_ids`` rejects out-of-range ids and ``scrub_scores`` zeroes
non-finite scores, but a bit flip that leaves a finite wrong embedding
passes both.  The ledger closes that gap:

  * every page of the live store (int8 codes and their carried fp32
    scale, or fp32 values) has a host-side checksum over its
    *native-domain* bits, the bytes resident in its current tier;
  * every legitimate mutation path updates it (``apply_deltas`` chunks,
    re-plan migrations, ``requant_hot_pages``, requant-demotes, elastic
    re-meshes), so at any quiescent point ``ledger == recompute(store)``
    holds bit for bit;
  * anything that mutates a page outside those paths -- a flipped bit, a
    bad copy, a faulty kernel -- breaks the invariant and is caught by the
    scrub sweep (``serving/scrub.py``).

Checksum (the ``page_checksums`` kernel, its plain version
``kernels/ref.page_checksums_ref`` and the numpy twin here agree bit for
bit): a Fletcher pair in uint32 wraparound arithmetic over the page's
lanes -- its rows reinterpreted as unsigned integers (int8 codes -> uint8;
fp32 values -> their IEEE-754 bit patterns) -- and the page scale's fp32
bits:

    s1 = (sum_i lane_i            + scale_bits)           mod 2^32
    s2 = (sum_i lane_i * (i + 1)  + scale_bits * (N + 1)) mod 2^32

with ``N = page_size * dim`` lanes, stored as the uint64 ``(s2 << 32) |
s1``.  The position weight makes swapped or shifted rows visible.  All
arithmetic is exact integer wraparound, so a snapshot page read on the
host verifies against the ledger the card recorded.

Tier semantics: a page's checksum covers its current-tier content.  Moves
that carry content verbatim (a cold page to another slot or shard, a hot
page to another hot slot, any page across a re-mesh without a tier
change) keep it -- so the ledger survives a re-mesh (page geometry does
not depend on the shard count).  Tier flips change the native-domain
content (promote dequantizes, demote re-quantizes on the carried scale),
so flipped pages are recomputed where they flip.

Unlike the reference, whose ``compute`` chunks every request through one
fixed window of ``chunk`` pages (one compiled plan), the port compiles
nothing per shape: one ``compute`` is one ``page_checksums`` call for all
its pages -- one kernel launch on the card, where a whole RMC4 store is
about a million pages.  ``chunk`` stays for the API and for ``export()``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.paging import HOT_SHARD, host


def page_checksum_host(rows: np.ndarray, scale: float) -> int:
    """Numpy twin of the device per-page checksum (bit-identical).

    ``rows``: the page's (page_size, dim) content in its native dtype
    (int8 codes or float32 values); ``scale``: the page's carried fp32
    scale.  Returns the uint64 ``(s2 << 32) | s1`` as a Python int."""
    rows = np.ascontiguousarray(rows)
    if rows.dtype == np.int8:
        lanes = rows.view(np.uint8).astype(np.uint32).ravel()
    elif rows.dtype == np.float32:
        lanes = rows.view(np.uint32).ravel()
    else:
        raise TypeError(f"unsupported page dtype {rows.dtype}: the store "
                        "holds int8 codes or fp32 values")
    sc = int(np.asarray(scale, np.float32).view(np.uint32))
    n = int(lanes.size)
    w = np.arange(1, n + 1, dtype=np.uint32)
    # numpy uint32 sums wrap; the final adds are taken in Python ints, mod
    # 2^32 (a numpy-scalar add would warn on overflow)
    s1 = (int(lanes.sum(dtype=np.uint32)) + sc) % (1 << 32)
    s2 = (int((lanes * w).sum(dtype=np.uint32)) + sc * (n + 1)) % (1 << 32)
    return (s2 << 32) | s1


class PageChecksumLedger:
    """Host-side per-page checksum ledger over a live ``EngineState``.

    One uint64 per global page id.  Callers notify it on every mutation
    path (:meth:`note_rows` after delta application, :meth:`note_pages`
    after requant snaps, :meth:`note_tier_changes` after a placement change
    that may flip tiers); :meth:`verify` recomputes pages on the card and
    returns those whose live checksum differs from the ledger -- silent
    corruption, since every legitimate mutation updated it.  ``impl``
    routes the recomputation as the engine's lookups are routed."""

    def __init__(self, engine, chunk: int = 64, impl: str = "cuda"):
        self.engine = engine
        self.chunk = int(chunk)
        self.impl = impl
        self.checksums = np.zeros(engine.cfg.num_pages, np.uint64)

    @classmethod
    def build(cls, engine, state, chunk: int = 64,
              impl: str = "cuda") -> "PageChecksumLedger":
        """A ledger for ``state`` with every page's checksum recorded."""
        ledger = cls(engine, chunk=chunk, impl=impl)
        ledger.note_pages(state,
                          np.arange(engine.cfg.num_pages, dtype=np.int64))
        return ledger

    # -------------------------------------------------------------- device
    def compute(self, state, pages) -> np.ndarray:
        """Recompute the checksums of ``pages`` on the engine's device ->
        uint64 array, in one ``page_checksums`` call."""
        pages = np.asarray(pages, np.int32).ravel()
        if pages.size == 0:
            return np.zeros(0, np.uint64)
        cs = host(self.engine.page_checksums(
            state, torch.as_tensor(pages, device=self.engine.device),
            impl=self.impl)).astype(np.uint64)
        return (cs[:, 1] << np.uint64(32)) | cs[:, 0]

    def warmup(self, state) -> None:
        """Serve the checksum signature once before steady state (an
        all-pad window: reads nothing, returns zeros)."""
        self.engine.page_checksums(
            state, torch.full((self.chunk,), -1, dtype=torch.int32,
                              device=self.engine.device), impl=self.impl)

    # --------------------------------------------------------- maintenance
    def note_pages(self, state, pages) -> None:
        """Re-record the listed pages' checksums from the live state."""
        pages = np.asarray(pages, np.int64).ravel()
        pages = pages[pages >= 0]
        if pages.size == 0:
            return
        self.checksums[pages] = self.compute(state, pages)

    def note_rows(self, state, rows) -> np.ndarray:
        """Re-record the checksums of every page touching ``rows`` (global
        row ids; pads < 0 ignored).  Returns the touched pages."""
        rows = np.asarray(rows, np.int64).ravel()
        rows = rows[rows >= 0]
        if rows.size == 0:
            return rows
        pages = np.unique(rows // self.engine.cfg.page_size)
        self.note_pages(state, pages)
        return pages

    def note_tier_changes(self, state, old_p2s, new_p2s) -> np.ndarray:
        """Re-record the pages whose tier flipped between two placements
        (a slot or shard move keeps its checksum).  Returns their ids."""
        old_hot = host(old_p2s) == HOT_SHARD
        new_hot = host(new_p2s) == HOT_SHARD
        flipped = np.nonzero(old_hot != new_hot)[0]
        if flipped.size:
            self.note_pages(state, flipped)
        return flipped

    def rebind(self, engine) -> None:
        """Point the ledger at a re-meshed engine.  Page geometry does not
        depend on the shard count, so the recorded checksums carry over;
        the caller recomputes tier-flipped pages
        (:meth:`note_tier_changes`)."""
        if int(engine.cfg.num_pages) != self.checksums.size:
            raise ValueError(
                f"cannot rebind ledger across a page-geometry change: "
                f"{self.checksums.size} pages recorded, new engine has "
                f"{engine.cfg.num_pages}")
        self.engine = engine

    # ------------------------------------------------------------ auditing
    def verify(self, state, pages=None) -> np.ndarray:
        """Recompute ``pages`` (default: all) and return the ids whose live
        checksum differs from the ledger."""
        if pages is None:
            pages = np.arange(self.engine.cfg.num_pages, dtype=np.int64)
        pages = np.asarray(pages, np.int64).ravel()
        pages = pages[pages >= 0]
        if pages.size == 0:
            return pages
        live = self.compute(state, pages)
        return pages[live != self.checksums[pages]]

    # -------------------------------------------------------- serialization
    def export(self) -> dict:
        """JSON-serializable form (the snapshot manifest's ``extra``
        payload), the reference's format."""
        return {"version": 1, "chunk": self.chunk,
                "checksums": [f"{int(c):016x}" for c in self.checksums]}

    def load(self, data: dict) -> None:
        """Adopt an exported ledger (the snapshot-restore path)."""
        recorded = data["checksums"]
        if len(recorded) != self.checksums.size:
            raise ValueError(
                f"ledger size mismatch: {len(recorded)} recorded pages vs "
                f"{self.checksums.size} in this engine")
        self.checksums = np.array([int(c, 16) for c in recorded],
                                  dtype=np.uint64)


def fetch_snapshot_page(checkpointer, cfg, page: int,
                        step: Optional[int] = None) -> dict:
    """Read ONE page's rows (and metadata) out of a committed snapshot
    without loading any whole store leaf.

    The small page tables and scales load whole (CRC-checked), the store
    leaf is sliced through a memory map.  Returns ``{page, tier, shard,
    slot, rows, scale, checksum}``, ``checksum`` the snapshot-time ledger
    entry (None for a snapshot without a ledger): repair verifies the rows
    against it with :func:`page_checksum_host` before trusting them."""
    step = checkpointer.latest_step() if step is None else step
    if step is None:
        raise FileNotFoundError("no committed snapshot to read a page from")
    p2s = checkpointer.read_leaf("page_to_shard", step=step)
    p2slot = checkpointer.read_leaf("page_to_slot", step=step)
    scales = checkpointer.read_leaf("page_scales", step=step)
    shard, slot = int(p2s[page]), int(p2slot[page])
    ps = cfg.page_size
    if shard == HOT_SHARD:
        tier = "hot"
        rows = checkpointer.read_page("hot", slot * ps, ps, step=step)
    else:
        tier = "cold"
        rows = checkpointer.read_page(
            "cold", shard * cfg.rows_per_shard + slot * ps, ps, step=step)
    rec = checkpointer.extra(step).get("page_checksums")
    checksum = (int(rec["checksums"][page], 16)
                if rec and rec.get("checksums") else None)
    return {"page": int(page), "tier": tier, "shard": shard, "slot": slot,
            "rows": rows, "scale": float(scales[page]), "checksum": checksum}
