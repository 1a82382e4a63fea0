"""Write-ahead log for streaming embedding-update batches.

A copy of ``repro.checkpoint.wal`` (stdlib + numpy): the same file format,
so each package reads the other's logs and writes the same bytes for the
same appends.  Snapshots commit the full EngineState at a sequence point;
the WAL records every applied delta batch *since* that point, so a restore
replays the suffix and loses nothing.  Single append-only binary file:

    file   := MAGIC record*
    record := header payload
    header := little-endian struct "<qiiI":
                seq (int64), n_rows (int32), dim (int32),
                crc32(payload) (uint32)
    payload:= rows  (n_rows,)      int32  little-endian
              deltas (n_rows, dim) float32 little-endian

Durability semantics (standard WAL):

  * ``append`` writes + flushes before the caller applies the batch to
    the device; replay always starts from the snapshot's sequence point.
  * ``replay`` stops cleanly at a torn tail (a partial record from a
    crash mid-append: the batch was never applied), but a CRC mismatch on
    a *complete* record is corruption and raises.
  * *opening* an existing log truncates any torn tail first, so
    post-recovery appends start on a valid record boundary.
  * ``truncate`` resets the log after a snapshot commits.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Iterator, Tuple

import numpy as np

MAGIC = b"PIFSWAL1"
_HEADER = struct.Struct("<qiiI")


class WriteAheadLog:
    """Append-only delta-batch log (see module docstring for the format).

    Opening an existing log keeps its complete records (append continues
    after them) and truncates a torn tail from a crash mid-append;
    ``records`` counts complete records currently on disk."""

    def __init__(self, path: str):
        self.path = path
        if not os.path.exists(path) or os.path.getsize(path) == 0:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "wb") as f:
                f.write(MAGIC)
        self.records = self._recover()

    def _recover(self) -> int:
        """Walk to the end of the last complete record (the same walk
        ``replay`` does) and cut anything after it.  ``append`` opens the
        file with mode 'ab': without this cut, a record appended after a
        crash mid-append would start inside the partial record's garbage
        bytes, and a later replay would either stop at the torn point
        (silently dropping every post-recovery record) or mis-parse and
        raise.  Returns the number of complete records kept; raises on
        bad magic or a checksum mismatch in a complete record, exactly
        like ``replay``."""
        records = 0
        with open(self.path, "r+b") as f:
            head = f.read(len(MAGIC))
            if head != MAGIC:
                raise IOError(f"{self.path}: bad WAL magic {head!r}")
            end = f.tell()
            while True:
                hdr = f.read(_HEADER.size)
                if len(hdr) < _HEADER.size:
                    break                           # torn/absent header
                seq, n, d, crc = _HEADER.unpack(hdr)
                if n < 0 or d <= 0:
                    raise IOError(f"{self.path}: corrupt WAL header "
                                  f"(n_rows={n}, dim={d})")
                payload = f.read(n * 4 + n * d * 4)
                if len(payload) < n * 4 + n * d * 4:
                    break                           # torn payload
                if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                    raise IOError(f"{self.path}: WAL record seq={seq} "
                                  "checksum mismatch")
                records += 1
                end = f.tell()
            f.seek(0, os.SEEK_END)
            if f.tell() > end:
                f.truncate(end)
                f.flush()
                os.fsync(f.fileno())
        return records

    def append(self, seq: int, rows, deltas) -> None:
        """Log one coalesced delta batch (rows (U,) ids, deltas (U, D))."""
        rows = np.ascontiguousarray(np.asarray(rows, dtype="<i4").reshape(-1))
        deltas = np.ascontiguousarray(
            np.asarray(deltas, dtype="<f4").reshape(rows.size, -1))
        payload = rows.tobytes() + deltas.tobytes()
        header = _HEADER.pack(int(seq), rows.size, deltas.shape[1],
                              zlib.crc32(payload) & 0xFFFFFFFF)
        with open(self.path, "ab") as f:
            f.write(header + payload)
            f.flush()
            os.fsync(f.fileno())
        self.records += 1

    def replay(self) -> Iterator[Tuple[int, np.ndarray, np.ndarray]]:
        """Yield ``(seq, rows, deltas)`` for every complete record.

        A torn tail (partial header or payload — crash mid-append) ends
        iteration silently; a checksum mismatch on a complete record
        raises IOError."""
        with open(self.path, "rb") as f:
            head = f.read(len(MAGIC))
            if head != MAGIC:
                raise IOError(f"{self.path}: bad WAL magic {head!r}")
            while True:
                hdr = f.read(_HEADER.size)
                if len(hdr) < _HEADER.size:
                    return                              # torn/absent header
                seq, n, d, crc = _HEADER.unpack(hdr)
                if n < 0 or d <= 0:
                    raise IOError(f"{self.path}: corrupt WAL header "
                                  f"(n_rows={n}, dim={d})")
                payload = f.read(n * 4 + n * d * 4)
                if len(payload) < n * 4 + n * d * 4:
                    return                              # torn payload
                if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                    raise IOError(f"{self.path}: WAL record seq={seq} "
                                  "checksum mismatch")
                rows = np.frombuffer(payload, dtype="<i4", count=n)
                deltas = np.frombuffer(payload, dtype="<f4",
                                       offset=n * 4).reshape(n, d)
                yield int(seq), rows.astype(np.int32), \
                    deltas.astype(np.float32)

    def truncate(self) -> None:
        """Reset to an empty log (call after a snapshot commits)."""
        with open(self.path, "wb") as f:
            f.write(MAGIC)
            f.flush()
            os.fsync(f.fileno())
        self.records = 0

    def __len__(self) -> int:
        return self.records
