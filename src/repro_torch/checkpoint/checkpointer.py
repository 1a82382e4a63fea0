"""Atomic, asynchronous checkpoints of tensor trees (a port of
``repro.checkpoint.checkpointer``, in the same on-disk format).

  * **Format** -- one ``.npy`` per leaf in ``step_<N:012d>/``, numbered
    ``leaf_<i:06d>.npy`` in sorted key order, and ``manifest.json``:
    ``{step, leaves: {key: {file, shape, dtype, crc}}, time, extra}``,
    ``crc`` the first 16 hex digits of the leaf's md5.  Leaf keys are the
    reference's pytree paths: a dataclass field by its name (an
    ``EngineState`` gives ``cold``, ``hot``, ``page_scales``,
    ``page_to_shard``, ``page_to_slot``, ``counts``), a dict entry by its
    key, nested levels joined by ``::``.  So each package restores the
    other's snapshots.
  * **Async** -- :meth:`Checkpointer.save` copies every leaf to the host
    synchronously (a consistent cut: the engine may mutate its tensors in
    place right after) and writes the files in a background thread.
  * **Atomic commit** -- files go to ``step_<N>.tmp/``, the manifest is
    written last, then the directory is renamed; a ``.tmp`` left by a
    crash is never restored.
  * **Retention** -- the ``keep`` most recent checkpoints stay.
  * **bf16** -- a bfloat16 leaf is written as the reference writes one (2
    raw bytes an element, a ``V2`` ``.npy``; ``dtype`` "bfloat16" in the
    manifest) and restored from its bits.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike

_SEP = "::"  # path separator in flattened keys


def _items(tree: Any, path: Tuple[str, ...] = ()
           ) -> Iterator[Tuple[str, Any]]:
    """(key, leaf) pairs of a tree of dataclasses and dicts."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _items(getattr(tree, f.name), path + (f.name,))
    elif isinstance(tree, dict):
        for k in tree:
            yield from _items(tree[k], path + (str(k),))
    else:
        yield _SEP.join(path), tree


def _rebuild(tree: Any, leaves: Dict[str, Any],
             path: Tuple[str, ...] = ()) -> Any:
    """``tree``'s structure with the leaves of ``leaves`` by key."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), leaves,
                             path + (f.name,))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, path + (str(k),))
                for k, v in tree.items()}
    return leaves[_SEP.join(path)]


def _host_copy(leaf: Any) -> np.ndarray:
    """A host copy the caller's later in-place writes cannot reach."""
    if torch.is_tensor(leaf):
        host = leaf.detach().to("cpu", copy=True)
        if host.dtype == torch.bfloat16:
            return host.view(torch.int16).numpy().view("V2")
        return host.numpy()
    return np.array(leaf, copy=True)


def _from_host(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _dtype_name(leaf: Any) -> str:
    if torch.is_tensor(leaf):
        return str(leaf.dtype).replace("torch.", "")
    return str(np.asarray(leaf).dtype)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pending: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # ----------------------------------------------------------------- save
    def save(self, step: int, tree: Any, blocking: bool = False,
             extra: Optional[Dict[str, Any]] = None) -> None:
        """Copy the tree to the host now, write it in the background (or
        before returning, with ``blocking``).  ``extra`` is a small
        JSON-serializable dict stored in the manifest (e.g. the serving
        WAL's last applied update sequence number)."""
        items = list(_items(tree))
        flat = {k: _host_copy(v) for k, v in items}
        dtypes = {k: _dtype_name(v) for k, v in items}
        self.wait()  # one outstanding write at a time
        t = threading.Thread(target=self._write,
                             args=(step, flat, extra, dtypes), daemon=True)
        t.start()
        self._pending = t
        if blocking:
            self.wait()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _write(self, step: int, flat: Dict[str, np.ndarray],
               extra: Optional[Dict[str, Any]], dtypes: Dict[str, str]
               ) -> None:
        tmp = os.path.join(self.dir, f"step_{step:012d}.tmp")
        final = os.path.join(self.dir, f"step_{step:012d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": {}, "time": time.time(),
                    "extra": dict(extra or {})}
        for i, (key, arr) in enumerate(sorted(flat.items())):
            fname = f"leaf_{i:06d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"][key] = {
                "file": fname,
                "shape": list(arr.shape),
                "dtype": dtypes[key],
                "crc": _crc(arr),
            }
        # manifest written last = commit barrier
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._prune()

    def _prune(self) -> None:
        with self._lock:
            steps = self.all_steps()
            for s in steps[: -self.keep]:
                shutil.rmtree(os.path.join(self.dir, f"step_{s:012d}"),
                              ignore_errors=True)

    # -------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name,
                                               "manifest.json")):
                    out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def manifest(self, step: Optional[int] = None) -> Dict[str, Any]:
        """The manifest of a committed checkpoint (latest by default):
        ``{step, leaves: {key: {file, shape, dtype, crc}}, time, extra}``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:012d}")
        with open(os.path.join(d, "manifest.json")) as f:
            return json.load(f)

    def extra(self, step: Optional[int] = None) -> Dict[str, Any]:
        """The ``extra`` dict of a committed checkpoint (latest by
        default); ``{}`` for a manifest without one."""
        return dict(self.manifest(step).get("extra", {}))

    def _leaf_path(self, key: str, step: Optional[int]
                   ) -> Tuple[str, Dict[str, Any]]:
        manifest = self.manifest(step)
        meta = manifest["leaves"].get(key)
        if meta is None:
            raise KeyError(
                f"no leaf {key!r} in checkpoint step {manifest['step']} "
                f"(has {sorted(manifest['leaves'])})")
        d = os.path.join(self.dir, f"step_{manifest['step']:012d}")
        return os.path.join(d, meta["file"]), meta

    def read_leaf(self, key: str, step: Optional[int] = None,
                  validate: bool = True) -> np.ndarray:
        """Load one leaf by manifest key (CRC-checked by default)."""
        path, meta = self._leaf_path(key, step)
        arr = np.load(path)
        if validate and _crc(arr) != meta["crc"]:
            raise IOError(f"checksum mismatch on {key}")
        return arr

    def read_page(self, key: str, start: int, rows: int,
                  step: Optional[int] = None) -> np.ndarray:
        """``rows`` consecutive rows of a leaf from row ``start``, read
        through a memory map without loading the leaf.  The manifest CRC
        covers the whole leaf, so a partial read is not CRC-checked."""
        return self.read_pages(key, [(start, rows)], step=step)[0]

    def read_pages(self, key: str, spans, step: Optional[int] = None
                   ) -> List[np.ndarray]:
        """Batched :meth:`read_page`: ``spans`` of ``(start_row, n_rows)``
        through one shared memory map of the leaf."""
        path, meta = self._leaf_path(key, step)
        mm = np.load(path, mmap_mode="r")
        n = int(meta["shape"][0]) if meta["shape"] else 0
        out = []
        for start, rows in spans:
            start, rows = int(start), int(rows)
            if start < 0 or start + rows > n:
                raise IndexError(
                    f"page read [{start}, {start + rows}) outside leaf "
                    f"{key!r} with {n} rows")
            out.append(np.array(mm[start:start + rows]))
        del mm
        return out

    def restore(self, tree_like: Any, step: Optional[int] = None,
                device: DeviceLike = None, validate: bool = True,
                into: bool = False) -> Any:
        """Restore into the structure of ``tree_like``: the same keys, and
        per leaf the same dtype and shape (an int8-storage snapshot never
        loads into an fp32 engine), every leaf CRC-checked.

        Returns a new tree of tensors on ``device`` (default: each leaf's
        own device, the CPU for a non-tensor leaf); with ``into``, copies
        each leaf into ``tree_like``'s tensor in place and returns
        ``tree_like`` (no second device allocation)."""
        manifest = self.manifest(step)
        d = os.path.join(self.dir, f"step_{manifest['step']:012d}")
        leaves_meta = manifest["leaves"]
        flat_struct = dict(_items(tree_like))
        if set(flat_struct) != set(leaves_meta):
            missing = set(flat_struct) ^ set(leaves_meta)
            raise ValueError(f"checkpoint/tree structure mismatch: {missing}")
        for key, meta in leaves_meta.items():
            want = flat_struct[key]
            if _dtype_name(want) != meta["dtype"]:
                raise ValueError(
                    f"checkpoint leaf {key!r} dtype mismatch: saved "
                    f"{meta['dtype']}, restoring into {_dtype_name(want)} "
                    "-- was the engine built with the same storage= mode?")
            if list(np.shape(want)) != list(meta["shape"]):
                raise ValueError(
                    f"checkpoint leaf {key!r} shape mismatch: saved "
                    f"{meta['shape']}, restoring into "
                    f"{list(np.shape(want))}")
        restored: Dict[str, Any] = {}
        for key, meta in leaves_meta.items():
            arr = np.load(os.path.join(d, meta["file"]))
            if validate and _crc(arr) != meta["crc"]:
                raise IOError(f"checksum mismatch on {key}")
            want = flat_struct[key]
            if into:
                want.copy_(_from_host(arr, meta["dtype"]))
                continue
            dev = device if device is not None else (
                want.device if torch.is_tensor(want) else "cpu")
            restored[key] = _from_host(arr, meta["dtype"]).to(dev)
        return tree_like if into else _rebuild(tree_like, restored)


def _crc(arr: np.ndarray) -> str:
    """The reference's md5 of ``arr.tobytes()``, hashed from the array's
    own buffer (no second host copy of a multi-GB leaf)."""
    flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return hashlib.md5(flat).hexdigest()[:16]
