"""Build and load the hand-written CUDA kernels, and count their launches.

Each ``csrc/<stem>.cu`` has a plain C interface and compiles on its own with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/kernels/<stem>-<hash>.so csrc/<stem>.cu

into ``build/kernels/`` at the repository root (listed in ``.gitignore``).
A kernel that varies another shares its source with it: the gather-once
(dedup) ``masked_sls_dedup`` lives in ``masked_sls.cu``;
``fused_front_end_dedup`` and the partial pools ``fused_partial_pool`` and
``fused_partial_pool_dedup`` in ``fused_front_end.cu``; ``fused_resume`` in
``dot_interaction.cu``.  ``apply_deltas`` (``apply_deltas.cu``) and
``page_checksums`` (``page_checksums.cu``) replace no Pallas kernel: they
are the device halves of the reference's streaming updates and integrity
ledger, computed there in jnp.
The build runs at first use; every missing library is compiled by its own
``nvcc`` process, all started together.  The hash covers every source and
the flags, so an edited source is rebuilt.  Libraries are loaded with
``ctypes``: pointers and the stream pass as ``c_void_p``, and every entry
returns ``cudaGetLastError()`` after its launch.

``KERNELS`` is the registry: what each kernel replaces and how often its
wrapper launched it (a plain integer the wrapper bumps at each launch).
:func:`kernel_call` reports each call of a kernel, on any route (launch,
plain version or a fake tensor's shape function), to the counters in
``SINKS`` (``launch/op_stats.py``).  ``LIBRARIES`` records, for this
process, each library :func:`build_all` compiled (its ``nvcc`` seconds) or
found built in ``build/kernels`` (``None``); :func:`libraries_line` prints
it, so a run says which kernel was built again.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass
class KernelInfo:
    name: str          # C entry point
    replaces: str      # the Pallas TPU kernel (file:line of its pallas_call),
    #                    or the reference's jnp code a kernel stands in for
    stem: str = ""     # source stem (csrc/<stem>.cu); defaults to ``name``
    launches: int = 0  # launches by the wrapper since the last reset

    def __post_init__(self):
        self.stem = self.stem or self.name

    @property
    def source(self) -> str:
        return str((CSRC / f"{self.stem}.cu").relative_to(REPO_ROOT))


KERNELS: Dict[str, KernelInfo] = {k.name: k for k in (
    KernelInfo("masked_sls",
               "src/repro/kernels/sls.py:148 (_sls_call: masked_sls_pallas"
               " and sls_pallas)"),
    KernelInfo("dot_interaction",
               "src/repro/kernels/interaction.py:64 (dot_interaction_pallas)"),
    KernelInfo("fused_front_end",
               "src/repro/kernels/sls.py:614 (fused_front_end_pallas)"),
    KernelInfo("masked_sls_dedup",
               "src/repro/kernels/sls.py:304 (masked_sls_dedup_pallas)",
               stem="masked_sls"),
    KernelInfo("fused_front_end_dedup",
               "src/repro/kernels/sls.py:683 (fused_front_end_dedup_pallas)",
               stem="fused_front_end"),
    KernelInfo("fused_partial_pool",
               "src/repro/kernels/sls.py:750 (fused_partial_pool_pallas)",
               stem="fused_front_end"),
    KernelInfo("fused_partial_pool_dedup",
               "src/repro/kernels/sls.py:818 "
               "(fused_partial_pool_dedup_pallas)",
               stem="fused_front_end"),
    KernelInfo("fused_resume",
               "src/repro/kernels/sls.py:871 (fused_resume_pallas)",
               stem="dot_interaction"),
    KernelInfo("apply_deltas",
               "src/repro/core/pifs.py:1232 (_build_update_plan.block: jnp, "
               "no Pallas kernel)"),
    KernelInfo("page_checksums",
               "src/repro/core/pifs.py:1394 (_build_checksum_plan.block: "
               "jnp, no Pallas kernel)"),
)}

# active call counters: each has kernel_enter(name) and kernel_exit(name)
SINKS: List = []


@contextlib.contextmanager
def kernel_call(name: str):
    """One call of kernel ``name``, whatever its route: every sink in
    ``SINKS`` sees it enter and leave (the plain version's own operations
    run in between)."""
    for s in SINKS:
        s.kernel_enter(name)
    try:
        yield
    finally:
        for s in SINKS:
            s.kernel_exit(name)


# source stem -> nvcc seconds in this process, or None: found built
LIBRARIES: Dict[str, Optional[float]] = {}

_LIBS: Dict[str, ctypes.CDLL] = {}
_ENTRIES: Dict[str, ctypes._CFuncPtr] = {}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", "") + "/bin/nvcc",
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:12]


def lib_path(stem: str) -> Path:
    return BUILD_DIR / f"{stem}-{_digest()}.so"


def build_all(names: Sequence[str] = tuple(KERNELS)) -> Dict[str, Path]:
    """Compile the library of every named kernel that is not built yet, one
    ``nvcc`` per source, all in parallel; returns the libraries by source
    stem.  Raises with the compiler's output if one fails.  The ``-Xptxas
    -v`` report (registers, shared memory, spills) is kept in
    ``build/kernels/<stem>-<hash>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {KERNELS[n].stem: lib_path(KERNELS[n].stem) for n in names}
    procs = {}
    t0 = time.perf_counter()
    for n, out in paths.items():
        if out.exists():
            LIBRARIES.setdefault(n, None)
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        log = open(out.with_suffix(".log"), "w")
        procs[n] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
             str(CSRC / f"{n}.cu")],
            stdout=log, stderr=subprocess.STDOUT), tmp, out, log)
    failed = []
    while procs:
        time.sleep(0.05)
        for n in [n for n, p in procs.items() if p[0].poll() is not None]:
            proc, tmp, out, log = procs.pop(n)
            log.close()
            if proc.returncode != 0:
                failed.append(f"{n} (rc={proc.returncode}):\n"
                              + out.with_suffix(".log").read_text())
            else:
                os.replace(tmp, out)
                LIBRARIES[n] = time.perf_counter() - t0
                print(f"kernels: nvcc built {n} in {LIBRARIES[n]:.1f} s",
                      file=sys.stderr, flush=True)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def libraries_line() -> str:
    """This process's kernel libraries: compiled (with ``nvcc`` seconds)
    and found built."""
    built = [f"{n} {s:.1f} s" for n, s in LIBRARIES.items() if s is not None]
    ready = [n for n, s in LIBRARIES.items() if s is None]
    return (f"kernel libraries built with nvcc: {', '.join(built) or 'none'}"
            f"; found in {BUILD_DIR.relative_to(REPO_ROOT)}: "
            f"{', '.join(ready) or 'none'}")


def entry(name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry ``name`` of its kernel's source, built and loaded on
    first use, with its ``argtypes`` set and an ``int`` (cudaError_t)
    result."""
    fn = _ENTRIES.get(name)
    if fn is None:
        stem = KERNELS[name].stem
        if stem not in _LIBS:
            _LIBS[stem] = ctypes.CDLL(str(build_all([name])[stem]))
        fn = getattr(_LIBS[stem], name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _ENTRIES[name] = fn
    return fn


def check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err}")
