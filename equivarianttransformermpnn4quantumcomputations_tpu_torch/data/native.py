"""ctypes bridge to the host neighbour-list builder (``csrc/neighborlist.cpp``).

Port of the JAX package's data/native.py.  The shared library is compiled
with g++ at first use, never at import, into ``_build/`` beside the package
(listed in ``.gitignore``), named by a hash of its source and flags so that
an edited source rebuilds.  Each process compiles into a temporary file of
its own and moves it into place with ``os.replace``, so processes that build
at once (test workers, the ranks of a data-parallel run) never see a
partial library.  There is no fallback: a missing compiler or a failed build
raises, with the compiler's output.  ``data/graph.py`` chooses between this
builder and its numpy path with ``USE_NATIVE``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["neighbor_list_native", "library_path"]

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE = PACKAGE_DIR / "csrc" / "neighborlist.cpp"
BUILD_DIR = PACKAGE_DIR / "_build"
GXX_FLAGS = ("-O3", "-ffp-contract=off", "-shared", "-fPIC")

_LOCK = threading.Lock()
_FN = None
_P64, _P32, _PD = (ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
                   ctypes.POINTER(ctypes.c_double))


def library_path() -> Path:
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libneighborlist-{key}.so"


def _build(lib: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".libneighborlist-{os.getpid()}.so"
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"the neighbour-list builder needs g++ ({' '.join(cmd)}): {e}") from e
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SOURCE.name} (rc {r.returncode}):\n"
                           f"{' '.join(cmd)}\n{r.stderr}")
    os.replace(tmp, lib)


def _load():
    """The C entry point, compiled first if this checkout has not built it."""
    global _FN
    with _LOCK:
        if _FN is None:
            lib = library_path()
            if not lib.exists():
                _build(lib)
            fn = ctypes.CDLL(str(lib)).etq_neighbor_list
            fn.restype = ctypes.c_int64
            fn.argtypes = [_PD, ctypes.c_int64, _PD, ctypes.c_int32, ctypes.c_double,
                           ctypes.c_int64, _P64, _P64, _P32, ctypes.c_int64]
            _FN = fn
        return _FN


def neighbor_list_native(pos: np.ndarray, cell: np.ndarray | None, pbc: bool,
                         cutoff: float, max_neighbors: int | None):
    """(src [E] int64, dst [E] int64, shift [E, 3] int32): the edges of
    ``data/graph.py``'s numpy path, in its order."""
    fn = _load()
    pos = np.ascontiguousarray(pos, dtype=np.float64)
    if pos.ndim != 2 or pos.shape[1] != 3:
        raise ValueError(f"pos must be [n, 3], got {pos.shape}")
    if pbc and cell is None:
        raise ValueError("a periodic structure needs its cell")
    cell = np.ascontiguousarray(cell if pbc else np.zeros((3, 3)), dtype=np.float64)
    if cell.shape != (3, 3):
        raise ValueError(f"cell must be [3, 3], got {cell.shape}")
    n = pos.shape[0]
    cap = max(64, n * (27 if pbc else 1) * 64)
    while True:
        src, dst = np.empty(cap, np.int64), np.empty(cap, np.int64)
        shift = np.empty((cap, 3), np.int32)
        total = fn(pos.ctypes.data_as(_PD), n, cell.ctypes.data_as(_PD), int(bool(pbc)),
                   float(cutoff), -1 if max_neighbors is None else int(max_neighbors),
                   src.ctypes.data_as(_P64), dst.ctypes.data_as(_P64),
                   shift.ctypes.data_as(_P32), cap)
        if total <= cap:
            return src[:total], dst[:total], shift[:total]
        cap = int(total)
