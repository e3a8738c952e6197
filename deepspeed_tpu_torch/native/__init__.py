"""Native (C) host helpers, loaded with ctypes, with numpy fallbacks.

The port's copy of ``deepspeed_tpu/native``: the data loader's parallel row
gather (``collate.c``).  The system C compiler builds it at first use into
the repository's ignored ``build/native/`` (the library's name carries a
hash of the source); where no compiler exists every entry point falls back
to numpy.  ``ROUTES`` counts the gathers each route served, so a caller
can tell which one ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import pathlib
import subprocess
import threading
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

_SRC = pathlib.Path(__file__).resolve().parent / "collate.c"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "native"

#: gathers served since the last ``reset_routes()``, by route
ROUTES = {"native": 0, "numpy": 0}

_lib = None
_load_tried = False
_load_lock = threading.Lock()
_routes_lock = threading.Lock()


def reset_routes() -> None:
    with _routes_lock:
        for k in ROUTES:
            ROUTES[k] = 0


def _count(route: str) -> None:
    with _routes_lock:
        ROUTES[route] += 1


def _so_path() -> pathlib.Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"dstt_collate_{digest}.so"


def _owned_by_us(path: pathlib.Path) -> bool:
    st = path.stat()
    return st.st_uid == os.getuid() and not (st.st_mode & 0o022)


def _load():
    """Compile (once per source version) and dlopen the gather; None when
    that fails (no compiler), which selects the numpy route."""
    global _lib, _load_tried
    with _load_lock:
        if _load_tried:
            return _lib
        _load_tried = True
        try:
            so = _so_path()
            if not so.exists():
                BUILD_DIR.mkdir(mode=0o700, parents=True, exist_ok=True)
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run(
                    [os.environ.get("CC", "cc"), "-O3", "-shared", "-fPIC",
                     "-pthread", "-o", str(tmp), str(_SRC)],
                    check=True, capture_output=True, timeout=60)
                os.chmod(tmp, 0o700)
                os.replace(tmp, so)     # atomic if two processes compile
            if not _owned_by_us(so):
                raise OSError(f"refusing to load {so}: not owned by uid "
                              f"{os.getuid()} with mode ~go-w")
            lib = ctypes.CDLL(str(so))
            lib.gather_rows.restype = ctypes.c_int
            lib.gather_rows.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
            _lib = lib
        except (OSError, subprocess.SubprocessError) as e:
            logger.warning("native collate unavailable (%s); using numpy", e)
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def gather_rows(src: np.ndarray, indices: np.ndarray,
                n_threads: Optional[int] = None) -> np.ndarray:
    """``src[indices]`` for an array with a leading sample axis: a
    multithreaded memcpy when the native gather loaded, numpy fancy
    indexing otherwise, with the same index rules on both (negatives wrap,
    anything else out of range raises)."""
    lib = _load()
    src = np.ascontiguousarray(src)
    idx = np.ascontiguousarray(indices, dtype=np.int64)
    if idx.ndim != 1:
        raise ValueError("indices must be 1-D")
    n = src.shape[0] if src.ndim else 0
    if idx.size:
        idx = np.where(idx < 0, idx + n, idx)
        if idx.min() < 0 or idx.max() >= n:
            raise IndexError("gather index out of range")
    if lib is None or src.ndim == 0 or src.dtype.hasobject:
        # object arrays must take numpy: a memcpy of PyObject* skips the
        # reference counts
        _count("numpy")
        return src[idx]
    out = np.empty((idx.size,) + src.shape[1:], dtype=src.dtype)
    row_bytes = src.dtype.itemsize * int(np.prod(src.shape[1:],
                                                 dtype=np.int64))
    _count("native")
    if row_bytes == 0 or idx.size == 0:
        return out
    nt = n_threads or min(8, os.cpu_count() or 1)
    rc = lib.gather_rows(
        out.ctypes.data_as(ctypes.c_void_p),
        src.ctypes.data_as(ctypes.c_void_p),
        idx.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(idx.size), ctypes.c_int64(row_bytes),
        ctypes.c_int(nt))
    if rc != 0:
        raise RuntimeError(f"native gather_rows failed ({rc})")
    return out
