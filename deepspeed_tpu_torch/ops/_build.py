"""Compile one CUDA source of ``deepspeed_tpu_torch/csrc`` into a shared
library with a plain C interface, and load it with ctypes.

``nvcc`` builds for ``sm_90a`` at first use into ``build_dir()``: the
compile cache's directory (``utils/compile_cache.py``: the config's
``compile_cache.dir`` or ``DSTPU_COMPILE_CACHE_DIR``), else
``build/kernels/``.  The library's name carries a hash of the source, the
shared headers of ``csrc/`` and the flags, so an edited source is rebuilt
and an unchanged one is loaded as it is: a load counts one
``resilience.COUNTERS.compile_cache_hits``, a build one
``compile_cache_misses``.  Sources that
are built at the same time (one thread each) run their ``nvcc`` in
parallel: the wait on the subprocess releases the GIL.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
        return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (pathlib.Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(pathlib.Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def build_dir() -> pathlib.Path:
    """Where libraries are built and loaded: the compile cache's directory
    when one is enabled or exported, else ``BUILD_DIR``."""
    from deepspeed_tpu_torch.utils import compile_cache
    d = compile_cache.enabled_dir() or os.environ.get(compile_cache.ENV_DIR)
    return pathlib.Path(d) if d else BUILD_DIR


def library_path(source: pathlib.Path) -> pathlib.Path:
    """The ``.so`` that ``build_library(source)`` writes and loads."""
    src = source.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"{source.stem}_{tag[:16]}.so"


def build_library(source: pathlib.Path):
    """``(ctypes.CDLL, compiler output)`` for ``source``; the output is ""
    when an earlier build of the same source and flags was loaded."""
    from deepspeed_tpu_torch.resilience.counters import COUNTERS
    out = library_path(source)
    log = ""
    if out.exists():
        COUNTERS.compile_cache_hits += 1
    else:
        COUNTERS.compile_cache_misses += 1
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}) building {source}:\n{log}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.dstt_error_string.argtypes = [ctypes.c_int]
    lib.dstt_error_string.restype = ctypes.c_char_p
    return lib, log


def raise_on(name: str, lib, rc: int) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = lib.dstt_error_string(rc).decode()
        raise RuntimeError(f"{name}: kernel launch failed: {msg} ({rc})")


def on_cuda(name: str, t) -> bool:
    """True for a CUDA tensor, False for a CPU one (the plain route)."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}")
    return True
