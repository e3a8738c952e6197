"""The compile cache: where the kernel libraries are built and loaded.

The port of ``deepspeed_tpu/utils/compile_cache.py``.  The port compiles
no XLA program; what it compiles is the nvcc libraries of ``ops/_build.py``
(one ``.so`` per CUDA source, named by a hash of the source, the shared
headers and the flags).  So the persistent compilation cache is the
directory those libraries are written to and loaded from: a relaunched
worker that finds the prior attempt's libraries there loads them instead
of running nvcc again.

* config ``compile_cache: {dir, min_entry_size_bytes}`` (or the bare
  string ``"compile_cache": "/path"``): the engine calls
  :func:`enable_from_config` in ``__init__``;
* env ``DSTPU_COMPILE_CACHE_DIR``: the fallback when the config carries no
  ``dir``, and how the launcher (``--compile_cache_dir``) hands the
  directory to every worker and relaunch; :func:`enable` exports it, so
  child processes inherit it.  ``ops/_build.build_dir`` reads it too, so a
  library built before any engine lands there as well;
* without either, the libraries are built in ``build/kernels/`` of the
  checkout;
* observability: a library loaded from an existing ``.so`` counts one
  ``resilience.COUNTERS.compile_cache_hits``, an nvcc run one
  ``compile_cache_misses`` (``ops/_build.build_library``), exported as
  ``Train/Resilience/*`` scalars and in the startup event.

``min_entry_size_bytes`` is parsed and validated as in the JAX package,
but has no effect here: every kernel library is cached, whatever its size.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

logger = logging.getLogger(__name__)

#: env spelling of the cache directory: exported by :func:`enable` so
#: launcher-relaunched workers (``--max_restarts``) land in the same cache
ENV_DIR = "DSTPU_COMPILE_CACHE_DIR"

_enabled_dir: Optional[str] = None


def enable(cache_dir: str, min_entry_size_bytes: int = 0) -> str:
    """Point the kernel build directory at ``cache_dir`` (created if
    missing) and export :data:`ENV_DIR` for child processes.  Libraries
    already loaded in this process stay loaded.  Returns the directory."""
    global _enabled_dir
    cache_dir = os.path.abspath(os.path.expanduser(cache_dir))
    os.makedirs(cache_dir, exist_ok=True)
    if _enabled_dir is not None and _enabled_dir != cache_dir:
        logger.warning(
            "compile_cache: re-pointing the kernel build directory from %s "
            "to %s (process-wide setting)", _enabled_dir, cache_dir)
    os.environ[ENV_DIR] = cache_dir
    _enabled_dir = cache_dir
    logger.info("compile_cache: kernel libraries under %s "
                "(min_entry_size_bytes=%d has no effect on .so files)",
                cache_dir, int(min_entry_size_bytes))
    return cache_dir


def disable() -> None:
    """Back to the checkout's ``build/kernels/`` (tests)."""
    global _enabled_dir
    os.environ.pop(ENV_DIR, None)
    _enabled_dir = None


def enabled_dir() -> Optional[str]:
    return _enabled_dir


def resolve_dir(config) -> Optional[str]:
    """The directory an engine build should enable: the config's
    ``compile_cache.dir`` if set, else the :data:`ENV_DIR` fallback."""
    cfg_dir = getattr(config, "compile_cache_dir", None)
    if cfg_dir:
        return cfg_dir
    return os.environ.get(ENV_DIR) or None


def enable_from_config(config) -> Optional[str]:
    """Engine-build hook: enable the cache when configured (no-op
    otherwise).  Returns the enabled directory or None."""
    cache_dir = resolve_dir(config)
    if cache_dir is None:
        return None
    return enable(cache_dir,
                  int(getattr(config, "compile_cache_min_entry_size_bytes",
                              0)))
