"""Runtime configuration: codec backend selection.

Two execution paths provide identical semantics (cross-tested):

* ``device`` — the JAX kernels: decode/encode batched in slabs on the
  accelerator, with on-device CRC32C.  The right path when payloads
  already live (or are headed) in device memory, and the only path for the
  ``parallel`` mesh APIs.
* ``host`` — the native C runtime (ops/native/snappy_codec.c) with
  thread fan-out over 64 KiB block spans.  The right path for host-resident
  bytes, so one-shot ``bytes -> bytes`` calls route here by default.

``auto`` (default) picks ``host`` when the native library is available and
``device`` otherwise.  Select explicitly with ``set_backend`` or the
``SNAPPY_TPU_BACKEND`` environment variable.
"""

from __future__ import annotations

import os
from pathlib import Path

_VALID = ("auto", "device", "host")


# Fixed so that its path, part of every cache key, never moves.
COMPILE_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def ensure_compilation_cache() -> None:
    """Give JAX a persistent compilation cache before the first device compile.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's own setting and is left
    alone; otherwise the cache is the checkout's ``.jax_cache/`` (gitignored).
    The CPU backend gets none: it compiles in seconds, and its entries carry
    the host's CPU features.  Idempotent.
    """
    import jax

    if os.environ.get("JAX_COMPILATION_CACHE_DIR") or jax.default_backend() == "cpu":
        return
    if jax.config.jax_compilation_cache_dir is None:
        jax.config.update("jax_compilation_cache_dir", str(COMPILE_CACHE_DIR))


_backend = os.environ.get("SNAPPY_TPU_BACKEND", "auto")
if _backend not in _VALID:
    _backend = "auto"


def set_backend(name: str) -> None:
    global _backend
    if name not in _VALID:
        raise ValueError(f"backend must be one of {_VALID}")
    _backend = name


def get_backend() -> str:
    return _backend


def resolve_backend() -> str:
    """Resolve 'auto' to a concrete backend."""
    if _backend != "auto":
        return _backend
    from .ops import host_codec

    return "host" if host_codec.available() else "device"
