"""CUDA chunk decoder (``ops/cuda/decode_chunks.cu``) as a JAX operation.

The kernel decodes independent tag streams of at most 64 KiB output, one
thread block per stream, with the output window in shared memory (see the
source for the design).  It is compiled with ``nvcc`` for Hopper (sm_90a)
at first use, from the committed source, into
``ops/cuda/build/<hash>/`` (gitignored); the hash covers the source and the
compiler flags, so an edit to either rebuilds.  A failed build raises.

Building and registering happen at the first trace of ``decode_chunks``,
which the engine reaches only on a GPU (``engine._chunk_kernel``).  The CPU
backend uses ``ops/decode_jax.py``, which stays as the reference this
kernel is tested against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List

import jax
import jax.numpy as jnp

TARGET = "snappy_decode_chunks"
WINDOW = 65536  # output bytes per row (one Snappy block)

_CUDA_DIR = Path(__file__).resolve().parent / "cuda"
SOURCE = _CUDA_DIR / "decode_chunks.cu"
BUILD_ROOT = _CUDA_DIR / "build"
LIB_NAME = "libsnappy_decode_chunks.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_registered = False


def nvcc() -> str:
    """The CUDA compiler: the toolkit's own if installed, else ``nvcc`` on PATH."""
    path = Path("/usr/local/cuda/bin/nvcc")
    return str(path) if path.exists() else "nvcc"


def source_hash() -> str:
    """Build key: the kernel source and the compiler flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / source_hash() / LIB_NAME


def build_command(out: Path) -> List[str]:
    return [
        nvcc(), *NVCC_FLAGS,
        "-I", jax.ffi.include_dir(),
        "-o", str(out), str(SOURCE),
    ]


def build() -> Path:
    """Compile the kernel library if this source has not been built yet."""
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    proc = subprocess.run(build_command(tmp), capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {SOURCE.name}:\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: concurrent builders never see a partial file
    return lib


def register() -> None:
    """Build the library and register its FFI target for CUDA (once)."""
    global _registered
    with _lock:
        if _registered:
            return
        lib = ctypes.cdll.LoadLibrary(str(build()))
        jax.ffi.register_ffi_target(
            TARGET, jax.ffi.pycapsule(lib.SnappyDecodeChunks), platform="CUDA"
        )
        _registered = True


def decode_chunks(comp_u8, comp_lens, out_lens):
    """Decode ``n`` independent raw tag streams on a GPU.

    comp_u8: uint8 [n, width], zero-padded past comp_lens; comp_lens and
    out_lens (declared sizes, <= 65536): int32 [n].  Returns
    (out uint8 [n, 65536] zeroed past the bytes written, ok bool [n],
    written int32 [n]) -- the contract of ``decode_jax.decode_chunks``.
    """
    register()
    n = comp_u8.shape[0]
    out, status = jax.ffi.ffi_call(
        TARGET,
        (
            jax.ShapeDtypeStruct((n, WINDOW), jnp.uint8),
            jax.ShapeDtypeStruct((n, 2), jnp.int32),
        ),
    )(comp_u8, comp_lens.astype(jnp.int32), out_lens.astype(jnp.int32))
    return out, status[:, 0] == 1, status[:, 1]
