"""Multi-host distribution: each host codes its own span; offsets cross hosts.

The reference has no distributed layer (SURVEY §2.3); the analog here for a
codec is process-level data parallelism: a framed stream is a
concatenation of self-delimiting chunks, so each host compresses /
decompresses its local span independently (on its local devices or cores)
and only the **compressed span lengths** cross hosts — one tiny all-gather —
to place every span at its exact global offset.

Usage (same program on every host):

    from snappy_tpu.parallel import multihost
    multihost.initialize()                  # jax.distributed (env-driven)
    blob, off, total = multihost.compress_framed_span(local_bytes)
    # write `blob` at byte offset `off` of the shared output (first host
    # prepends the stream header); the result is one valid framed stream.

Decoding is symmetric: `scan_frames` is cheap (headers only), each host
takes an interleaved slice of chunks.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .. import engine
from ..formats import constants as C
from ..formats import framing


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed (no-op if already initialized).

    With no arguments, relies on the environment (a cluster JAX detects, or
    the JAX_COORDINATOR_* variables); where nothing describes the cluster,
    pass ``coordinator_address``, ``num_processes`` and ``process_id``.
    """
    import jax

    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:  # already initialized
        if "already" not in str(e).lower():
            raise


def _allgather_lengths(local_len: int) -> np.ndarray:
    """All-gather one int64 per process (crosses hosts on multi-host)."""
    import jax
    from jax.experimental import multihost_utils

    if jax.process_count() == 1:
        return np.array([local_len], dtype=np.int64)
    return np.asarray(
        multihost_utils.process_allgather(np.int64(local_len))
    ).reshape(-1)


def compress_framed_span(
    local_data: bytes, backend: Optional[str] = None, with_header: bool = False
) -> Tuple[bytes, int, int]:
    """Compress this host's span of a logically-concatenated payload.

    Every participating process calls this with its own span (spans must be
    64 KiB multiples except the last host's).  Returns
    ``(blob, global_offset, total_len)``: writing each host's ``blob`` at
    ``global_offset`` yields one valid framed stream equal to compressing
    the concatenated payload.  With ``with_header=True`` process 0's blob
    includes the 10-byte stream header; with ``with_header=False`` every
    offset leaves room for the header, which the caller writes at offset 0.
    """
    import jax

    blob = engine.framed_compress(local_data, with_header=False, backend=backend)
    lens = _allgather_lengths(len(blob))
    pid = jax.process_index()
    offset = int(lens[:pid].sum()) + len(C.FRAMING_HEADER)
    total = int(lens.sum()) + len(C.FRAMING_HEADER)
    if with_header:
        if pid == 0:
            blob = C.FRAMING_HEADER + blob
            offset = 0
    return blob, offset, total


def uncompress_framed_span(
    data: bytes, backend: Optional[str] = None
) -> Tuple[Optional[bytes], int, int, str]:
    """Decode this host's share of a framed stream.

    All hosts scan the (cheap) chunk table; host ``p`` of ``n`` decodes the
    contiguous chunk range ``p*k..(p+1)*k`` and returns
    ``(payload, out_offset, total_out, reason)`` — its bytes belong at
    ``out_offset`` in the decoded output.
    """
    import jax

    if not framing.is_snappy_framed_stream(data):
        return None, 0, 0, "invalid"
    chunks = framing.scan_frames(data, len(C.FRAMING_HEADER))
    if chunks is None:
        return None, 0, 0, "invalid"
    n_proc = jax.process_count()
    pid = jax.process_index()
    per = -(-len(chunks) // n_proc)
    mine = chunks[pid * per : (pid + 1) * per]
    out_offset = sum(c.uncompressed_len for c in chunks[: pid * per])
    total = sum(c.uncompressed_len for c in chunks)
    if not mine:
        return b"", out_offset, total, "ok"
    outs, reason = engine.framed_uncompress_chunks(data, mine, backend=backend)
    if outs is None:
        return None, 0, 0, reason
    return b"".join(outs), out_offset, total, "ok"
