"""Host <-> device orchestration: slab packing, shape bucketing, assembly.

The reference's L3 layer does buffer management and block/frame assembly
around its codec (snappy.nim:27-290).  Here the same role means: pack
variable-length payloads into static jit shapes (slabs of at most 512
64 KiB rows, row counts and widths bucketed to bound recompiles), send each
slab to the device in one dispatch, and assemble ragged outputs on the host.

Device kernels, one per operation: the chunk decoder is the CUDA kernel
(``ops/decode_cuda.py``) on a GPU and the plain XLA decoder
(``ops/decode_jax.py``) on the CPU backend -- chosen from the platform in
:func:`_chunk_kernel`; block encode is ``ops/encode_jax.py`` and CRC32C is
``ops/crc32c_jax.py`` everywhere.

All functions take/return numpy; nothing here raises on malformed input —
callers get (value, ok) style results, converted by the API layer.
"""

from __future__ import annotations

import functools
from typing import Iterator, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import config
from .formats import constants as C
from .formats import framing, varint
from .ops import crc32c_jax, decode_jax, encode_jax, host_codec

_BLOCK = C.MAX_BLOCK_LEN  # 65536
# Per-block compressed budget: worst case max_compressed_len(65536)=76490,
# rounded to a multiple of 128.
_MAX_COMP_BLOCK = -(-C.max_compressed_len(_BLOCK) // 128) * 128
_SLAB = 512  # rows per device dispatch


def _bucket(n: int, lo: int = 4096) -> int:
    """Next power of two >= max(n, lo) — bounds distinct compile shapes."""
    n = max(n, lo)
    return 1 << (n - 1).bit_length()


def _nb_slab(n: int) -> int:
    """Row bucket of a slab of ``n`` <= 512 rows: few distinct compile
    shapes, and no 8-row padding for the one-block calls of small payloads."""
    for b in (1, 8, 32, 128):
        if n <= b:
            return b
    return _SLAB


def _comp_width(max_body: int) -> int:
    """Compressed row width for a slab: a power-of-two bucket, capped at the
    encoder bound when every body fits under it (any legal block does)."""
    if max_body <= _MAX_COMP_BLOCK:
        return min(_bucket(max_body, lo=1024), _MAX_COMP_BLOCK)
    return _bucket(max_body)


def _chunk_kernel() -> str:
    """The chunk decoder for the default JAX backend: the CUDA kernel on a
    GPU, the plain XLA decoder on the CPU.  There is no other route."""
    platform = jax.default_backend()
    if platform == "gpu":
        return "cuda"
    if platform == "cpu":
        return "xla"
    raise RuntimeError(f"no chunk decoder for platform {platform!r}")


def _decode_rows(comp_u8, comp_lens, out_lens, kernel: str):
    """Decode rows of independent tag streams (<= 64 KiB output each).
    Returns (out uint8 [n, 65536] zeroed past each row's output, ok bool [n],
    written int32 [n])."""
    if kernel == "cuda":
        from .ops import decode_cuda

        return decode_cuda.decode_chunks(comp_u8, comp_lens, out_lens)
    return decode_jax.decode_chunks(
        comp_u8.astype(jnp.int32), comp_lens, out_lens, _BLOCK
    )


@functools.partial(jax.jit, static_argnames=("kernel", "with_crc"))
def _decode_step(comp_u8, comp_lens, out_lens, *, kernel: str, with_crc: bool):
    """One slab: chunk decode, plus the masked CRC32C of each decoded row."""
    out, ok, written = _decode_rows(comp_u8, comp_lens, out_lens, kernel)
    crcs = None
    if with_crc:
        crcs = crc32c_jax.masked_crc32c_chunks(out.astype(jnp.int32), out_lens, _BLOCK)
    return out, ok, written, crcs


@functools.partial(jax.jit, static_argnames=("with_crc",))
def _encode_step(blocks_u8, blens, *, with_crc: bool):
    """One slab: block encode, plus the masked CRC32C of each input block."""
    blocks = blocks_u8.astype(jnp.int32)
    enc, totals = encode_jax.encode_blocks(blocks, blens, _MAX_COMP_BLOCK)
    crcs = None
    if with_crc:
        crcs = crc32c_jax.masked_crc32c_chunks(blocks, blens, _BLOCK)
    return enc, totals, crcs


@functools.partial(jax.jit, static_argnums=(3,))
def _decode_raw_u8(comp_u8, comp_len, out_len, u_pad: int):
    """Whole-stream plain decode, for raw streams that cannot be split."""
    return decode_jax.decode_raw(comp_u8.astype(jnp.int32), comp_len, out_len, u_pad)


@functools.partial(jax.jit, static_argnums=(2,))
def _crc_chunks_device(chunks_u8, lens, width: int):
    """Masked CRC32C of byte chunks on-device (crc32c_jax)."""
    return crc32c_jax.masked_crc32c_chunks(chunks_u8.astype(jnp.int32), lens, width)


# ---------------------------------------------------------------------------
# Slab packing (host side of the device boundary)
# ---------------------------------------------------------------------------


def pack_rows(
    bodies: Sequence, declared: Sequence[int], rows: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack tag streams into one slab: (comp uint8 [rows, width], comp_lens
    int32 [rows], out_lens int32 [rows]).  Rows past ``len(bodies)`` are
    padding (length 0, never ok)."""
    width = _comp_width(max((len(b) for b in bodies), default=0))
    comp = np.zeros((rows, width), np.uint8)
    comp_lens = np.zeros((rows,), np.int32)
    out_lens = np.zeros((rows,), np.int32)
    for k, body in enumerate(bodies):
        comp[k, : len(body)] = np.frombuffer(body, np.uint8)
        comp_lens[k] = len(body)
        out_lens[k] = declared[k]
    return comp, comp_lens, out_lens


def _decode_slabs(
    bodies: Sequence, declared: Sequence[int], with_crc: bool
) -> Iterator[Tuple[int, np.ndarray, np.ndarray, Optional[np.ndarray]]]:
    """Decode chunks (declared <= 64 KiB each) in slabs of <= 512 rows, one
    dispatch each.  Yields (first index, out, ok, crcs) per slab in order,
    so a caller that stops at the first bad chunk skips the rest."""
    kernel = _chunk_kernel()
    for lo in range(0, len(bodies), _SLAB):
        sub = bodies[lo : lo + _SLAB]
        comp, comp_lens, out_lens = pack_rows(
            sub, declared[lo : lo + _SLAB], _nb_slab(len(sub))
        )
        out, ok, _written, crcs = _decode_step(
            jnp.asarray(comp), jnp.asarray(comp_lens), jnp.asarray(out_lens),
            kernel=kernel, with_crc=with_crc,
        )
        yield lo, np.asarray(out), np.asarray(ok), (
            np.asarray(crcs) if with_crc else None
        )


def _encode_slabs(
    blocks: np.ndarray, blens: np.ndarray, with_crc: bool
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Encode 64 KiB blocks in slabs of <= 512 rows, one dispatch each.
    Returns (enc uint8 [nb, width], totals [nb], crcs [nb] or None)."""
    nb = blocks.shape[0]
    enc_l, tot_l, crc_l = [], [], []
    for lo in range(0, nb, _SLAB):
        fr, fl = blocks[lo : lo + _SLAB], blens[lo : lo + _SLAB]
        rows = _nb_slab(len(fl))
        if rows != len(fl):
            fr = np.vstack([fr, np.zeros((rows - len(fl), _BLOCK), np.uint8)])
            fl = np.concatenate([fl, np.zeros((rows - len(fl),), np.int32)])
        enc, totals, crcs = _encode_step(
            jnp.asarray(fr), jnp.asarray(fl), with_crc=with_crc
        )
        k = min(_SLAB, nb - lo)
        enc_l.append(np.asarray(enc)[:k])
        tot_l.append(np.asarray(totals)[:k])
        if with_crc:
            crc_l.append(np.asarray(crcs)[:k])
    return (
        np.concatenate(enc_l),
        np.concatenate(tot_l),
        np.concatenate(crc_l) if with_crc else None,
    )


def _use_host(backend: Optional[str]) -> bool:
    """True for the host route; the device route first points JAX at the
    persistent compilation cache."""
    if (backend or config.resolve_backend()) == "host" and host_codec.available():
        return True
    config.ensure_compilation_cache()
    return False


# ---------------------------------------------------------------------------
# Raw format
# ---------------------------------------------------------------------------


def _split_blocks(data: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    n = len(data)
    nb = max(1, -(-n // _BLOCK))
    blocks = np.zeros((nb * _BLOCK,), dtype=np.uint8)
    blocks[:n] = data
    blens = np.full((nb,), _BLOCK, dtype=np.int32)
    blens[-1] = n - (nb - 1) * _BLOCK
    return blocks.reshape(nb, _BLOCK), blens


def raw_compress(
    data: bytes, backend: Optional[str] = None, level: int = 1
) -> Optional[bytes]:
    """Raw-format compress: varint header + concatenated block tag streams
    (contract parity: snappy.nim:27-64).

    ``backend``: "device" | "host" | None (= resolve the configured default).
    Both backends produce valid, cross-decodable streams; exact bytes differ
    (the reference's own tests accept the same across implementations,
    test_snappy.nim:50-53).  ``level`` applies to the host backend; the
    device encoder has one level.
    """
    if _use_host(backend):
        return host_codec.raw_compress(data, level)
    return raw_compress_batch([data], backend="device")[0]


def raw_compress_batch(
    datas: List[bytes], backend: Optional[str] = None, level: int = 1
) -> List[Optional[bytes]]:
    """Compress many independent payloads with ONE device dispatch per
    512-block slab: blocks of ALL payloads share the slabs, so many small
    payloads amortize the dispatch exactly like one large one.

    Returns one stream (or None for oversized input) per payload, each
    byte-identical to :func:`raw_compress` of that payload alone (the
    block split is per payload, so batching cannot change the bytes)."""
    if _use_host(backend):
        return [host_codec.raw_compress(d, level) for d in datas]

    results: List[Optional[bytes]] = [None] * len(datas)
    spans = []  # (result index, first block, number of blocks, length)
    blocks_l, blens_l = [], []
    nb = 0
    for i, data in enumerate(datas):
        n = len(data)
        if n > C.MAX_UNCOMPRESSED_LEN:
            continue  # None: oversized (raw_compress contract)
        if n == 0:
            results[i] = varint.encode_uint32(0)  # exactly [0x00]
            continue
        blocks, blens = _split_blocks(np.frombuffer(data, dtype=np.uint8))
        spans.append((i, nb, len(blens), n))
        blocks_l.append(blocks)
        blens_l.append(blens)
        nb += len(blens)
    if not spans:
        return results
    enc, totals, _ = _encode_slabs(
        np.concatenate(blocks_l), np.concatenate(blens_l), with_crc=False
    )
    for i, first, count, n in spans:
        results[i] = varint.encode_uint32(n) + b"".join(
            enc[k, : totals[k]].tobytes() for k in range(first, first + count)
        )
    return results


def raw_uncompress(
    data: bytes,
    max_size: int = C.MAX_UNCOMPRESSED_LEN,
    backend: Optional[str] = None,
) -> Tuple[Optional[bytes], str]:
    """Raw-format uncompress.  Returns (payload, "ok") or (None, reason);
    reason in {"invalid", "too_large"} (parity: snappy.nim:84-128)."""
    if _use_host(backend):
        return host_codec.raw_uncompress(data, max_size)
    return raw_uncompress_batch([data], max_size, backend="device")[0]


def _decode_whole_stream(body: bytes, declared: int) -> Tuple[Optional[bytes], str]:
    """Plain whole-stream decode: the route for raw streams that cannot be
    split at 64 KiB block boundaries, and the authority on any stream whose
    split segments fail."""
    c_pad = _bucket(len(body))
    comp = np.zeros((c_pad,), dtype=np.uint8)
    comp[: len(body)] = np.frombuffer(body, np.uint8)
    out, ok, _written = _decode_raw_u8(
        jnp.asarray(comp), jnp.int32(len(body)), jnp.int32(declared),
        _bucket(declared),
    )
    if not bool(ok):
        return None, "invalid"
    return np.asarray(out)[:declared].tobytes(), "ok"


def raw_uncompress_batch(
    datas: List[bytes],
    max_size: int = C.MAX_UNCOMPRESSED_LEN,
    backend: Optional[str] = None,
) -> List[Tuple[Optional[bytes], str]]:
    """Decode many independent raw streams with ONE device dispatch per
    512-row chunk slab.

    Streams of any size ride the chunk slab: one-block streams directly,
    larger ones split at their 64 KiB output-block boundaries by the native
    tag scan (``host_codec.scan_raw_blocks`` proves no op straddles a
    boundary; the chunk decoder's offset <= written check proves no copy
    reaches across one -- the same split the host block-parallel decoder
    uses).  Streams that cannot be split decode whole.  Returns one
    (payload|None, reason) pair per input, same contracts as
    :func:`raw_uncompress`."""
    if _use_host(backend):
        return [host_codec.raw_uncompress(d, max_size) for d in datas]

    results: List[Optional[Tuple[Optional[bytes], str]]] = [None] * len(datas)
    bodies: List[bytes] = []   # one entry per chunk job
    decls: List[int] = []
    owner: List[int] = []      # result index of each chunk job
    wholes = {}                # result index -> (body, declared)
    for i, data in enumerate(datas):
        data = bytes(data)
        # Sizing scan accepts uint64 varints (codec.nim:129-138); the decode
        # itself enforces the stricter 5-byte uint32 rule (snappy.nim:92).
        declared64, _ = varint.decode_uint64(data)
        if declared64 is None or declared64 > C.MAX_UNCOMPRESSED_LEN:
            results[i] = (None, "invalid")
            continue
        if declared64 > max_size:
            results[i] = (None, "too_large")
            continue
        declared, read = varint.decode_uint32(data)
        if declared is None:
            results[i] = (None, "invalid")
            continue
        body = data[read:]
        if declared == 0 or not body:
            ok = declared == 0 and not body
            results[i] = (b"", "ok") if ok else (None, "invalid")
            continue
        offs = [0, len(body)] if declared <= _BLOCK else (
            host_codec.scan_raw_blocks(body, declared)
        )
        if offs is None:
            wholes[i] = (body, declared)
            continue
        for k in range(len(offs) - 1):
            bodies.append(body[offs[k] : offs[k + 1]])
            decls.append(min(_BLOCK, declared - k * _BLOCK))
            owner.append(i)

    parts = {}  # result index -> decoded segments, None once one fails
    for lo, out, ok, _ in _decode_slabs(bodies, decls, with_crc=False):
        for k in range(min(_SLAB, len(bodies) - lo)):
            i = owner[lo + k]
            segs = parts.setdefault(i, [])
            if segs is None:
                continue
            if ok[k]:
                segs.append(out[k, : decls[lo + k]].tobytes())
            else:
                parts[i] = None
    for i, segs in parts.items():
        if segs is not None:
            results[i] = (b"".join(segs), "ok")
        else:
            # A segment failed its in-chunk validation: either the stream is
            # malformed or a legal copy reaches across a block boundary (no
            # block encoder emits one).  The whole-stream decoder decides.
            body_i = bytes(datas[i])
            declared, read = varint.decode_uint32(body_i)
            wholes[i] = (body_i[read:], declared)
    for i, (body, declared) in wholes.items():
        results[i] = _decode_whole_stream(body, declared)
    return results  # type: ignore[return-value]


# ---------------------------------------------------------------------------
# Framed format
# ---------------------------------------------------------------------------


def framed_compress(
    data: bytes,
    with_header: bool = True,
    backend: Optional[str] = None,
    level: int = 1,
) -> Optional[bytes]:
    """Framed-format compress (contract parity: snappy.nim:130-155 and
    encoder.nim:385-426): per-64 KiB frame, masked CRC + compressed payload
    if it saves >= 1/8 of the frame, else the verbatim payload."""
    if _use_host(backend):
        return host_codec.framed_compress(data, with_header, level)
    n = len(data)
    parts: List[bytes] = [C.FRAMING_HEADER] if with_header else []
    if n == 0:
        return b"".join(parts)
    arr = np.frombuffer(data, dtype=np.uint8)
    frames, flens = _split_blocks(arr)
    enc, totals, crcs = _encode_slabs(frames, flens, with_crc=True)
    for k in range(frames.shape[0]):
        flen = int(flens[k])
        crc_bytes = int(crcs[k]).to_bytes(4, "little")
        blob = varint.encode_uint32(flen) + enc[k, : totals[k]].tobytes()
        # Keep the compressed form only if the encoded block alone (the
        # varint header excluded, exactly as the reference compares
        # blockLen at encoder.nim:408) saves >= 1/8 of the frame, and the
        # frame was big enough to try (encoder.nim:401-426).
        if flen >= C.MIN_NON_LITERAL_BLOCK_SIZE and int(totals[k]) <= flen - flen // 8:
            parts.append(
                framing.encode_frame_header(C.CHUNK_COMPRESSED, 4 + len(blob))
            )
            parts.append(crc_bytes)
            parts.append(blob)
        else:
            parts.append(
                framing.encode_frame_header(C.CHUNK_UNCOMPRESSED, 4 + flen)
            )
            parts.append(crc_bytes)
            parts.append(arr[k * _BLOCK : k * _BLOCK + flen].tobytes())
    return b"".join(parts)


def framed_uncompress_chunks(
    data: bytes,
    chunks: List[framing.ChunkInfo],
    check_integrity: bool = True,
    backend: Optional[str] = None,
) -> Tuple[Optional[List[bytes]], str]:
    """Decode a list of scanned chunks; returns (payload_per_chunk, "ok")
    or (None, reason) with reason in {"invalid", "crc", "unknown_chunk"}.

    Returns a list of byte segments whose in-order concatenation is the
    decoded payload (a single pre-assembled segment on both backends)."""
    if _use_host(backend):
        blob, reason = host_codec.framed_uncompress_scanned(
            data, chunks, check_integrity
        )
        if blob is None:
            return None, reason
        return [blob], "ok"
    total = sum(ch.uncompressed_len for ch in chunks)
    out_arr = np.empty((total,), dtype=np.uint8)
    written, reason = _framed_uncompress_device(
        data, chunks, check_integrity, out_arr
    )
    if written is None:
        return None, reason
    # One segment: per-chunk tobytes() + host join would copy every
    # decoded byte twice more.
    return [out_arr[:written].tobytes()], "ok"


def framed_uncompress_chunks_into(
    data: bytes,
    chunks: List[framing.ChunkInfo],
    out_arr: np.ndarray,
    check_integrity: bool = True,
    backend: Optional[str] = None,
) -> Tuple[Optional[int], str]:
    """Decode scanned chunks directly into ``out_arr`` at their final
    offsets (zero extra copies on either backend).  Returns
    (written, "ok") or (None, reason)."""
    if _use_host(backend):
        blob, reason = host_codec.framed_uncompress_scanned(
            data, chunks, check_integrity, out=out_arr
        )
        if blob is None:
            return None, reason
        return sum(ch.uncompressed_len for ch in chunks), "ok"
    return _framed_uncompress_device(data, chunks, check_integrity, out_arr)


def masked_crc32c(payload: bytes, backend: Optional[str] = None) -> int:
    """Masked CRC32C of one buffer on the configured backend: the device
    backend uses the device kernel (crc32c_jax, whose padding cancellation
    covers up to one 64 KiB chunk) for chunk-sized buffers; the host
    backend, a longer buffer, or a missing native lib uses crc32c_native's
    own fallback chain."""
    from .ops import crc32c_native

    if (backend or config.resolve_backend()) == "device" and len(payload) <= _BLOCK:
        config.ensure_compilation_cache()
        width = _bucket(max(len(payload), 1), lo=256)
        buf = np.zeros((1, width), dtype=np.uint8)
        buf[0, : len(payload)] = np.frombuffer(payload, dtype=np.uint8)
        lens = np.array([len(payload)], dtype=np.int32)
        return int(
            np.asarray(
                _crc_chunks_device(jnp.asarray(buf), jnp.asarray(lens), width)
            )[0]
        )
    return crc32c_native.masked_crc32c(payload)


def _framed_uncompress_device(
    data: bytes,
    chunks: List[framing.ChunkInfo],
    check_integrity: bool,
    out_arr: np.ndarray,
) -> Tuple[Optional[int], str]:
    """Device-backend chunk decode writing payloads at their final offsets
    in ``out_arr``.  Compressed chunks decode in 512-row slabs with the CRC
    of each decoded chunk computed in the same dispatch; uncompressed
    chunks' CRCs are batched on the device too (crc32c_jax) — the device
    backend's success path never calls the native host CRC (reference
    contract snappy.nim:231-233).  Semantics parity: snappy.nim:199-265.
    Returns (written, "ok") or (None, reason).
    """
    arr = np.frombuffer(data, dtype=np.uint8)

    # Error ORDER parity: the reference processes chunks strictly one at a
    # time (snappy.nim:199-265), so the error reported must belong to the
    # EARLIEST bad chunk.  The scan below stops at the first failure it
    # can see host-side; decode and CRC failures are found batched, so
    # every candidate error carries its chunk INDEX and the smallest one
    # wins at the end.
    deferred: Tuple[int, str] = (len(chunks), "")  # (chunk index, reason)
    comp_jobs = []  # (chunk_idx, out_offset, payload_slice, declared, crc)
    ucrc_jobs = []  # (chunk_idx, payload_slice, stored_crc)
    pos = 0
    for idx, ch in enumerate(chunks):
        if ch.id == C.CHUNK_COMPRESSED:
            if ch.data_len < 4:
                deferred = (idx, "invalid")
                break
            stored = int.from_bytes(
                data[ch.data_pos : ch.data_pos + 4], "little"
            )
            payload = arr[ch.data_pos + 4 : ch.data_pos + ch.data_len]
            declared, read = varint.decode_uint32(payload)
            if declared is None or declared > C.MAX_UNCOMPRESSED_FRAME_DATA_LEN:
                deferred = (idx, "invalid")
                break
            body = payload[read:]
            if declared == 0 or len(body) == 0:
                # An empty chunk decodes to nothing (its CRC is checked as
                # an empty payload); any other empty side is malformed.
                if declared != 0 or len(body) != 0:
                    deferred = (idx, "invalid")
                    break
                if check_integrity:
                    ucrc_jobs.append((idx, body, stored))
                continue
            comp_jobs.append((idx, pos, body, int(declared), stored))
            pos += int(declared)
        elif ch.id == C.CHUNK_UNCOMPRESSED:
            if ch.data_len < 4:
                deferred = (idx, "invalid")
                break
            stored = int.from_bytes(
                data[ch.data_pos : ch.data_pos + 4], "little"
            )
            payload = arr[ch.data_pos + 4 : ch.data_pos + ch.data_len]
            if len(payload) > C.MAX_UNCOMPRESSED_FRAME_DATA_LEN:
                deferred = (idx, "invalid")
                break
            if check_integrity:
                ucrc_jobs.append((idx, payload, stored))
            out_arr[pos : pos + len(payload)] = payload
            pos += len(payload)
        elif ch.id == C.CHUNK_STREAM_HEADER:
            pass
        elif ch.id < C.CHUNK_RESERVED_SKIPPABLE_LO:
            deferred = (idx, "unknown_chunk")
            break
        # reserved skippable: ignore payload

    err = deferred

    def consider(idx: int, reason: str):
        nonlocal err
        if idx < err[0]:
            err = (idx, reason)

    slabs = _decode_slabs(
        [j[2] for j in comp_jobs], [j[3] for j in comp_jobs], with_crc=True
    )
    for lo, out, ok, crcs in slabs:
        bad = False
        for k, (idx, off, _, declared, stored) in enumerate(
            comp_jobs[lo : lo + _SLAB]
        ):
            if not ok[k]:
                consider(idx, "invalid")
            elif check_integrity and int(crcs[k]) != stored:
                consider(idx, "crc")
            else:
                out_arr[off : off + declared] = out[k, :declared]
                continue
            bad = True
            break
        if bad:
            break

    # Uncompressed-chunk CRCs, batched on-device.  Only chunks EARLIER
    # than the current earliest error can still matter.
    ucrc_jobs = [j for j in ucrc_jobs if j[0] < err[0]]
    for lo in range(0, len(ucrc_jobs), _SLAB):
        sub = ucrc_jobs[lo : lo + _SLAB]
        slab = _nb_slab(len(sub))
        payloads = np.zeros((slab, _BLOCK), dtype=np.uint8)
        lens = np.zeros((slab,), dtype=np.int32)
        for k, (_, payload, _) in enumerate(sub):
            payloads[k, : len(payload)] = payload
            lens[k] = len(payload)
        got = np.asarray(
            _crc_chunks_device(jnp.asarray(payloads), jnp.asarray(lens), _BLOCK)
        )
        bad = [idx for k, (idx, _, stored) in enumerate(sub) if int(got[k]) != stored]
        if bad:
            consider(bad[0], "crc")
            break

    if err[0] < len(chunks):
        return None, err[1]
    return pos, "ok"


def framed_uncompress(
    data: bytes,
    max_size: int = C.MAX_UNCOMPRESSED_LEN,
    check_integrity: bool = True,
    require_header: bool = True,
    backend: Optional[str] = None,
) -> Tuple[Optional[bytes], str]:
    """Whole-stream framed decode.  Returns (payload, "ok") or (None,
    reason); reason in {"invalid", "crc", "unknown_chunk", "too_large"}."""
    start = 0
    if require_header:
        if not framing.is_snappy_framed_stream(data):
            return None, "invalid"
        start = len(C.FRAMING_HEADER)
    chunks = framing.scan_frames(data, start)
    if chunks is None:
        # Distinguish the unskippable-reserved case for error parity.
        return None, _scan_failure_reason(data, start)
    total = sum(c.uncompressed_len for c in chunks)
    if total > max_size:
        return None, "too_large"

    if _use_host(backend):
        return host_codec.framed_uncompress_scanned(data, chunks, check_integrity)

    out_arr = np.empty((total,), dtype=np.uint8)
    written, reason = _framed_uncompress_device(
        data, chunks, check_integrity, out_arr
    )
    if written is None:
        return None, reason
    return out_arr[:written].tobytes(), "ok"


def _scan_failure_reason(data: bytes, start: int) -> str:
    """Re-walk headers to classify a scan failure (invalid vs unknown chunk)."""
    n = len(data)
    read = start
    while n - read >= 4:
        cid, data_len = framing.decode_frame_header(data[read : read + 4])
        if n - read < data_len + 4:
            return "invalid"
        if (
            C.CHUNK_RESERVED_UNSKIPPABLE_LO
            <= cid
            <= C.CHUNK_RESERVED_UNSKIPPABLE_HI
        ):
            return "unknown_chunk"
        read += 4 + data_len
    return "invalid"
