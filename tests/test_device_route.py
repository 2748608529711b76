"""The device route's decode behaviours, checked against the oracle.

Each case builds raw streams, decodes them through the device route
(``engine`` with ``backend="device"``: slabs of 64 KiB chunks, the chunk
decoder the platform picks -- the plain XLA decoder here), and through the
host codec, and holds both to ``testing/oracle.py``: the same bytes when the
oracle accepts, a rejection when it does not.  The cases are the stream
shapes a hand-written chunk decoder gets wrong: copy emission at every
offset, length and alignment; near copies at the stream head and at 64 KiB
boundaries; run-length patterns; long literals; streams spanning many
blocks; malformed and mutated streams; and copies that reach across a block
boundary, which force the whole-stream path.
"""

import random

import numpy as np
import pytest

import snappy_tpu as s
from snappy_tpu import engine
from snappy_tpu.formats import varint
from snappy_tpu.ops import host_codec
from snappy_tpu.testing import oracle

from test_oracle import MALFORMED_RAW


def lit(data: bytes) -> bytes:
    n = len(data) - 1
    if n < 60:
        return bytes([n << 2]) + data
    if n < 256:
        return bytes([60 << 2, n]) + data
    if n < 65536:
        return bytes([61 << 2]) + n.to_bytes(2, "little") + data
    return bytes([63 << 2]) + n.to_bytes(4, "little") + data


def copy1(off: int, ln: int) -> bytes:
    assert 4 <= ln <= 11 and off < 2048
    return bytes([((off >> 8) << 5) | ((ln - 4) << 2) | 1, off & 255])


def copy2(off: int, ln: int) -> bytes:
    return bytes([((ln - 1) << 2) | 2]) + off.to_bytes(2, "little")


def copy4(off: int, ln: int) -> bytes:
    return bytes([((ln - 1) << 2) | 3]) + off.to_bytes(4, "little")


def stream(body: bytes, declared: int) -> bytes:
    return varint.encode_uint32(declared) + body


def tile(period: int, seed: int, n: int) -> bytes:
    t = random.Random(seed).randbytes(period)
    return (t * (n // period + 1))[:n]


def check(streams):
    """Device route and host codec agree with the oracle on every stream."""
    dev = engine.raw_uncompress_batch(streams, backend="device")
    for k, (data, (got, reason)) in enumerate(zip(streams, dev)):
        ref, err = oracle.uncompress(data)
        if err is None:
            assert reason == "ok" and got == ref, k
        else:
            assert got is None and reason == "invalid", k
        if host_codec.available():
            h, _ = engine.raw_uncompress(data, backend="host")
            assert h == (ref if err is None else None), k


def check_payloads(payloads):
    check([s.encode(p) for p in payloads])


# ---------------------------------------------------------------------------
# Copy emission: offset x length x destination alignment
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("off", [1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 31, 32, 33])
def test_emit_edge_matrix(off):
    rng = random.Random(off)
    streams = []
    for clen in (1, 4, 5, 8, 9, 12, 16, 17, 31, 32, 33, 64):
        for align in (1, 2, 3, 4, 5):
            head = bytes(rng.randrange(1, 256) for _ in range(max(off, align)))
            tail = bytes(rng.randrange(1, 256) for _ in range(3))
            body = lit(head) + copy2(off, clen) + lit(tail)
            streams.append(stream(body, len(head) + clen + 3))
    check(streams)


@pytest.mark.parametrize(
    "body",
    [
        lit(b"a") + copy1(1, 4),                       # w=1, off=1
        lit(b"ab") + copy2(2, 6),                      # w=2, off=2
        lit(b"a") + copy2(1, 2) + copy2(3, 5),         # chained tiny copies
        lit(b"a") + copy2(1, 1) * 40,                  # 1-byte copies
    ],
    ids=["off1", "off2", "chained", "one_byte_copies"],
)
def test_near_copy_at_stream_head(body):
    want, err = oracle.decode_all_tags(body, 1 << 20)
    assert err is None
    check([stream(body, len(want))])


def test_near_copies_at_block_boundaries():
    r = random.Random(61)
    parts, total = [], 0
    while total < 2 * 65536 + 500:
        chunk = r.randbytes(r.randrange(40, 200))
        rep = b"zx"[: 1 + r.randrange(2)] * r.randrange(30, 300)
        parts += [chunk, rep]
        total += len(chunk) + len(rep)
    check_payloads([b"".join(parts)])


# ---------------------------------------------------------------------------
# Run-length patterns
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "payload",
    [b"\xab" * 50000, b"ab" * 25000, b"abc" * 16000, b"x" + b"ab" * 25000,
     b"xy" + b"ba" * 25000 + b"tail"],
    ids=["off1", "off2", "off3", "off2_odd", "off2_even_tail"],
)
def test_rle_near_offsets(payload):
    check_payloads([payload])


@pytest.mark.parametrize("period", [5, 7])
def test_overlapping_periods(period):
    check_payloads([tile(period, period, 60000)])


@pytest.mark.parametrize("period", [4, 8, 16, 128, 1024, 4096, 8192, 12288])
def test_power_of_two_and_page_periods(period):
    check_payloads([tile(period, period, 64000)])


@pytest.mark.parametrize("period", [100, 3000, 5000])
def test_other_periods(period):
    check_payloads([tile(period, period, 60000)])


def test_varying_length_same_offset_run():
    r = random.Random(31)
    body = lit(r.randbytes(300))
    for i in range(600):
        body += copy2(200, (7 * i) % 63 + 2)
    body += lit(r.randbytes(40))
    for i in range(200):
        body += copy2(5000, (11 * i) % 60 + 4)
    want, err = oracle.decode_all_tags(body, 1 << 20)
    assert err is None
    check([stream(body, len(want))])


def test_far_offset_run_and_interrupted_runs():
    r = random.Random(21)
    check_payloads([
        (bytes(range(128)) * 400)[:48000],
        b"\x55" * 20000 + r.randbytes(200) + b"\x77" * 20000
        + r.randbytes(64) + bytes(range(64)) * 300,
    ])


# ---------------------------------------------------------------------------
# Long literals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "parts",
    [
        [("lit", 4090), ("lit", 40000)],
        [("lit", 4087), ("copy", 100, 9), ("lit", 40000)],
        [("lit", 1)] + [("copy", 1, 64)] * 63 + [("lit", 40000)],
        [("lit", 5000)] + [("copy", 4000, 64)] * 220,
        [("lit", 8000), ("copy", 500, 30), ("lit", 6000), ("copy", 4000, 64),
         ("lit", 12000), ("copy", 2, 17), ("lit", 9000)],
    ],
    ids=["two_literals", "after_copy", "after_near_copies", "then_copies", "mixed"],
)
def test_long_literals(parts):
    r = random.Random(len(parts))
    body = b""
    for p in parts:
        body += lit(r.randbytes(p[1])) if p[0] == "lit" else copy2(p[1], p[2])
    want, err = oracle.decode_all_tags(body, 1 << 20)
    assert err is None
    check([stream(body, len(want))])


# ---------------------------------------------------------------------------
# Streams over many 64 KiB blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "payload",
    [
        b"a" * 140_000,
        (b"the quick brown fox jumps over the lazy dog. " * 4000)[:140_000],
        random.Random(9).randbytes(100_000),
        b"q" * 65535,
        b"q" * 65536,
        b"q" * 65537,
        b"q" * 131072,
    ],
    ids=["rle", "text", "incompressible", "65535", "65536", "65537", "131072"],
)
def test_multi_block_streams(payload):
    check_payloads([payload])


def test_block_class_transitions():
    r = random.Random(33)
    text = (b"the quick brown fox jumps over the lazy dog. " * 40
            + b"she sells sea shells by the sea shore. " * 30)
    payload = (text * 60 + r.randbytes(200000) + b"\x00" * 220000
               + text * 60)[: 8 * 65536 + 12345]
    check_payloads([payload])


def test_single_giant_literal_tag():
    """One literal tag over several blocks: legal, never emitted by a block
    encoder, and unsplittable -- the whole-stream decoder takes it."""
    payload = random.Random(31).randbytes(200_000)
    check([stream(lit(payload), len(payload))])


# ---------------------------------------------------------------------------
# Copies that reach across a 64 KiB block boundary (unsplittable streams)
# ---------------------------------------------------------------------------


def _far_copy_stream(base_len, copies):
    rng = random.Random(base_len)
    base = rng.randbytes(base_len)
    body = b"".join(lit(base[i : i + 60_000]) for i in range(0, base_len, 60_000))
    out = bytearray(base)
    for off, ln in copies:
        body += copy4(off, ln)
        for _ in range(ln):
            out.append(out[-off])
    return stream(body, len(out)), bytes(out)


@pytest.mark.parametrize(
    "base_len,copies",
    [
        (180_000, [(170_001, 64), (131_073, 17), (179_999, 7), (165_537, 64)]),
        (140_000, [(131_072 + (k * 97) % 8000, 4 + k % 61) for k in range(400)]),
        (131_060, [(70_000, 40)]),    # straddles the 131072 block boundary
        (196_600, [(150_000, 20)]),   # far, and straddles 196608
    ],
    ids=["depths", "dense", "straddle", "far_straddle"],
)
def test_far_copies_across_blocks(base_len, copies):
    data, want = _far_copy_stream(base_len, copies)
    (got, reason), = engine.raw_uncompress_batch([data], backend="device")
    assert reason == "ok" and got == want
    check([data])


@pytest.mark.skipif(not host_codec.available(), reason="native host codec unavailable")
def test_copy_into_previous_block_takes_whole_stream_path():
    """Block-aligned ops, but block 2 opens with a copy into block 1: every
    split segment is valid alone except that one, so the split must defer
    to the whole-stream decoder rather than report invalid."""
    first = bytes(range(256)) * 256
    body = lit(first) + copy2(4, 8) + lit(b"this is the tail literal 123")
    want = first + first[-4:] * 2 + b"this is the tail literal 123"
    assert host_codec.scan_raw_blocks(body, len(want)) is not None
    check([stream(body, len(want))])


# ---------------------------------------------------------------------------
# Malformed and mutated streams
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("idx", range(len(MALFORMED_RAW)))
def test_malformed_vectors(idx):
    out, reason = engine.raw_uncompress(MALFORMED_RAW[idx], backend="device")
    assert out is None and reason == "invalid"
    check([MALFORMED_RAW[idx]])


@pytest.mark.parametrize(
    "case", ["garbage", "truncated", "declared_plus", "declared_minus", "wrap"]
)
def test_multi_block_invalid_endings(case):
    payload = (b"invalid termination payload " * 4000)[:100_000]
    enc = s.encode(payload)
    _, v = varint.decode_uint32(enc)
    body = enc[v:]
    data = {
        "garbage": stream(body + b"\x00", len(payload)),
        "truncated": stream(body[:-5], len(payload)),
        "declared_plus": stream(body, len(payload) + 1),
        "declared_minus": stream(body, len(payload) - 1),
        # literal whose 4-byte length wraps int32, ahead of a valid stream
        "wrap": stream(bytes([0xFC, 0xFF, 0xFF, 0xFF, 0x7F]) + body, len(payload)),
    }[case]
    (got, reason), = engine.raw_uncompress_batch([data], backend="device")
    assert got is None and reason == "invalid"
    check([data])


@pytest.mark.parametrize("seed", range(4))
def test_mutant_decisions(seed):
    rng = random.Random(seed)
    payload = (b"the quick brown fox jumps over the lazy dog. " * 20)
    base = s.encode(payload)
    mutants = []
    for _ in range(24):
        b = bytearray(base)
        for _ in range(rng.randrange(1, 3)):
            i = rng.randrange(1, len(b))
            b[i] ^= 1 << rng.randrange(8)
        mutants.append(bytes(b))
    check(mutants)


@pytest.mark.parametrize("kind", ["rle", "period96", "multi_block"])
def test_run_region_mutants(kind):
    payload = {
        "rle": b"\x00" * 60000,
        "period96": (bytes(range(96)) * 700)[:60000],
        "multi_block": (b"windowed mutation fuzz payload " * 5000)[:140_000],
    }[kind]
    base = s.encode(payload)
    rng = random.Random(17)
    mutants = [base[:-2]]
    for _ in range(8):
        b = bytearray(base)
        b[rng.randrange(8, len(b))] ^= 1 << rng.randrange(8)
        mutants.append(bytes(b))
    check(mutants)


def test_batch_isolates_malformed_stream():
    good = b"isolated good stream " * 30
    big = (b"multi block neighbour " * 7000)[:150_000]
    streams = [s.encode(good), stream(b"\xff", 100), s.encode(big),
               stream(b"\x00", 5), s.encode(good)]
    res = engine.raw_uncompress_batch(streams, backend="device")
    assert res[0] == (good, "ok") and res[2] == (big, "ok") and res[4] == (good, "ok")
    assert res[1] == (None, "invalid") and res[3] == (None, "invalid")


def test_framed_batch_isolates_bad_chunk_error_order():
    """Two bad chunks in one slab: the earlier one's reason wins."""
    from snappy_tpu.formats import constants as C
    from snappy_tpu.formats import framing
    from snappy_tpu.ops import crc32c_native

    def chunk(payload, body, crc_xor=0):
        crc = crc32c_native.masked_crc32c(payload) ^ crc_xor
        blob = crc.to_bytes(4, "little") + body
        return framing.encode_frame_header(C.CHUNK_COMPRESSED, len(blob)) + blob

    p = b"framed isolation payload " * 100
    good = s.encode(p)
    bad_tags = varint.encode_uint32(len(p)) + b"\xff"
    data = (C.FRAMING_HEADER + chunk(p, good) + chunk(p, good, crc_xor=1)
            + chunk(p, bad_tags) + chunk(p, good))
    assert engine.framed_uncompress(data, backend="device") == (None, "crc")
    data = (C.FRAMING_HEADER + chunk(p, good) + chunk(p, bad_tags)
            + chunk(p, good, crc_xor=1))
    assert engine.framed_uncompress(data, backend="device") == (None, "invalid")


# ---------------------------------------------------------------------------
# Encoder: levels and cross-decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("level", [1, 2])
def test_device_encode_levels_cross_decode(level):
    """The device encoder has one level: level=2 gives level 1's bytes.
    Its streams decode on the host codec, the oracle and the device."""
    payload = (b"two way buckets " * 6000)[:90_000]
    enc = engine.raw_compress(payload, backend="device", level=level)
    assert enc == engine.raw_compress(payload, backend="device", level=1)
    assert oracle.uncompress(enc) == (payload, None)
    assert engine.raw_uncompress(enc, backend="device") == (payload, "ok")
    if host_codec.available():
        assert engine.raw_uncompress(enc, backend="host") == (payload, "ok")
    framed = engine.framed_compress(payload, backend="device", level=level)
    assert engine.framed_uncompress(framed, backend="device") == (payload, "ok")


@pytest.mark.skipif(not host_codec.available(), reason="native host codec unavailable")
@pytest.mark.parametrize("level", [1, 2])
def test_host_levels_decode_on_device(level):
    payload = (b"level two round trip " * 700)[:14000] + tile(8, 3, 50000)
    enc = engine.raw_compress(payload, backend="host", level=level)
    assert engine.raw_uncompress(enc, backend="device") == (payload, "ok")
    framed = engine.framed_compress(payload, backend="host", level=level)
    assert engine.framed_uncompress(framed, backend="device") == (payload, "ok")


def test_encode_batch_matches_single_encodes():
    rng = np.random.default_rng(5)
    payloads = [rng.integers(0, 4, int(n), dtype=np.uint8).tobytes()
                for n in (0, 1, 200, 65536, 65537, 140_000)]
    batch = engine.raw_compress_batch(payloads, backend="device")
    assert batch == [engine.raw_compress(p, backend="device") for p in payloads]
    assert [oracle.uncompress(e)[0] for e in batch] == payloads


@pytest.mark.parametrize("n", [0, 1, 65535, 65536, 65537, 200_000])
def test_masked_crc32c_device_any_length(n):
    """The device CRC covers one 64 KiB chunk; longer buffers (an oversized
    chunk the resumable walk checks before rejecting it) use the native CRC."""
    from snappy_tpu.ops import crc32c_native

    data = random.Random(n).randbytes(n)
    assert engine.masked_crc32c(data, backend="device") == crc32c_native.masked_crc32c(data)
