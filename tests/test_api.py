"""Public-API tests: raw format (mirrors reference tests/test_snappy.nim)."""

import random

import pytest

import snappy_tpu as s
from snappy_tpu.formats import constants as C
from snappy_tpu.testing import corpus, oracle

from test_oracle import MALFORMED_RAW


class TestRawRoundtrip:
    @pytest.mark.parametrize(
        "payload",
        [
            b"",
            b"a",
            b"ab",
            b"hello world " * 100,
            bytes(range(256)) * 8,
            b"\x00" * 70000,  # multi-block RLE
        ],
    )
    def test_roundtrip(self, payload):
        enc = s.encode(payload)
        assert s.decode(enc) == payload
        # cross-decode with the sequential oracle
        dec, err = oracle.uncompress(enc)
        assert err is None and dec == payload

    def test_empty_is_single_zero(self):
        # Contract: test_snappy.nim:162-165
        assert s.encode(b"") == b"\x00"
        assert s.decode(b"\x00") == b""

    def test_oracle_encodes_we_decode(self):
        payload = b"differential " * 500
        assert s.decode(oracle.compress(payload)) == payload

    @pytest.mark.parametrize("m", [1, 2])
    @pytest.mark.parametrize("delta", [-5, -1, 0, 1, 5])
    def test_block_boundaries(self, m, delta):
        # Buffer sizes straddling the 64 KiB block limit
        # (test_snappy.nim:124-134).
        n = m * C.MAX_BLOCK_LEN + delta
        rng = random.Random(n)
        word = bytes(rng.getrandbits(8) for _ in range(13))
        payload = (word * (n // 13 + 1))[:n]
        enc = s.encode(payload)
        assert s.decode(enc) == payload
        dec, err = oracle.uncompress(enc)
        assert err is None and dec == payload

    def test_max_size_guard(self):
        payload = b"x" * 1000
        enc = s.encode(payload)
        assert s.decode(enc, max_size=999) == b""
        assert s.decode(enc, max_size=1000) == payload


class TestRawInto:
    def test_compress_into(self):
        payload = b"hello world " * 10
        buf = bytearray(C.max_compressed_len(len(payload)))
        res = s.compress_into(payload, buf)
        assert res.is_ok()
        assert s.decode(bytes(buf[: res.unwrap()])) == payload

    def test_compress_into_too_small(self):
        res = s.compress_into(b"hello", bytearray(3))
        assert res.is_err() and res.error == s.CodecError.buffer_too_small

    def test_uncompress_into(self):
        payload = b"data " * 200
        enc = s.encode(payload)
        buf = bytearray(len(payload))
        res = s.uncompress_into(enc, buf)
        assert res.is_ok() and res.unwrap() == len(payload)
        assert bytes(buf) == payload

    def test_uncompress_into_too_small(self):
        enc = s.encode(b"payload bytes here")
        res = s.uncompress_into(enc, bytearray(4))
        assert res.is_err() and res.error == s.CodecError.buffer_too_small


class TestRawMalformed:
    @pytest.mark.parametrize("idx", range(len(MALFORMED_RAW)))
    def test_malformed_empty(self, idx):
        assert s.decode(MALFORMED_RAW[idx]) == b""

    @pytest.mark.parametrize("name", corpus.BAD_FILES)
    def test_baddata(self, corpus_root, name):
        assert s.decode(corpus.read_data(name)) == b""

    def test_uncompress_into_malformed(self):
        res = s.uncompress_into(b"\x05\xff\xff", bytearray(16))
        assert res.is_err() and res.error == s.CodecError.invalid_input


class TestRawGoldenCorpus:
    def test_golden_decode(self, corpus_root):
        gold = corpus.read_data(corpus.GOLDEN_RAWSNAPPY)
        ref, err = oracle.uncompress(gold)
        assert err is None
        assert s.decode(gold) == ref

    @pytest.mark.parametrize("name", ["html", "Mark.Twain-Tom.Sawyer.txt"])
    def test_corpus_roundtrip_and_size(self, corpus_root, name):
        data = corpus.read_data(name)
        ref_size = len(oracle.compress(data))
        enc = s.encode(data)
        assert s.decode(enc) == data
        dec, err = oracle.uncompress(enc)
        assert err is None and dec == data
        # Default (host) backend: reference-algorithm-class sizes.
        assert len(enc) <= int(ref_size * 1.01)
        # Device backend: strictly no larger than the reference algorithm.
        from snappy_tpu import engine

        enc_dev = engine.raw_compress(data, backend="device")
        assert s.decode(enc_dev) == data
        assert len(enc_dev) <= ref_size

    def test_uncompressed_len(self, corpus_root):
        gold = corpus.read_data(corpus.GOLDEN_RAWSNAPPY)
        declared = s.uncompressed_len(gold)
        assert declared == len(s.decode(gold))


class TestDecodeBatch:
    """decode_batch: element-wise parity with decode() across sizes,
    failure modes, and the >128 KiB grid fallback (round-5 addition)."""

    def test_parity_with_decode(self):
        import numpy as np

        rng = np.random.default_rng(9)
        payloads = [
            b"",
            b"a",
            b"batch " * 500,                      # small text
            bytes(rng.integers(0, 256, 5000, np.uint8)),   # incompressible
            b"r" * 100_000,                        # RLE, ~100 KiB (batched)
            (b"mixed content " * 12000)[:150_000],  # > 128 KiB (fallback)
        ]
        encs = [s.encode(p) for p in payloads]
        bad = b"\x05\xff\xff"                      # truncated literal
        encs.insert(2, bad)
        singles = [s.decode(e) for e in encs]
        batch = s.decode_batch(encs)
        assert batch == singles
        assert batch[2] == b""                     # the malformed one

    def test_chunk_route_boundary(self):
        """Streams at exactly 64 KiB output ride the chunk-shaped slab;
        65537 B is the first big-window stream (engine.raw_uncompress_batch
        round-5 split). Both must match decode(), on both backends (the
        auto backend resolves to host, which bypasses the split)."""
        from snappy_tpu import engine

        payloads = [
            (b"edge case data " * 5000)[:65536],
            (b"edge case data " * 5000)[:65537],
            (b"Z" * 65536),
        ]
        encs = [s.encode(p) for p in payloads]
        assert s.decode_batch(encs) == payloads
        dev = engine.raw_uncompress_batch(encs, backend="device")
        assert [r[0] for r in dev] == payloads
        assert all(r[1] == "ok" for r in dev)

    def test_small_declared_oversized_body(self):
        """declared <= 64 KiB but the body exceeds the encoder's bound
        (pathological expansion): the chunk slab widens to hold it."""
        from snappy_tpu import engine
        from snappy_tpu.formats import constants as C
        from snappy_tpu.formats import varint

        # 64 KiB emitted as 65536 one-byte literals: body = 2x declared
        payload = bytes(range(256)) * 256
        body = b"".join(b"\x00" + payload[i:i + 1] for i in range(65536))
        assert len(body) > C.max_compressed_len(C.MAX_BLOCK_LEN)
        enc = varint.encode_uint32(len(payload)) + body
        assert s.decode_batch([enc]) == [payload]
        (out, reason), = engine.raw_uncompress_batch([enc], backend="device")
        assert reason == "ok" and out == payload

    def test_encode_batch_byte_identity(self):
        """encode_batch must produce byte-identical streams to per-payload
        encode on both backends (the block split is per payload), at both
        levels, across sizes straddling the block boundary."""
        import numpy as np

        from snappy_tpu import engine

        rng = np.random.default_rng(33)
        payloads = [
            b"",
            b"x",
            b"batchenc " * 300,
            (b"multi block payload " * 9000)[:150_000],
            bytes(rng.integers(0, 256, 70_000, np.uint8)),
            b"Q" * 65536,
        ]
        for level in (1, 2):
            batch = s.encode_batch(payloads, level=level)
            assert batch == [s.encode(p, level=level) for p in payloads]
            dev = engine.raw_compress_batch(
                payloads, backend="device", level=level)
            singles = [
                engine.raw_compress(p, backend="device", level=level)
                for p in payloads
            ]
            assert dev == singles
        # every stream decodes back
        for enc, p in zip(s.encode_batch(payloads), payloads):
            assert s.decode(enc) == p

    def test_multiblock_segment_split(self):
        """>64 KiB streams split at output-block boundaries by the native
        scan and decode as independent chunks (round-5); parity with
        decode() across content classes, including the C++-produced
        golden stream."""
        import numpy as np

        from snappy_tpu import engine
        from snappy_tpu.testing import corpus

        rng = np.random.default_rng(21)
        payloads = [
            (b"segmented " * 60000)[:300_000],
            b"R" * 200_000,
            bytes(rng.integers(0, 256, 150_000, np.uint8)),
        ]
        encs = [s.encode(p) for p in payloads]
        if corpus.corpus_root() is not None:
            gold = corpus.read_data(corpus.GOLDEN_RAWSNAPPY)
            encs.append(gold)
            payloads.append(s.decode(gold))
        res = engine.raw_uncompress_batch(encs, backend="device")
        assert [r[0] for r in res] == payloads
        assert all(r[1] == "ok" for r in res)

    def test_cross_boundary_copy_falls_back(self):
        """A LEGAL stream whose copy reaches back across a 64 KiB output
        boundary is tag-aligned (the scan splits it) but not block-
        parallel: the failing segment must trigger the whole-stream
        fallback, not a wrong verdict."""
        from snappy_tpu import engine
        from snappy_tpu.formats import varint

        payload = bytes(range(256)) * 256          # exactly 64 KiB
        raw = bytearray()
        # one literal with 3-byte length extension covering the block
        raw.append((59 + 2) << 2)
        raw += (65536 - 1).to_bytes(2, "little")
        raw += payload
        # tagCopy2: 40 bytes from offset 60000 — crosses the boundary
        raw.append(((40 - 1) << 2) | 2)
        raw += (60000).to_bytes(2, "little")
        expect = payload + payload[65536 - 60000 : 65536 - 60000 + 40]
        enc = varint.encode_uint32(len(expect)) + bytes(raw)
        assert s.decode(enc) == expect             # sanity: legal stream
        (out, reason), = engine.raw_uncompress_batch(
            [enc], backend="device")
        assert reason == "ok" and out == expect

    def test_straddling_tag_not_splittable(self):
        """One literal spanning 100 KB: no tag boundary at 64 KiB, the
        scan refuses (-2) and the stream rides the big-window lane."""
        from snappy_tpu import engine
        from snappy_tpu.formats import varint

        payload = bytes(range(256)) * 400           # 102400 B
        raw = bytearray()
        raw.append((59 + 4) << 2)
        raw += (len(payload) - 1).to_bytes(4, "little")
        raw += payload
        enc = varint.encode_uint32(len(payload)) + bytes(raw)
        assert s.decode(enc) == payload
        (out, reason), = engine.raw_uncompress_batch(
            [enc], backend="device")
        assert reason == "ok" and out == payload

    def test_max_size_guard(self):
        enc = s.encode(b"x" * 10_000)
        assert s.decode_batch([enc], max_size=9_999) == [b""]
        assert s.decode_batch([enc], max_size=10_000) == [s.decode(enc)]

    def test_empty_batch(self):
        assert s.decode_batch([]) == []


class TestPackageSurface:
    """Top-level export parity with the reference's public symbols."""

    def test_version_matches_pyproject(self):
        import pathlib
        import re

        text = (pathlib.Path(s.__file__).parents[1] / "pyproject.toml").read_text()
        ver = re.search(r'^version = "([^"]+)"', text, re.M).group(1)
        assert s.__version__ == ver

    def test_length_math_exported(self):
        # codec.nim exports maxCompressedLen / maxCompressedLenFramed at L1.
        assert s.max_compressed_len(65536) == C.max_compressed_len(65536)
        assert s.max_compressed_len(C.MAX_UNCOMPRESSED_LEN + 1) == 0
        assert s.max_compressed_len_framed(0) == len(C.FRAMING_HEADER)
        assert len(s.encode(b"z" * 100_000)) <= s.max_compressed_len(100_000)

    def test_masked_crc32c_exported(self):
        # maskedCrc is public at codec.nim:71-75; parity with the native
        # wrapper (the backend-routed engine entry must agree with it).
        from snappy_tpu.ops import crc32c_native

        for payload in (b"", b"a", b"snappy" * 1000, bytes(range(256))):
            assert s.masked_crc32c(payload) == crc32c_native.masked_crc32c(payload)
