"""Cross-backend equivalence: host (native C) vs device (JAX) paths.

Both backends must accept/reject identical inputs and round-trip through
each other — the in-framework analog of the reference's Nim-vs-C++
differential testing (test_snappy.nim:44-69)."""

import numpy as np
import pytest

import snappy_tpu as s
from snappy_tpu import engine
from snappy_tpu.ops import host_codec
from snappy_tpu.testing import corpus, oracle

from test_oracle import MALFORMED_RAW

pytestmark = pytest.mark.skipif(
    not host_codec.available(), reason="native host codec unavailable"
)


def _payloads():
    rng = np.random.default_rng(0)
    word = rng.integers(0, 256, 23, dtype=np.uint8).tobytes()
    return [
        b"",
        b"x",
        b"hello world " * 40,
        (word * 9000)[:150_000],
        rng.integers(0, 256, 50_000, dtype=np.uint8).tobytes(),
    ]


class TestRawEquivalence:
    @pytest.mark.parametrize("i", range(5))
    def test_cross_decode(self, i):
        payload = _payloads()[i]
        enc_host = engine.raw_compress(payload, backend="host")
        enc_dev = engine.raw_compress(payload, backend="device")
        for enc in (enc_host, enc_dev):
            for backend in ("host", "device"):
                out, reason = engine.raw_uncompress(enc, backend=backend)
                assert reason == "ok" and out == payload
            dec, err = oracle.uncompress(enc)
            assert err is None and dec == payload

    @pytest.mark.parametrize("idx", range(len(MALFORMED_RAW)))
    def test_malformed_rejected_by_host(self, idx):
        out, reason = engine.raw_uncompress(MALFORMED_RAW[idx], backend="host")
        assert out is None

    @pytest.mark.parametrize("name", corpus.BAD_FILES)
    def test_baddata_rejected_by_host(self, corpus_root, name):
        out, reason = engine.raw_uncompress(corpus.read_data(name), backend="host")
        assert out is None

    def test_golden_decode_host(self, corpus_root):
        gold = corpus.read_data(corpus.GOLDEN_RAWSNAPPY)
        ref, err = oracle.uncompress(gold)
        out, reason = engine.raw_uncompress(gold, backend="host")
        assert reason == "ok" and out == ref

    def test_random_streams_differential(self):
        """Arbitrary byte strings: host decoder and oracle agree exactly."""
        import random

        rng = random.Random(9)
        for _ in range(300):
            n = rng.randrange(1, 120)
            data = bytes(rng.getrandbits(8) for _ in range(n))
            ref, ref_err = oracle.uncompress(data)
            out, reason = engine.raw_uncompress(data, backend="host")
            if ref_err is None:
                assert reason == "ok" and out == ref
            else:
                assert out is None


class TestFramedEquivalence:
    @pytest.mark.parametrize("i", range(5))
    def test_cross_decode(self, i):
        payload = _payloads()[i]
        enc_host = engine.framed_compress(payload, backend="host")
        enc_dev = engine.framed_compress(payload, backend="device")
        for enc in (enc_host, enc_dev):
            for backend in ("host", "device"):
                out, reason = engine.framed_uncompress(enc, backend=backend)
                assert reason == "ok" and out == payload

    def test_external_stream_host(self, corpus_root):
        enc = corpus.read_stream("alice29.txt.sz-64k")
        plain = corpus.read_data("alice29.txt")
        if enc is None:
            pytest.skip("stream file missing")
        out, reason = engine.framed_uncompress(enc, backend="host")
        assert reason == "ok" and out == plain

    def test_crc_mismatch_host(self):
        payload = b"integrity " * 200
        enc = bytearray(engine.framed_compress(payload, backend="host"))
        enc[14] ^= 0xFF
        out, reason = engine.framed_uncompress(bytes(enc), backend="host")
        assert out is None and reason == "crc"
        out, reason = engine.framed_uncompress(
            bytes(enc), check_integrity=False, backend="host"
        )
        assert reason == "ok" and out == payload


class TestVarintStrictness:
    """Backend-independent accept/reject for non-canonical varints: all
    decode paths enforce the reference's 5-byte uint32 limit
    (snappy.nim:92), regardless of backend (ADVICE round-1, item 2)."""

    def _overlong_raw(self):
        # 6-byte varint encoding 100 (non-canonical zero continuation).
        import snappy_tpu as s

        body = s.encode(b"x" * 100)  # canonical: 1-byte varint '100'
        assert body[0] == 100
        return b"\xe4\x80\x80\x80\x80\x00" + body[1:]

    def test_overlong_raw_varint_rejected_everywhere(self):
        import snappy_tpu as s
        from snappy_tpu import engine
        from snappy_tpu.testing import oracle

        bad = self._overlong_raw()
        for backend in ("host", "device"):
            got, reason = engine.raw_uncompress(bad, backend=backend)
            assert got is None, backend
        assert s.decode(bad) == b""
        ref, err = oracle.uncompress(bad)
        assert ref is None
        res = s.uncompress_into(bad, bytearray(200))
        assert res.is_err()

    def test_overlong_framed_inner_varint_rejected_everywhere(self):
        import snappy_tpu as s
        from snappy_tpu.formats import constants as C2
        from snappy_tpu.formats import framing as fr
        from snappy_tpu.ops import crc32c_native
        from snappy_tpu import engine

        blob = self._overlong_raw()
        crc = crc32c_native.masked_crc32c(b"x" * 100).to_bytes(4, "little")
        stream = (
            C2.FRAMING_HEADER
            + fr.encode_frame_header(C2.CHUNK_COMPRESSED, 4 + len(blob))
            + crc
            + blob
        )
        for backend in ("host", "device"):
            got, reason = engine.framed_uncompress(stream, backend=backend)
            assert got is None, f"{backend} accepted overlong varint"
        assert s.decode_framed(stream) == b""


class TestBlockParallelRawDecode:
    """The block-parallel raw decode (speculative boundary scan + threaded
    segment decode, host_codec.decode_raw_body_into) must agree byte-for-
    byte and verdict-for-verdict with the sequential decoder on every
    stream shape — including streams the format allows but no block
    encoder emits, where it must fall back."""

    @pytest.fixture(autouse=True)
    def _force_parallel(self, monkeypatch):
        # Production thresholds only engage the parallel path above ~4 MB
        # compressed; force it on for every test payload here so the scan,
        # stitch, and segment machinery run in CI.
        monkeypatch.setattr(host_codec, "_PAR_DECODE_MIN", 1 << 14)

    def _roundtrip_both(self, payload):
        from snappy_tpu.formats import varint

        enc = host_codec.raw_compress(payload)
        declared, read = varint.decode_uint32(enc)
        body = enc[read:]
        seq = np.empty((declared,), np.uint8)
        assert host_codec.decode_tags_into(body, declared, seq)
        par = np.empty((declared,), np.uint8)
        assert host_codec.decode_raw_body_into(body, declared, par)
        assert bytes(par) == bytes(seq) == payload

    def test_multiblock_payload_shapes(self):
        rng = np.random.default_rng(11)
        word = rng.integers(0, 256, 19, dtype=np.uint8).tobytes()
        for payload in [
            (word * 50000)[: 5 * 65536 + 7],  # text-like, 6 blocks
            b"\xaa" * (4 * 65536),  # RLE, exact block multiple
            rng.integers(0, 256, 3 * 65536 + 1, dtype=np.uint8).tobytes(),
            (word * 9000)[:100_000]
            + rng.integers(0, 256, 200_000, dtype=np.uint8).tobytes()
            + b"\x00" * 150_000,  # mixed regimes
        ]:
            self._roundtrip_both(payload)

    def test_parallel_scan_path_forced(self, monkeypatch):
        # Force the speculative parallel scan even for small bodies so the
        # stitch (merge-find + index fast-forward) is exercised in CI.
        monkeypatch.setattr(host_codec, "_PAR_SCAN_MIN", 1 << 16)
        monkeypatch.setattr(host_codec, "_SCAN_SPAN_MAX", 1 << 18)
        rng = np.random.default_rng(12)
        word = rng.integers(0, 256, 23, dtype=np.uint8).tobytes()
        payload = (
            (word * 40000)[: 6 * 65536]
            + rng.integers(0, 256, 2 * 65536, dtype=np.uint8).tobytes()
            + b"\x55" * (2 * 65536 + 13)
        )
        self._roundtrip_both(payload)

    def test_scan_matches_sequential_on_corpus(self):
        from snappy_tpu.formats import varint

        lib = host_codec.get_lib()
        data = corpus.read_data("html_x_4") or b"fallback payload " * 30000
        payload = (data * 40)[: 60 * 65536]
        enc = host_codec.raw_compress(payload)
        declared, read = varint.decode_uint32(enc)
        body = np.frombuffer(enc[read:], np.uint8)
        cap = declared // 65536 + 2
        offs_seq = np.empty((cap,), np.int64)
        nseq = lib.stpu_raw_scan_blocks(
            body.ctypes.data, len(body), declared, offs_seq.ctypes.data, cap
        )
        assert nseq >= 2
        offs_par = np.empty((cap,), np.int64)
        try:
            old = host_codec._PAR_SCAN_MIN
            host_codec._PAR_SCAN_MIN = 1 << 16
            npar = host_codec._scan_blocks(body, declared, offs_par, cap, 4)
        finally:
            host_codec._PAR_SCAN_MIN = old
        assert npar == nseq
        assert (offs_par[: npar + 1] == offs_seq[: nseq + 1]).all()

    def test_boundary_crossing_copy_falls_back(self):
        # A stream the scan proves block-aligned but whose second block
        # opens with a copy reaching into the first block: legal snappy,
        # never emitted by block encoders.  The parallel path must detect
        # it (segment decode fails) and fall back to the sequential
        # decoder, producing the correct bytes.
        first = bytes(range(256)) * 256  # 65536 bytes
        lit = b"\xf4\xff\xff" + first  # literal, 2 extra len bytes (65535+1)
        cross_copy = b"\x1e\x04\x00"  # copy2 len=8 offset=4
        tail_lit = b"\x6cthis is the tail literal 123"  # 28-byte literal
        body = lit + cross_copy + tail_lit
        declared = 65536 + 8 + 28
        expected = first + first[-4:] + first[-4:] + tail_lit[1:]
        out = np.empty((declared,), np.uint8)
        assert host_codec.decode_raw_body_into(body, declared, out)
        assert bytes(out) == expected

    def test_malformed_streams_rejected_identically(self):
        rng = np.random.default_rng(13)
        word = rng.integers(0, 256, 17, dtype=np.uint8).tobytes()
        payload = (word * 40000)[: 4 * 65536]
        enc = bytearray(host_codec.raw_compress(payload))
        from snappy_tpu.formats import varint

        declared, read = varint.decode_uint32(bytes(enc))
        for _ in range(200):
            mut = bytearray(enc)
            for _k in range(rng.integers(1, 4)):
                mut[rng.integers(read, len(mut))] = rng.integers(0, 256)
            body = bytes(mut[read:])
            seq = np.empty((declared,), np.uint8)
            ok_seq = host_codec.decode_tags_into(body, declared, seq)
            par = np.empty((declared,), np.uint8)
            ok_par = host_codec.decode_raw_body_into(body, declared, par)
            assert ok_seq == ok_par
            if ok_seq:
                assert bytes(par) == bytes(seq)


class TestEncoderByteIdentityAcrossBackends:
    """Host C (level 1) and the greedy oracle emit byte-identical blocks.
    The device encoder (encode_jax, a sort-based matcher) emits its own
    bytes; its streams must decode to the payload on every decoder, raw
    AND framed (CRC + 1/8-savings rule included)."""

    def test_host_equals_device_streams(self):
        rng = np.random.default_rng(21)
        word = rng.integers(0, 256, 23, dtype=np.uint8).tobytes()
        payloads = [
            corpus.read_data("html") or b"<html>" * 20000,
            (word * 9000)[:150_000],
            b"\x42" * 70_000,
        ]
        for p in payloads:
            for raw in (engine.raw_compress(p, backend=b) for b in ("host", "device")):
                for backend in ("host", "device"):
                    assert engine.raw_uncompress(raw, backend=backend) == (p, "ok")
                assert oracle.uncompress(raw) == (p, None)
            for framed in (
                engine.framed_compress(p, backend=b) for b in ("host", "device")
            ):
                for backend in ("host", "device"):
                    assert engine.framed_uncompress(framed, backend=backend) == (p, "ok")

    def test_host_level1_equals_oracle_blocks(self):
        from snappy_tpu.formats import varint
        from snappy_tpu.testing import oracle

        d = corpus.read_data("geo.protodata") or (b"proto data " * 12000)
        for i in range(0, len(d), 65536):
            blk = d[i : i + 65536]
            e = host_codec.raw_compress(blk)
            _, r = varint.decode_uint32(e)
            assert e[r:] == oracle.encode_block(blk)


class TestLevelTwoBackends:
    """encode(level=2) is a host-codec option: its streams decode on the
    device, and the device encoder (one level) gives level 1's bytes."""

    def test_level2_bytes_match_across_backends(self):
        payload = (b"two way buckets " * 6000)[:90_000]  # two blocks
        enc_host = engine.raw_compress(payload, backend="host", level=2)
        assert engine.raw_uncompress(enc_host, backend="device") == (payload, "ok")
        enc_dev = engine.raw_compress(payload, backend="device", level=2)
        assert enc_dev == engine.raw_compress(payload, backend="device", level=1)
        assert engine.raw_uncompress(enc_dev, backend="host") == (payload, "ok")
        f_host = engine.framed_compress(payload, backend="host", level=2)
        assert engine.framed_uncompress(f_host, backend="device") == (payload, "ok")
        f_dev = engine.framed_compress(payload, backend="device", level=2)
        assert f_dev == engine.framed_compress(payload, backend="device", level=1)
