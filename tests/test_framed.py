"""Framed-format tests (mirrors reference tests/test_framed.nim)."""

import random

import pytest

import snappy_tpu as s
from snappy_tpu.formats import constants as C
from snappy_tpu.formats import framing
from snappy_tpu.ops import crc32c_native
from snappy_tpu.testing import corpus


def frame_header(cid, length):
    return framing.encode_frame_header(cid, length)


class TestFramedRoundtrip:
    @pytest.mark.parametrize(
        "payload",
        [
            b"",
            b"a",
            b"hello framed world " * 50,
            b"\xff" * 70000,  # two frames, RLE
        ],
    )
    def test_roundtrip(self, payload):
        enc = s.encode_framed(payload)
        assert enc.startswith(C.FRAMING_HEADER)
        assert s.decode_framed(enc) == payload
        assert s.uncompressed_len_framed(enc) == len(payload)

    def test_empty_is_header_only(self):
        assert s.encode_framed(b"") == C.FRAMING_HEADER
        assert s.decode_framed(C.FRAMING_HEADER) == b""

    @pytest.mark.parametrize(
        "n",
        [
            C.MIN_NON_LITERAL_BLOCK_SIZE - 1,
            C.MIN_NON_LITERAL_BLOCK_SIZE,
            C.MIN_NON_LITERAL_BLOCK_SIZE + 1,
            C.MAX_UNCOMPRESSED_FRAME_DATA_LEN - 1,
            C.MAX_UNCOMPRESSED_FRAME_DATA_LEN,
            C.MAX_UNCOMPRESSED_FRAME_DATA_LEN + 1,
        ],
    )
    def test_frame_boundaries(self, n):
        # test_framed.nim:140-158
        payload = (b"0123456789abcdef" * (n // 16 + 1))[:n]
        enc = s.encode_framed(payload)
        assert s.decode_framed(enc) == payload

    def test_incompressible_frames_stored_verbatim(self):
        rng = random.Random(5)
        payload = bytes(rng.getrandbits(8) for _ in range(5000))
        enc = s.encode_framed(payload)
        # id of first data chunk after the stream header
        assert enc[len(C.FRAMING_HEADER)] == C.CHUNK_UNCOMPRESSED
        assert s.decode_framed(enc) == payload

    def test_compressible_frames_compressed(self):
        payload = b"compress me please " * 1000
        enc = s.encode_framed(payload)
        assert enc[len(C.FRAMING_HEADER)] == C.CHUNK_COMPRESSED
        assert len(enc) < len(payload)
        assert s.decode_framed(enc) == payload


class TestFramedGoldenStreams:
    @pytest.mark.parametrize("stream_name,plain_name", corpus.STREAM_FILES)
    def test_decode_external_streams(self, corpus_root, stream_name, plain_name):
        """Pre-compressed framed streams from an external snappy tool decode
        bit-exactly (test_framed.nim:9-59)."""
        enc = corpus.read_stream(stream_name)
        plain = corpus.read_data(plain_name)
        if enc is None:
            pytest.skip("stream file missing")
        assert s.decode_framed(enc) == plain
        assert s.uncompressed_len_framed(enc) == len(plain)

    def test_roundtrip_corpus(self, corpus_root):
        data = corpus.read_data("alice29.txt")
        enc = s.encode_framed(data)
        assert s.decode_framed(enc) == data


class TestFramedMalformed:
    def check_invalid(self, data, reasons=(s.FrameError.invalid_input,)):
        # All three framed decode APIs must fail (test_framed.nim:83-95).
        assert s.decode_framed(data) == b""
        res = s.uncompress_framed_into(data, bytearray(1 << 17))
        assert res.is_err() and res.error in reasons

    def test_truncated_magic(self):
        self.check_invalid(C.FRAMING_HEADER[:5])

    def test_wrong_magic(self):
        bad = bytes([0xFF, 0x06, 0x00, 0x00]) + b"sNaPpX"
        self.check_invalid(bad)

    def test_truncated_chunk_header(self):
        self.check_invalid(C.FRAMING_HEADER + b"\x00\x01")

    def test_truncated_chunk_payload(self):
        self.check_invalid(C.FRAMING_HEADER + frame_header(C.CHUNK_UNCOMPRESSED, 64))

    def test_unskippable_reserved_chunk(self):
        data = C.FRAMING_HEADER + frame_header(0x02, 4) + b"\x00" * 4
        assert s.decode_framed(data) == b""
        res = s.uncompress_framed_into(data, bytearray(64))
        assert res.is_err() and res.error == s.FrameError.unknown_chunk

    def test_skippable_reserved_chunk_skipped(self):
        payload = b"after the skippable chunk"
        inner = s.encode_framed(payload)[len(C.FRAMING_HEADER) :]
        data = C.FRAMING_HEADER + frame_header(0x80, 3) + b"abc" + inner
        assert s.decode_framed(data) == payload

    def test_padding_chunk_skipped(self):
        payload = b"after padding"
        inner = s.encode_framed(payload)[len(C.FRAMING_HEADER) :]
        data = C.FRAMING_HEADER + frame_header(C.CHUNK_PADDING, 8) + b"\x00" * 8 + inner
        assert s.decode_framed(data) == payload

    def test_oversized_uncompressed_chunk(self):
        # The reference vector carries a CORRECT crc (test_framed.nim:202-218)
        # so the size cap is what rejects it; with a wrong crc the reference
        # checks integrity first (snappy.nim:245-252) -> crcMismatch.
        from snappy_tpu.ops import crc32c_native

        n = C.MAX_UNCOMPRESSED_FRAME_DATA_LEN + 1
        payload = b"\x00" * n
        good_crc = crc32c_native.masked_crc32c(payload).to_bytes(4, "little")
        data = (
            C.FRAMING_HEADER
            + frame_header(C.CHUNK_UNCOMPRESSED, 4 + n)
            + good_crc
            + payload
        )
        self.check_invalid(data)
        bad = (
            C.FRAMING_HEADER
            + frame_header(C.CHUNK_UNCOMPRESSED, 4 + n)
            + b"\x00" * (4 + n)
        )
        self.check_invalid(bad, reasons=(s.FrameError.crc_mismatch,))

    def test_compressed_chunk_too_short(self):
        data = C.FRAMING_HEADER + frame_header(C.CHUNK_COMPRESSED, 3) + b"\x00" * 3
        self.check_invalid(data)

    def test_bad_crc_rejected(self):
        payload = b"integrity matters " * 10
        enc = bytearray(s.encode_framed(payload))
        # CRC is the 4 bytes after the first chunk header
        pos = len(C.FRAMING_HEADER) + 4
        enc[pos] ^= 0xFF
        assert s.decode_framed(bytes(enc)) == b""
        res = s.uncompress_framed_into(bytes(enc), bytearray(1 << 17))
        assert res.is_err() and res.error == s.FrameError.crc_mismatch

    def test_bad_crc_accepted_without_integrity(self):
        # Wrong CRC accepted when check_integrity is off
        # (test_framed.nim:160-196).
        payload = b"integrity optional " * 10
        enc = bytearray(s.encode_framed(payload))
        pos = len(C.FRAMING_HEADER) + 4
        enc[pos] ^= 0xFF
        assert s.decode_framed(bytes(enc), check_integrity=False) == payload

    def test_hand_built_uncompressed_chunk(self):
        payload = b"hand built"
        crc = crc32c_native.masked_crc32c(payload).to_bytes(4, "little")
        data = (
            C.FRAMING_HEADER
            + frame_header(C.CHUNK_UNCOMPRESSED, 4 + len(payload))
            + crc
            + payload
        )
        assert s.decode_framed(data) == payload


class TestResumableProtocol:
    def test_resume_across_output_buffers(self):
        """Partial-output + resume (test_framed.nim:38-59)."""
        payload = b"".join(
            bytes([i & 0xFF]) * 1000 for i in range(200)
        )  # 200 KB -> 4 frames
        enc = s.encode_framed(payload)

        out = bytearray(70000)
        got = b""
        view = memoryview(enc)
        first = True
        while True:
            res = s.uncompress_framed_into(bytes(view), out, check_header=first)
            assert res.is_ok()
            read, written = res.unwrap()
            got += bytes(out[:written])
            if read >= len(view):
                break
            assert written > 0  # forward progress
            view = view[read:]
            first = False
        assert got == payload

    def test_buffer_too_small_for_any_chunk(self):
        payload = b"z" * 50000
        enc = s.encode_framed(payload)
        res = s.uncompress_framed_into(enc, bytearray(10))
        assert res.is_ok()
        read, written = res.unwrap()
        assert written == 0 and read == len(C.FRAMING_HEADER)

    def test_exact_fit(self):
        payload = b"q" * 30000
        enc = s.encode_framed(payload)
        out = bytearray(len(payload))
        res = s.uncompress_framed_into(enc, out)
        assert res.is_ok()
        read, written = res.unwrap()
        assert read == len(enc) and written == len(payload)
        assert bytes(out) == payload


class TestPartialWindowResume:
    """The sequential-walk semantics of uncompress_framed_into: a malformed
    or truncated TAIL past the output budget must not poison the valid
    fitting prefix (snappy.nim:199-265 processes chunks one at a time and
    returns Ok((read, written)) when output fills first)."""

    def _three_frames(self):
        """140000 random bytes -> three CHUNK_UNCOMPRESSED frames."""
        payload = bytes(random.Random(5).randbytes(140000))
        enc = s.encode_framed(payload)
        chunks = framing.scan_frames(enc, len(C.FRAMING_HEADER))
        assert len(chunks) == 3
        return payload, enc, chunks

    def test_truncated_tail_past_resume_point_still_progresses(self):
        payload, enc, chunks = self._three_frames()
        # Chunk 0 fits, chunk 1 does not (the resume point), chunk 2 is cut
        # mid-payload — the walk must never reach it.
        cut = chunks[2].data_pos + 2
        window = enc[:cut]
        out = bytearray(C.MAX_BLOCK_LEN)  # fits exactly one frame
        res = s.uncompress_framed_into(window, out)
        assert res.is_ok(), res
        read, written = res.unwrap()
        assert written == chunks[0].uncompressed_len
        assert read == chunks[1].header_pos
        assert bytes(out[:written]) == payload[:written]

    def test_corrupt_tail_past_resume_point_still_progresses(self):
        payload, enc, chunks = self._three_frames()
        bad = bytearray(enc)
        bad[chunks[2].header_pos] = 0x40  # unknown unskippable chunk id
        out = bytearray(C.MAX_BLOCK_LEN)
        res = s.uncompress_framed_into(bytes(bad), out)
        assert res.is_ok(), res
        read, written = res.unwrap()
        assert written == chunks[0].uncompressed_len
        assert read == chunks[1].header_pos

    def test_truncated_chunk_at_resume_point_errors(self):
        # The reference validates a reached chunk's structure before the
        # fit check (snappy.nim:206-208), so a truncated chunk 1 errors
        # even though the output is already full.
        payload, enc, chunks = self._three_frames()
        window = enc[: chunks[1].data_pos + 2]
        out = bytearray(C.MAX_BLOCK_LEN)
        res = s.uncompress_framed_into(window, out)
        assert res.is_err()

    def test_corrupt_chunk_within_budget_errors(self):
        payload, enc, chunks = self._three_frames()
        bad = bytearray(enc)
        bad[chunks[0].header_pos] = 0x40
        out = bytearray(C.MAX_BLOCK_LEN)
        res = s.uncompress_framed_into(bytes(bad), out)
        assert res.is_err()

    def test_nonfitting_uncompressed_chunk_crc_checked_first(self):
        # Reference order: CRC verify happens before the fit check for
        # uncompressed chunks (snappy.nim:244-251).
        import random as _random

        # incompressible (seeded, reproducible) -> stored as an
        # uncompressed chunk
        payload = _random.Random(288).randbytes(1000)
        enc = s.encode_framed(payload)
        chunks = framing.scan_frames(enc, len(C.FRAMING_HEADER))
        assert chunks[0].id == C.CHUNK_UNCOMPRESSED
        bad = bytearray(enc)
        bad[chunks[0].data_pos] ^= 0xFF  # corrupt stored CRC
        out = bytearray(10)  # chunk does not fit
        res = s.uncompress_framed_into(bytes(bad), out)
        assert res.is_err()
        # ... but with integrity checks off it is a clean resume point.
        res2 = s.uncompress_framed_into(bytes(bad), out, check_integrity=False)
        assert res2.is_ok()
        read, written = res2.unwrap()
        assert written == 0 and read == chunks[0].header_pos


class TestKeepCompressedThreshold:
    """The compressed-vs-verbatim frame decision must follow the reference
    exactly: keep compressed iff the encoded BLOCK alone (varint header
    excluded) is <= flen - flen//8 (encoder.nim:408; ADVICE round-1 item 3)."""

    @pytest.mark.parametrize("backend", ["host", "device"])
    def test_decision_matches_block_length_rule(self, backend):
        from snappy_tpu import engine
        from snappy_tpu.formats import varint as vi
        from snappy_tpu.ops import host_codec

        if backend == "host" and not host_codec.available():
            pytest.skip("no native codec")
        rng = random.Random(321)
        # Half-compressible payloads land near the 1/8-savings boundary.
        for trial in range(12):
            n = rng.randrange(200, 3000)
            rep = (b"abcdefgh" * (n // 8 + 1))[: n // 2]
            payload = rep + bytes(rng.randbytes(n - len(rep)))
            enc = engine.framed_compress(payload, backend=backend)
            chunks = framing.scan_frames(enc, len(C.FRAMING_HEADER))
            pos = 0
            for ch in chunks:
                flen = ch.uncompressed_len
                frame = payload[pos : pos + flen]
                pos += flen
                raw = engine.raw_compress(frame, backend=backend)
                _, vlen = vi.decode_uint32(raw)
                enc_len = len(raw) - vlen
                expect_compressed = (
                    flen >= C.MIN_NON_LITERAL_BLOCK_SIZE
                    and enc_len <= flen - flen // 8
                )
                got_compressed = ch.id == C.CHUNK_COMPRESSED
                assert got_compressed == expect_compressed, (
                    f"{backend} trial {trial}: flen={flen} enc_len={enc_len} "
                    f"threshold={flen - flen // 8}"
                )


class TestErrorOrderParity:
    """The reference processes chunks strictly one at a time
    (snappy.nim:199-265): the error reported must belong to the EARLIEST
    bad chunk, on every backend.  Regressions: the batched device decode
    checked uncompressed-chunk CRCs before decoding any compressed chunk,
    and the uncompress_framed_into walk reported a later structural error
    before verifying taken chunks."""

    def _frame(self, cid, payload):
        return bytes([cid]) + len(payload).to_bytes(3, "little") + payload

    def _uncompressed_chunk(self, data, bad_crc=False):
        crc = crc32c_native.masked_crc32c(data)
        if bad_crc:
            crc ^= 0xFF
        return self._frame(
            C.CHUNK_UNCOMPRESSED, crc.to_bytes(4, "little") + data
        )

    def _backends(self):
        import os

        from snappy_tpu.ops import host_codec

        # Under the sanitizer leg the device arm would compile XLA inside
        # an ASan-interposed process, which XLA's CPU runtime does not
        # support (upstream limitation, not a codec path of ours).
        dev = [] if os.environ.get("SNAPPY_TPU_SANITIZE") else ["device"]
        return dev + (["host"] if host_codec.available() else [])

    def test_bad_compressed_body_beats_later_bad_crc(self):
        # chunk0: structurally-valid compressed chunk whose BODY fails tag
        # decode; chunk1: uncompressed chunk with corrupted CRC.  The
        # reference decodes chunk0 first -> invalidInput.
        from snappy_tpu import engine

        body = b"\x05\xff\xff"  # declared 5, truncated literal
        crc = crc32c_native.masked_crc32c(b"x")  # arbitrary stored CRC
        chunk0 = self._frame(C.CHUNK_COMPRESSED, crc.to_bytes(4, "little") + body)
        chunk1 = self._uncompressed_chunk(b"tail data", bad_crc=True)
        stream = bytes(C.FRAMING_HEADER) + chunk0 + chunk1
        for backend in self._backends():
            got, reason = engine.framed_uncompress(stream, backend=backend)
            assert got is None and reason == "invalid", (backend, reason)
        res = s.uncompress_framed_into(stream, bytearray(1 << 16))
        assert res.is_err() and res.error == s.FrameError.invalid_input

    def test_bad_crc_beats_later_unknown_chunk(self):
        # chunk0: fitting uncompressed chunk with bad CRC; chunk1: unknown
        # unskippable chunk id.  The reference verifies chunk0's CRC before
        # parsing chunk1 -> crcMismatch.
        chunk0 = self._uncompressed_chunk(b"first chunk payload", bad_crc=True)
        chunk1 = self._frame(0x40, b"")
        stream = bytes(C.FRAMING_HEADER) + chunk0 + chunk1
        res = s.uncompress_framed_into(stream, bytearray(1 << 16))
        assert res.is_err() and res.error == s.FrameError.crc_mismatch
        # with integrity off, the unknown chunk is the first error
        res = s.uncompress_framed_into(
            stream, bytearray(1 << 16), check_integrity=False
        )
        assert res.is_err() and res.error == s.FrameError.unknown_chunk

    def test_bad_crc_beats_later_truncation(self):
        chunk0 = self._uncompressed_chunk(b"first chunk payload", bad_crc=True)
        stream = bytes(C.FRAMING_HEADER) + chunk0 + b"\x00\x08"  # torn header
        res = s.uncompress_framed_into(stream, bytearray(1 << 16))
        assert res.is_err() and res.error == s.FrameError.crc_mismatch

    def test_overlong_inner_varint_rejected_on_resume_path(self):
        # A compressed chunk whose inner length is a non-canonical 6-byte
        # varint must be invalid_input even when the chunk would not have
        # fit the output budget (the reference reads the uint32 Leb128
        # FIRST, snappy.nim:92); regression: the walk used the lenient
        # uint64 scanner and returned Ok(resume).
        overlong = b"\xe4\x80\x80\x80\x80\x00"  # value 100, 6 bytes
        body = overlong + b"\x00" * 4
        crc = crc32c_native.masked_crc32c(b"")
        chunk0 = self._frame(C.CHUNK_COMPRESSED, crc.to_bytes(4, "little") + body)
        stream = bytes(C.FRAMING_HEADER) + chunk0
        res = s.uncompress_framed_into(stream, bytearray(10))  # budget 10 < 100
        assert res.is_err() and res.error == s.FrameError.invalid_input

    def test_truncated_inner_varint_stays_within_chunk(self):
        # A compressed chunk whose payload ends mid-varint (continuation
        # bit set on the last payload byte).  The inner-length read must be
        # clamped to the chunk (snappy.nim:92 slices within the chunk) so
        # it never consumes the NEXT chunk's header bytes; regression: the
        # walk read a fixed 5-byte window past the chunk end and returned
        # Ok((read, 0)) with a small output budget (output-budget-dependent
        # result + a resume-protocol hang).
        crc = crc32c_native.masked_crc32c(b"")
        chunk0 = self._frame(
            C.CHUNK_COMPRESSED, crc.to_bytes(4, "little") + b"\x80"
        )
        chunk1 = self._uncompressed_chunk(b"next chunk payload")
        stream = bytes(C.FRAMING_HEADER) + chunk0 + chunk1
        for budget in (16, 1 << 16):
            res = s.uncompress_framed_into(stream, bytearray(budget))
            assert res.is_err() and res.error == s.FrameError.invalid_input


class TestErrorOrderFuzz:
    """Randomized multi-chunk framed streams with a fault injected at a
    random chunk: the resumable walk's outcome — Ok((read, written)) plus
    the written bytes, or the typed error — must be IDENTICAL across the
    native host walk and the device route (reference:
    test_framed.nim:83-219).  The
    deferred ``walk_err`` machinery (api.py) and the index-ordered batched
    device errors (engine._framed_uncompress_device) are the subjects."""

    FAULTS = (
        "none", "crc", "varint_oversize", "varint_overlong", "tags",
        "unknown", "truncate", "short_data",
    )

    @staticmethod
    def _legs():
        import os

        from snappy_tpu.ops import host_codec

        legs = []
        if host_codec.available():
            legs.append("host")
        if not os.environ.get("SNAPPY_TPU_SANITIZE"):
            legs.append("device")
        return legs

    def _build(self, specs, fault, k, seed):
        from snappy_tpu.formats import varint

        rng = random.Random(seed)
        parts = []
        total_unc = 0
        for i, (kind, size) in enumerate(specs):
            faulted = i == k
            if kind == "pad":
                parts.append(frame_header(C.CHUNK_PADDING, size) + b"\x00" * size)
                continue
            if kind == "skip":
                cid = rng.randrange(C.CHUNK_RESERVED_SKIPPABLE_LO, 0xFE)
                if faulted and fault == "unknown":
                    cid = rng.randrange(0x03, C.CHUNK_RESERVED_SKIPPABLE_LO)
                parts.append(frame_header(cid, size) + bytes(size))
                continue
            if kind == "comp":
                payload = ((bytes([rng.randrange(33, 80)]) * 7 + b"ab")
                           * (size // 9 + 3))[: size + 17]
                body = s.encode(payload)
            else:
                payload = bytes(rng.randrange(256) for _ in range(size))
                body = payload
            crc = crc32c_native.masked_crc32c(payload)
            cid = C.CHUNK_COMPRESSED if kind == "comp" else C.CHUNK_UNCOMPRESSED
            if faulted:
                if fault == "crc":
                    crc ^= 0x5A
                elif fault == "unknown":
                    cid = rng.randrange(0x03, C.CHUNK_RESERVED_SKIPPABLE_LO)
                elif fault == "short_data":
                    dl = rng.randrange(0, 4)
                    parts.append(frame_header(cid, dl) + bytes(dl))
                    continue
                elif kind == "comp" and fault == "varint_oversize":
                    body = varint.encode_uint32(70000) + body[3:]
                elif kind == "comp" and fault == "varint_overlong":
                    body = b"\xe4\x80\x80\x80\x80\x00" + body[1:]
                elif kind == "comp" and fault == "tags" and len(body) > 2:
                    j = rng.randrange(1, len(body))
                    body = body[:j] + bytes([body[j] ^ 0xFF]) + body[j + 1:]
            total_unc += len(payload)
            parts.append(
                frame_header(cid, 4 + len(body))
                + crc.to_bytes(4, "little")
                + body
            )
        stream = bytes(C.FRAMING_HEADER) + b"".join(parts)
        if fault == "truncate" and len(stream) > len(C.FRAMING_HEADER) + 1:
            cut = rng.randrange(1, min(10, len(stream) - len(C.FRAMING_HEADER)))
            stream = stream[:-cut]
        return stream, total_unc

    def _run_leg(self, backend, stream, budget):
        from snappy_tpu import config

        prev_b = config.get_backend()
        config.set_backend(backend)
        try:
            buf = bytearray(budget)
            res = s.uncompress_framed_into(stream, buf)
            if res.is_ok():
                read, written = res.value
                return ("ok", read, written, bytes(buf[:written]))
            return ("err", res.error)
        finally:
            config.set_backend(prev_b)

    def test_fault_injection_parity(self):
        hypothesis = pytest.importorskip("hypothesis")
        import os

        from hypothesis import HealthCheck, given, settings
        from hypothesis import strategies as st

        legs = self._legs()
        if len(legs) < 2:
            pytest.skip("need at least two backend legs")

        @st.composite
        def cases(draw):
            nch = draw(st.integers(1, 5))
            specs = [
                (
                    draw(st.sampled_from(["comp", "uncomp", "skip", "pad"])),
                    draw(st.integers(1, 800)),
                )
                for _ in range(nch)
            ]
            fault = draw(st.sampled_from(self.FAULTS))
            k = draw(st.integers(0, nch - 1))
            budget = draw(st.sampled_from([7, 300, 4096, 1 << 17, -1]))
            seed = draw(st.integers(0, 2**31 - 1))
            return specs, fault, k, budget, seed

        @given(cases())
        @settings(
            max_examples=int(os.environ.get("SNAPPY_TPU_FUZZ_EXAMPLES", "30")),
            deadline=None,
            suppress_health_check=[
                HealthCheck.too_slow,
                HealthCheck.data_too_large,
            ],
        )
        def run(case):
            specs, fault, k, budget, seed = case
            stream, total_unc = self._build(specs, fault, k, seed)
            if budget == -1:
                budget = max(total_unc, 1)
            sigs = [
                (leg, self._run_leg(leg, stream, budget))
                for leg in legs
            ]
            first = sigs[0][1]
            for leg, sig in sigs[1:]:
                assert sig == first, (
                    f"divergence {sigs[0][0]} vs {leg}: {first!r} != {sig!r} "
                    f"(fault={fault}@{k}, specs={specs}, seed={seed}, "
                    f"budget={budget})"
                )

        run()
