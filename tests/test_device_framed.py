"""Device-backend framed decode: malformed/CRC/rule coverage.

The auto backend resolves to host when the native library exists, so these
pin backend="device" to keep the device chunk pipeline honest against the
same rule set (snappy.nim:199-265)."""

import pytest

import snappy_tpu as s
from snappy_tpu import engine
from snappy_tpu.formats import constants as C
from snappy_tpu.formats import framing
from snappy_tpu.ops import crc32c_native


def hdr(cid, length):
    return framing.encode_frame_header(cid, length)


def device_decode(data, check_integrity=True):
    return engine.framed_uncompress(
        data, check_integrity=check_integrity, backend="device"
    )


class TestDeviceFramed:
    def test_roundtrip(self):
        payload = b"device framed " * 4000  # ~56 KB
        enc = engine.framed_compress(payload, backend="device")
        out, reason = device_decode(enc)
        assert reason == "ok" and out == payload

    def test_host_stream_device_decode(self):
        payload = b"cross backend " * 9000  # two frames
        enc = engine.framed_compress(payload, backend="host")
        out, reason = device_decode(enc)
        assert reason == "ok" and out == payload

    def test_crc_mismatch(self):
        payload = b"crc " * 2000
        enc = bytearray(engine.framed_compress(payload, backend="device"))
        enc[14] ^= 0x55
        out, reason = device_decode(bytes(enc))
        assert out is None and reason == "crc"
        out, reason = device_decode(bytes(enc), check_integrity=False)
        assert reason == "ok" and out == payload

    def test_unskippable_chunk(self):
        data = C.FRAMING_HEADER + hdr(0x03, 2) + b"\x00\x00"
        out, reason = device_decode(data)
        assert out is None and reason == "unknown_chunk"

    def test_skippable_and_padding(self):
        payload = b"after skips"
        inner = engine.framed_compress(payload, backend="device")[
            len(C.FRAMING_HEADER) :
        ]
        data = (
            C.FRAMING_HEADER
            + hdr(0x9A, 2)
            + b"zz"
            + hdr(C.CHUNK_PADDING, 1)
            + b"\x00"
            + inner
        )
        out, reason = device_decode(data)
        assert reason == "ok" and out == payload

    def test_corrupt_inner_stream(self):
        payload = b"corrupt me " * 3000
        enc = bytearray(engine.framed_compress(payload, backend="device"))
        # Flip a byte inside the first compressed chunk's tag stream
        # (past header+crc+varint) and disable CRC so the decoder itself
        # must reject or mis-produce — it must not crash, and with CRC on
        # it must report the corruption.
        enc[30] ^= 0xFF
        out, reason = device_decode(bytes(enc))
        assert out is None and reason in ("crc", "invalid")

    def test_hand_built_uncompressed(self):
        payload = b"uncompressed device chunk"
        crc = crc32c_native.masked_crc32c(payload).to_bytes(4, "little")
        data = (
            C.FRAMING_HEADER
            + hdr(C.CHUNK_UNCOMPRESSED, 4 + len(payload))
            + crc
            + payload
        )
        out, reason = device_decode(data)
        assert reason == "ok" and out == payload

    def test_device_path_never_calls_host_crc(self, monkeypatch):
        """The device backend's success path is fully device-verified:
        uncompressed-chunk CRCs go through the device kernel, never
        crc32c_native (round-5 VERDICT item 3; snappy.nim:231-233)."""

        def boom(*a, **k):
            raise AssertionError("host CRC called on the device path")

        monkeypatch.setattr(crc32c_native, "masked_crc32c", boom)
        monkeypatch.setattr(crc32c_native, "masked_crc32c_ptr", boom)

        # mixed stream: a verbatim (uncompressed) first frame, compressed
        # frames after — exercises both the batched device-CRC pass and
        # the walk's CRC-before-resume path below
        import numpy as np

        rng = np.random.default_rng(5)
        incompressible = rng.integers(0, 256, 70000, np.uint8).tobytes()
        compressible = b"device framed " * 5000
        payload = incompressible + compressible
        enc = engine.framed_compress(payload, backend="device")
        ids = [c.id for c in framing.scan_frames(enc, len(C.FRAMING_HEADER))]
        assert C.CHUNK_UNCOMPRESSED in ids and C.CHUNK_COMPRESSED in ids
        out, reason = device_decode(enc)
        assert reason == "ok" and out == payload

        # the resumable walk's reject-path CRC is device-routed too
        from snappy_tpu import config

        prev = config.get_backend()
        config.set_backend("device")
        try:
            buf = bytearray(8192)  # too small: the big chunk hits the
            res = s.uncompress_framed_into(enc, buf)  # CRC-before-resume
            assert res.is_ok()
        finally:
            config.set_backend(prev)

    def test_uncompressed_crc_mismatch_device(self):
        """A corrupted VERBATIM chunk must fail with "crc" on the device
        backend (the deferred batched CRC pass)."""
        payload = b"\x37" + bytes(range(256)) * 20  # stays verbatim? force:
        crc = crc32c_native.masked_crc32c(payload).to_bytes(4, "little")
        data = (
            C.FRAMING_HEADER
            + hdr(C.CHUNK_UNCOMPRESSED, 4 + len(payload))
            + crc
            + payload
        )
        bad = bytearray(data)
        bad[-1] ^= 0xA5  # corrupt payload, keep stored CRC
        out, reason = device_decode(bytes(bad))
        assert out is None and reason == "crc"
        out, reason = device_decode(bytes(bad), check_integrity=False)
        assert reason == "ok" and out == bytes(bad)[-len(payload):]

    def test_error_order_uncompressed_crc_before_compressed_invalid(self):
        """Chunk 1 = verbatim with bad CRC, chunk 2 = compressed chunk that
        scans fine but fails to DECODE: the EARLIEST chunk's error ("crc")
        must win (snappy.nim:199-265 processes strictly in order)."""
        p1 = b"first chunk payload"
        c1 = (crc32c_native.masked_crc32c(p1) ^ 1).to_bytes(4, "little")
        import snappy_tpu.formats.varint as v

        # declared 100 bytes but the tag stream is a truncated tagCopy4
        body = v.encode_uint32(100) + b"\xff"
        data = (
            C.FRAMING_HEADER
            + hdr(C.CHUNK_UNCOMPRESSED, 4 + len(p1))
            + c1
            + p1
            + hdr(C.CHUNK_COMPRESSED, 4 + len(body))
            + b"\x00" * 4
            + body
        )
        out, reason = device_decode(data)
        assert out is None and reason == "crc"
        # and with the CRC healthy, the later decode error surfaces
        good = crc32c_native.masked_crc32c(p1).to_bytes(4, "little")
        data2 = data.replace(c1, good, 1)
        out, reason = device_decode(data2)
        assert out is None and reason == "invalid"

    def test_truncated_inner_varint(self):
        # compressed chunk whose payload is CRC + truncated varint
        data = C.FRAMING_HEADER + hdr(C.CHUNK_COMPRESSED, 5) + b"\x00" * 4 + b"\x80"
        out, reason = device_decode(data)
        assert out is None and reason == "invalid"

    def test_oversized_inner_declared(self):
        # inner varint declares 64KiB+1
        import snappy_tpu.formats.varint as v

        inner = v.encode_uint32(65537)
        data = (
            C.FRAMING_HEADER
            + hdr(C.CHUNK_COMPRESSED, 4 + len(inner))
            + b"\x00" * 4
            + inner
        )
        out, reason = device_decode(data)
        assert out is None and reason == "invalid"
