"""CRC32C tests: known vectors, native C vs JAX kernel, masking rules."""

import numpy as np
import pytest

import jax.numpy as jnp

from snappy_tpu.ops import crc32c_jax, crc32c_native


class TestNative:
    def test_known_vectors(self):
        # RFC 3720 / common CRC-32C test vectors
        assert crc32c_native.crc32c(b"123456789") == 0xE3069283
        assert crc32c_native.crc32c(b"") == 0x00000000
        assert crc32c_native.crc32c(b"\x00" * 32) == 0x8A9136AA
        assert crc32c_native.crc32c(b"\xff" * 32) == 0x62A8AB43

    def test_python_fallback_agrees(self):
        for n in [0, 1, 7, 8, 9, 64, 100]:
            data = bytes(range(n % 251)) * (n // max(1, n % 251) + 1)
            data = data[:n]
            assert crc32c_native._crc32c_py(data) == crc32c_native.crc32c(data)

    def test_masking(self):
        # masked = rotr15(crc) + 0xa282ead8 (framing_format.txt:39-58)
        crc = 0x12345678
        masked = crc32c_native.mask_crc(crc)
        expected = (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF
        assert masked == expected
        assert crc32c_native.unmask_crc(masked) == crc

    def test_masked_empty(self):
        assert crc32c_native.masked_crc32c(b"") == 0xA282EAD8


class TestJaxKernel:
    @pytest.mark.parametrize(
        "n", [0, 1, 5, 63, 64, 65, 100, 1000, 4096, 12345, 65535, 65536]
    )
    def test_matches_native(self, n):
        rng = np.random.default_rng(n)
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert crc32c_jax.crc32c(data) == crc32c_native.crc32c(data)

    def test_batched_chunks(self):
        rng = np.random.default_rng(0)
        lens = [0, 17, 64, 1000, 65536, 65535, 30000]
        pad = 65536
        chunks = np.zeros((len(lens), pad), dtype=np.int32)
        datas = []
        for i, n in enumerate(lens):
            d = rng.integers(0, 256, n, dtype=np.uint8)
            chunks[i, :n] = d
            datas.append(d.tobytes())
        out = crc32c_jax.masked_crc32c_chunks(
            jnp.asarray(chunks), jnp.asarray(lens, dtype=jnp.int32), pad
        )
        for i, d in enumerate(datas):
            assert int(out[i]) == crc32c_native.masked_crc32c(d), f"len {lens[i]}"

    def test_framed_stream_crcs(self, corpus_root):
        """Verify the CRCs inside a real externally-produced framed stream."""
        from snappy_tpu.formats import constants as C
        from snappy_tpu.formats import framing
        from snappy_tpu.testing import corpus

        enc = corpus.read_stream("alice29.txt.sz-64k")
        plain = corpus.read_data("alice29.txt")
        if enc is None:
            pytest.skip("stream file missing")
        chunks = framing.scan_frames(enc, len(C.FRAMING_HEADER))
        pos = 0
        for ch in chunks:
            if ch.id != C.CHUNK_COMPRESSED:
                continue
            stored = int.from_bytes(enc[ch.data_pos : ch.data_pos + 4], "little")
            payload = plain[pos : pos + ch.uncompressed_len]
            assert crc32c_native.masked_crc32c(payload) == stored
            pos += ch.uncompressed_len
