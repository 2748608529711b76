"""Sharded pipeline tests on the virtual 8-device CPU mesh.

The analog of multi-node testing for this framework (SURVEY §4.6): sharded
runs must produce byte-identical streams to the single-device path."""

import numpy as np
import pytest

import jax

import snappy_tpu as s
from snappy_tpu import engine
from snappy_tpu.parallel import mesh as pmesh
from snappy_tpu.testing import corpus


@pytest.fixture(scope="module")
def mesh8():
    devs = jax.devices()
    if len(devs) < 2:
        pytest.skip("needs multiple devices")
    return pmesh.default_mesh(len(devs))


def _payload(n, seed=0):
    rng = np.random.default_rng(seed)
    word = rng.integers(0, 256, 23, dtype=np.uint8).tobytes()
    rep = (word * (n // len(word) + 1))[: n // 2]
    rnd = rng.integers(0, 256, n - len(rep), dtype=np.uint8).tobytes()
    return rep + rnd


class TestShardedRaw:
    def test_identical_to_single_device(self, mesh8):
        payload = _payload(500_000)
        sharded = pmesh.sharded_raw_compress(payload, mesh8)
        single = engine.raw_compress(payload, backend="device")
        assert sharded == single
        assert s.decode(sharded) == payload

    def test_small_input(self, mesh8):
        payload = b"tiny"
        assert pmesh.sharded_raw_compress(payload, mesh8) == engine.raw_compress(
            payload, backend="device"
        )


class TestShardedFramed:
    def test_identical_to_single_device(self, mesh8):
        payload = _payload(700_000, seed=1)
        sharded = pmesh.sharded_framed_compress(payload, mesh8)
        single = engine.framed_compress(payload, backend="device")
        assert sharded == single

    def test_sharded_roundtrip(self, mesh8):
        payload = _payload(700_000, seed=2)
        enc = pmesh.sharded_framed_compress(payload, mesh8)
        out, reason = pmesh.sharded_framed_uncompress(enc, mesh8)
        assert reason == "ok"
        assert out == payload

    def test_sharded_decode_of_corpus_stream(self, mesh8, corpus_root):
        enc = corpus.read_stream("alice29.txt.sz-64k")
        plain = corpus.read_data("alice29.txt")
        if enc is None:
            pytest.skip("stream file missing")
        out, reason = pmesh.sharded_framed_uncompress(enc, mesh8)
        assert reason == "ok" and out == plain

    def test_bad_crc_detected(self, mesh8):
        payload = _payload(200_000, seed=3)
        enc = bytearray(pmesh.sharded_framed_compress(payload, mesh8))
        enc[14] ^= 0xFF  # first chunk CRC byte
        out, reason = pmesh.sharded_framed_uncompress(bytes(enc), mesh8)
        assert out is None and reason == "crc"
