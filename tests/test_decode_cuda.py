"""The CUDA chunk decoder's wrapper: build, kernel choice, slab packing.

The kernel itself runs only on a GPU (CUDA has no interpret mode); the
tests marked ``gpu`` check it there against the plain XLA decoder and the
oracle, and skip elsewhere.  ``python chip_smoke.py`` runs them on the card.
Everything around the kernel -- which kernel the platform gets, how chunks
are packed into slabs and unpacked, how raw streams are split, and how the
library is built -- is plain Python and is tested here on the CPU.
"""

import random
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import snappy_tpu as s
from snappy_tpu import config, engine
from snappy_tpu.formats import varint
from snappy_tpu.ops import decode_cuda, decode_jax, host_codec
from snappy_tpu.testing import oracle, payloads

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run python chip_smoke.py on the card)")
    return jax.devices()[0]


def _bodies(payload: bytes):
    """Per-64 KiB-block tag streams of ``payload`` and their sizes."""
    bodies, decls = [], []
    for i in range(0, len(payload), 65536):
        blk = payload[i : i + 65536]
        enc = s.encode(blk)
        _, v = varint.decode_uint32(enc)
        bodies.append(enc[v:])
        decls.append(len(blk))
    return bodies, decls


# ---------------------------------------------------------------------------
# Kernel choice
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "platform,kernel", [("gpu", "cuda"), ("cpu", "xla"), ("metal", None), ("rocm", None)]
)
def test_kernel_choice_by_platform(monkeypatch, platform, kernel):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    if kernel is None:
        with pytest.raises(RuntimeError, match="no chunk decoder"):
            engine._chunk_kernel()
    else:
        assert engine._chunk_kernel() == kernel


def test_cuda_kernel_dispatches_ffi_wrapper(monkeypatch):
    calls = []

    def fake(comp, comp_lens, out_lens):
        calls.append(comp.shape)
        n = comp.shape[0]
        return jnp.zeros((n, 65536), jnp.uint8), jnp.ones((n,), bool), out_lens

    monkeypatch.setattr(decode_cuda, "decode_chunks", fake)
    comp = jnp.zeros((8, 1024), jnp.uint8)
    lens = jnp.zeros((8,), jnp.int32)
    out, ok, written = engine._decode_rows(comp, lens, lens, "cuda")
    assert calls == [(8, 1024)] and out.shape == (8, 65536) and bool(ok.all())


def test_ffi_call_traces_to_custom_call(monkeypatch):
    """Without a GPU the target cannot be registered, but the call still
    lowers for CUDA to one custom call on uint8 operands."""
    monkeypatch.setattr(decode_cuda, "register", lambda: None)
    fn = jax.jit(decode_cuda.decode_chunks)
    args = (jax.ShapeDtypeStruct((8, 1024), jnp.uint8),
            jax.ShapeDtypeStruct((8,), jnp.int32),
            jax.ShapeDtypeStruct((8,), jnp.int32))
    text = fn.trace(*args).lower(lowering_platforms=("cuda",)).as_text()
    assert "snappy_decode_chunks" in text
    assert "tensor<8x1024xui8>" in text and "tensor<8x65536xui8>" in text


# ---------------------------------------------------------------------------
# Slab packing and unpacking
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "n,rows", [(1, 1), (2, 8), (8, 8), (9, 32), (100, 128), (129, 512), (512, 512)]
)
def test_slab_row_buckets(n, rows):
    assert engine._nb_slab(n) == rows


@pytest.mark.parametrize(
    "max_body,width",
    [(0, 1024), (1000, 1024), (1025, 2048), (40_000, 65536), (65537, 76544),
     (76544, 76544), (76545, 131072), (300_000, 524288)],
)
def test_comp_width_buckets(max_body, width):
    assert engine._comp_width(max_body) == width


def test_pack_rows_layout_and_padding():
    bodies = [b"\x0cabcd", b"", b"\x00z" * 700]
    comp, comp_lens, out_lens = engine.pack_rows(bodies, [4, 0, 1], 8)
    assert comp.dtype == np.uint8 and comp.shape == (8, 2048)
    assert comp_lens.tolist() == [5, 0, 1400, 0, 0, 0, 0, 0]
    assert out_lens.tolist() == [4, 0, 1, 0, 0, 0, 0, 0]
    assert comp[0, :5].tobytes() == b"\x0cabcd" and not comp[0, 5:].any()
    assert not comp[3:].any()


def test_decode_slabs_split_at_512_rows(monkeypatch):
    seen = []

    def fake_step(comp, comp_lens, out_lens, *, kernel, with_crc):
        seen.append((comp.shape, int((comp_lens > 0).sum()), kernel, with_crc))
        n = comp.shape[0]
        return (jnp.zeros((n, 65536), jnp.uint8), comp_lens > 0,
                out_lens, jnp.zeros((n,), jnp.uint32))

    monkeypatch.setattr(engine, "_decode_step", fake_step)
    bodies = [b"\x00a"] * 1100
    got = [(lo, out.shape, ok.sum(), crcs.shape)
           for lo, out, ok, crcs in engine._decode_slabs(bodies, [1] * 1100, True)]
    assert [g[0] for g in got] == [0, 512, 1024]
    assert [sh[0] for sh in seen] == [(512, 1024), (512, 1024), (128, 1024)]
    assert [sh[1] for sh in seen] == [512, 512, 76]
    assert {sh[2] for sh in seen} == {"xla"} and all(sh[3] for sh in seen)


def test_decode_slabs_unpack_rows():
    payload = payloads.mixed(5 * 65536 + 123, seed=3, piece=40_000)
    bodies, decls = _bodies(payload)
    (lo, out, ok, crcs), = engine._decode_slabs(bodies, decls, with_crc=True)
    assert lo == 0 and out.shape == (8, 65536) and ok.tolist() == [True] * 6 + [False] * 2
    from snappy_tpu.ops import crc32c_native

    for k, d in enumerate(decls):
        blk = payload[k * 65536 : k * 65536 + d]
        assert out[k, :d].tobytes() == blk and not out[k, d:].any()
        assert int(crcs[k]) == crc32c_native.masked_crc32c(blk)


@pytest.mark.skipif(not host_codec.available(), reason="native host codec unavailable")
def test_raw_stream_block_split():
    """scan_raw_blocks splits a raw stream at every 64 KiB of output, and
    the pieces decode alone to the matching blocks."""
    payload = payloads.mixed(4 * 65536 + 999, seed=4, piece=70_000)
    enc = host_codec.raw_compress(payload)
    declared, read = varint.decode_uint32(enc)
    body = enc[read:]
    offs = host_codec.scan_raw_blocks(body, declared)
    assert len(offs) == 6 and offs[0] == 0 and offs[-1] == len(body)
    for k in range(5):
        seg = body[offs[k] : offs[k + 1]]
        out, err = oracle.decode_all_tags(seg, min(65536, declared - k * 65536))
        assert err is None and bytes(out) == payload[k * 65536 : (k + 1) * 65536]


# ---------------------------------------------------------------------------
# Building the library
# ---------------------------------------------------------------------------


def test_build_command_targets_hopper(tmp_path):
    cmd = decode_cuda.build_command(tmp_path / "lib.so")
    assert cmd[0].endswith("nvcc")
    joined = " ".join(cmd)
    assert "-gencode arch=compute_90a,code=sm_90a" in joined
    for flag in ("-O3", "-shared", "-std=c++17"):
        assert flag in cmd
    assert cmd[cmd.index("-Xcompiler") + 1] == "-fPIC"
    assert cmd[cmd.index("-I") + 1] == jax.ffi.include_dir()
    assert cmd[cmd.index("-o") + 1] == str(tmp_path / "lib.so")
    assert cmd[-1] == str(decode_cuda.SOURCE) and decode_cuda.SOURCE.exists()


def test_library_path_keyed_by_source_and_flags(monkeypatch, tmp_path):
    lib = decode_cuda.library_path()
    assert lib.parent.parent == decode_cuda.BUILD_ROOT
    assert lib.parent.name == decode_cuda.source_hash()
    src = tmp_path / "k.cu"
    src.write_bytes(decode_cuda.SOURCE.read_bytes())
    monkeypatch.setattr(decode_cuda, "SOURCE", src)
    same = decode_cuda.source_hash()
    src.write_bytes(src.read_bytes() + b"\n// edit\n")
    edited = decode_cuda.source_hash()
    monkeypatch.setattr(decode_cuda, "NVCC_FLAGS", decode_cuda.NVCC_FLAGS + ("-G",))
    assert len({lib.parent.name, edited, decode_cuda.source_hash()}) == 3
    assert same == lib.parent.name


def _gitignored(rel: str) -> bool:
    lines = (REPO / ".gitignore").read_text().split()
    return any(rel == ln.rstrip("/") for ln in lines)


def test_build_output_is_gitignored():
    assert _gitignored(decode_cuda.BUILD_ROOT.relative_to(REPO).as_posix())


def test_build_failure_raises_and_leaves_nothing(monkeypatch, tmp_path):
    monkeypatch.setattr(decode_cuda, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(decode_cuda, "nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        decode_cuda.build()
    assert list(tmp_path.rglob("*.so*")) == []


def test_build_reuses_existing_library(monkeypatch, tmp_path):
    monkeypatch.setattr(decode_cuda, "BUILD_ROOT", tmp_path)
    lib = decode_cuda.library_path()
    lib.parent.mkdir(parents=True)
    lib.write_bytes(b"built")
    monkeypatch.setattr(decode_cuda, "nvcc", lambda: "false")
    assert decode_cuda.build() == lib


# ---------------------------------------------------------------------------
# Compilation cache
# ---------------------------------------------------------------------------


@pytest.fixture
def cache_dir_restored():
    prev = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", prev)


def test_compile_cache_defaults_to_checkout(monkeypatch, cache_dir_restored):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    jax.config.update("jax_compilation_cache_dir", None)
    config.ensure_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == str(REPO / ".jax_cache")
    assert _gitignored(".jax_cache")


def test_compile_cache_not_used_on_cpu(monkeypatch, cache_dir_restored):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jax.config.update("jax_compilation_cache_dir", None)
    config.ensure_compilation_cache()
    assert jax.default_backend() == "cpu"
    assert jax.config.jax_compilation_cache_dir is None


def test_compile_cache_env_is_left_alone(monkeypatch, tmp_path, cache_dir_restored):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    config.ensure_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _plain(comp, comp_lens, out_lens):
    return decode_jax.decode_chunks(comp.astype(jnp.int32), comp_lens, out_lens, 65536)


@pytest.mark.gpu
def test_gpu_cuda_matches_plain_decoder(gpu):
    payload = payloads.mixed(64 * 65536, seed=11, piece=200_000)
    bodies, decls = _bodies(payload)
    comp, cl, dl = engine.pack_rows(bodies, decls, 64)
    got = jax.jit(decode_cuda.decode_chunks)(comp, cl, dl)
    want = jax.jit(_plain)(comp, cl, dl)
    assert np.asarray(got[1]).all()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert np.asarray(got[0]).tobytes() == payload


@pytest.mark.gpu
def test_gpu_cuda_mutants_match_oracle(gpu):
    rng = random.Random(5)
    payload = payloads.mixed(8 * 65536, seed=12, piece=65536)
    base, decls = _bodies(payload)
    bodies, ds = [], []
    for i in range(256):
        b = bytearray(base[i % 8])
        for _ in range(rng.randrange(1, 3)):
            b[rng.randrange(len(b))] ^= 1 << rng.randrange(8)
        bodies.append(bytes(b[: rng.randrange(1, len(b) + 1)] if i % 5 == 0 else b))
        ds.append(decls[i % 8])
    comp, cl, dl = engine.pack_rows(bodies, ds, 256)
    out, ok, _ = (np.asarray(x) for x in jax.jit(decode_cuda.decode_chunks)(comp, cl, dl))
    for k in range(256):
        ref, err = oracle.decode_all_tags(bodies[k], ds[k])
        ref_ok = err is None and len(ref) == ds[k]
        assert bool(ok[k]) == ref_ok, k
        if ref_ok:
            assert out[k, : ds[k]].tobytes() == bytes(ref), k


@pytest.mark.gpu
def test_gpu_cuda_isolates_bad_row(gpu):
    good = s.encode(b"isolated good row " * 300)
    _, v = varint.decode_uint32(good)
    bodies = [good[v:], b"\xff", good[v:], b"\x00", good[v:]]
    decls = [5400, 100, 5400, 1, 5400]
    comp, cl, dl = engine.pack_rows(bodies, decls, 8)
    out, ok, _ = (np.asarray(x) for x in jax.jit(decode_cuda.decode_chunks)(comp, cl, dl))
    assert ok.tolist() == [True, False, True, False, True, False, False, False]
    assert out[0, :5400].tobytes() == out[4, :5400].tobytes() == b"isolated good row " * 300


@pytest.mark.gpu
def test_gpu_decode_step_calls_the_kernel(gpu):
    comp = jax.ShapeDtypeStruct((512, 76544), jnp.uint8)
    lens = jax.ShapeDtypeStruct((512,), jnp.int32)
    text = engine._decode_step.lower(
        comp, lens, lens, kernel=engine._chunk_kernel(), with_crc=True
    ).as_text()
    assert engine._chunk_kernel() == "cuda" and "snappy_decode_chunks" in text


@pytest.mark.gpu
def test_gpu_encoder_matches_cpu(gpu):
    payload = payloads.mixed(16 * 65536, seed=13, piece=65536)
    blocks, blens = engine._split_blocks(np.frombuffer(payload, np.uint8))
    cpu = jax.devices("cpu")[0]
    on_gpu, on_cpu = (
        engine._encode_step(jax.device_put(blocks, d), jax.device_put(blens, d),
                            with_crc=True)
        for d in (gpu, cpu)
    )
    for g, c in zip(on_gpu, on_cpu):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(c))
    enc = engine.raw_compress(payload, backend="device")
    assert oracle.uncompress(enc) == (payload, None)


@pytest.mark.gpu
def test_gpu_crc_matches_native(gpu):
    from snappy_tpu.ops import crc32c_native

    rng = np.random.default_rng(14)
    chunks = rng.integers(0, 256, (256, 65536), dtype=np.uint8)
    lens = rng.integers(0, 65537, 256).astype(np.int32)
    for k in range(256):
        chunks[k, lens[k]:] = 0
    got = np.asarray(engine._crc_chunks_device(chunks, lens, 65536))
    want = [crc32c_native.masked_crc32c(chunks[k, : lens[k]].tobytes()) for k in range(256)]
    assert got.tolist() == want
