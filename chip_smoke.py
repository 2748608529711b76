#!/usr/bin/env python3
"""Smoke run of the device route on one NVIDIA GPU, at real sizes.

Drives the public API with the device backend -- framed and raw compress
and decompress, batch encode and decode -- on seeded synthetic payloads
(64 MiB streams, 512-payload batches), checks every result against the host
codec and the plain references, runs the tests marked ``gpu`` in this
process, and times the CUDA chunk decoder against the plain XLA decoder.

    python chip_smoke.py [--seed N]     # one card
    python chip_smoke.py --four         # only the sharded path on 4 cards

Run it from the repository root.  Every phase raises on failure; the last
line of standard output is one JSON object, printed only when all passed.
Without a GPU it fails before printing any result.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import time
from contextlib import contextmanager

MIB = 1 << 20
BLOCK = 65536


def fail(msg: str):
    raise RuntimeError(msg)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


@contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    print(f"== {name}", flush=True)
    yield
    print(f"== {name}: ok ({time.perf_counter() - t0:.1f} s)", flush=True)


def card_line() -> str:
    """Name and power limit of the card, from nvidia-smi (not from JAX)."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def timed(fn, reps: int) -> list:
    """Host-clock seconds of ``reps`` calls, each ending in block_until_ready."""
    import jax

    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        out.append(time.perf_counter() - t0)
    return out


def median(xs) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2]


def host_bodies(payload: bytes):
    """Per-64 KiB-block tag streams from the host codec, and their sizes."""
    from snappy_tpu.formats import varint
    from snappy_tpu.ops import host_codec

    bodies, decls = [], []
    for i in range(0, len(payload), BLOCK):
        blk = payload[i : i + BLOCK]
        enc = host_codec.raw_compress(blk)
        _, v = varint.decode_uint32(enc)
        bodies.append(enc[v:])
        decls.append(len(blk))
    return bodies, decls


def resumable_decode(enc: bytes, window: int) -> bytes:
    import snappy_tpu as s

    got, view, first = [], memoryview(enc), True
    buf = bytearray(window)
    while True:
        res = s.uncompress_framed_into(view, buf, check_header=first)
        check(res.is_ok(), f"resumable decode failed: {res}")
        read, written = res.unwrap()
        got.append(bytes(buf[:written]))
        if read >= len(view):
            return b"".join(got)
        check(written > 0, "resumable decode made no progress")
        view, first = view[read:], False


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_device():
    import jax

    devs = jax.devices()
    check(devs[0].platform == "gpu", f"no GPU: JAX found {devs[0].platform}")
    card = card_line()
    print(f"device: platform={devs[0].platform} kind={devs[0].device_kind} "
          f"count={len(devs)}", flush=True)
    print(f"card: {card}", flush=True)
    return card


def phase_compile():
    import jax
    import jax.numpy as jnp

    from snappy_tpu import engine
    from snappy_tpu.ops import decode_cuda

    t0 = time.perf_counter()
    decode_cuda.register()
    print(f"CUDA library {decode_cuda.library_path().name} built/loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    kernel = engine._chunk_kernel()
    check(kernel == "cuda", f"chunk kernel on this GPU is {kernel!r}")
    i32 = lambda n: jax.ShapeDtypeStruct((n,), jnp.int32)  # noqa: E731
    u8 = lambda n, w: jax.ShapeDtypeStruct((n, w), jnp.uint8)  # noqa: E731
    steps = []
    for n in (512, 1024):
        steps.append((f"decode step {n} x 64 KiB", engine._decode_step.lower(
            u8(n, engine._MAX_COMP_BLOCK), i32(n), i32(n), kernel=kernel,
            with_crc=True)))
    steps.append(("encode step 512 x 64 KiB", engine._encode_step.lower(
        u8(512, BLOCK), i32(512), with_crc=True)))
    steps.append(("CRC step 512 x 64 KiB", engine._crc_chunks_device.lower(
        u8(512, BLOCK), i32(512), BLOCK)))
    for name, lowered in steps:
        if name.startswith("decode"):
            check(decode_cuda.TARGET in lowered.as_text(),
                  f"{name}: no {decode_cuda.TARGET} custom call")
        t0 = time.perf_counter()
        compiled = lowered.compile()
        print(f"{name}: compiled in {time.perf_counter() - t0:.1f} s; "
              f"{compiled.memory_analysis()}", flush=True)


def phase_framed(payload: bytes):
    import snappy_tpu as s
    from snappy_tpu import engine

    t0 = time.perf_counter()
    enc = s.encode_framed(payload)
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    check(s.decode_framed(enc) == payload, "device framed round trip")
    t_dec = time.perf_counter() - t0
    print(f"framed {len(payload) / MIB:.0f} MiB -> {len(enc)} B; first calls "
          f"(compile included): encode {t_enc:.2f} s, decode {t_dec:.2f} s",
          flush=True)
    check(engine.framed_uncompress(enc, backend="host") == (payload, "ok"),
          "host codec decodes the device stream")
    host_enc = engine.framed_compress(payload, backend="host")
    check(s.decode_framed(host_enc) == payload, "device decodes the host stream")
    bad = bytearray(enc)
    bad[14] ^= 0xFF  # first chunk's stored CRC
    check(engine.framed_uncompress(bytes(bad), backend="device") == (None, "crc"),
          "flipped CRC byte not reported as crc")
    check(engine.framed_uncompress(enc[:-7], backend="device") == (None, "invalid"),
          "truncated stream not reported as invalid")
    check(resumable_decode(enc, BLOCK) == payload, "resumable 64 KiB windows")
    return enc


def phase_raw(payload: bytes):
    import snappy_tpu as s
    from snappy_tpu import engine
    from snappy_tpu.formats import varint
    from snappy_tpu.ops import host_codec

    enc = s.encode(payload)
    declared, read = varint.decode_uint32(enc)
    offs = host_codec.scan_raw_blocks(enc[read:], declared)
    check(offs is not None and len(offs) == -(-len(payload) // BLOCK) + 1,
          "raw stream does not split at its block boundaries")
    check(s.decode(enc) == payload, "device raw round trip")
    check(engine.raw_uncompress(enc, backend="host") == (payload, "ok"),
          "host codec decodes the device raw stream")
    check(s.decode(host_codec.raw_compress(payload)) == payload,
          "device decodes the host raw stream")

    # A legal copy reaching across a block boundary: unsplittable.
    first = bytes(range(256)) * 256
    body = (b"\xf4\xff\xff" + first + b"\x1e\x04\x00"
            + b"\x6cthis is the tail literal 123")
    want = first + first[-4:] * 2 + b"this is the tail literal 123"
    cross = varint.encode_uint32(len(want)) + body
    check(s.decode(cross) == want, "copy across a block boundary")

    for name, data in malformed_raw():
        got, reason = engine.raw_uncompress(data, backend="device")
        check(got is None and reason == "invalid", f"raw malformed {name}: {reason}")
    for name, data in malformed_framed(payload[: 4 * BLOCK]):
        got, reason = engine.framed_uncompress(data, backend="device")
        hgot, hreason = engine.framed_uncompress(data, backend="host")
        check(got is None and reason == hreason,
              f"framed malformed {name}: device {reason}, host {hreason}")
    print(f"raw {len(payload) / MIB:.0f} MiB -> {len(enc)} B in "
          f"{len(offs) - 1} blocks; unsplittable and malformed streams ok",
          flush=True)


def malformed_raw():
    """The classes of tests/test_oracle.py's MALFORMED_RAW."""
    return [
        ("truncated varint", b"\x80"),
        ("varint overflow", b"\xff" * 9 + b"\x7f"),
        ("declared > 2^32-1", b"\xff\xff\xff\xff\x1f\x00"),
        ("written != declared", b"\x03\x00"),
        ("no tags", b"\x01"),
        ("truncated literal length", b"\x01\xf0"),
        ("literal length wraps", b"\x05\xfc\xff\xff\xff\xff"),
        ("literal past input", b"\x01\x04"),
        ("copy1 missing offset", b"\x02\x01"),
        ("copy2 missing offset", b"\x02\x0a"),
        ("copy4 missing offset", b"\x02\x03\x01"),
        ("offset 0", b"\x04\x00a\x01\x00"),
        ("offset past written", b"\x04\x00a\x01\x02"),
        ("trailing garbage", b"\x02\x00ab"),
        ("declared 0 with a tag", b"\x00\x00"),
        ("overlong varint", b"\xe4\x80\x80\x80\x80\x00" + b"\x00" * 4),
    ]


def malformed_framed(payload: bytes):
    """The classes of tests/test_formats.py and tests/test_completeness.py."""
    import snappy_tpu as s
    from snappy_tpu.formats import constants as C
    from snappy_tpu.formats import framing, varint

    enc = s.encode_framed(payload)
    start = len(C.FRAMING_HEADER)
    hdr = framing.encode_frame_header
    unskippable = bytearray(enc)
    unskippable[start] = 0x40
    bad_tags = bytearray(enc)
    bad_tags[start + 9] ^= 0xFF  # inside the first chunk's tag stream
    return [
        ("torn final chunk", enc[:-3]),
        ("unskippable chunk id", bytes(unskippable)),
        ("all-continuation varint",
         enc + hdr(C.CHUNK_COMPRESSED, 14) + b"\x00" * 4 + b"\xff" * 10),
        ("declared > 64 KiB",
         enc + hdr(C.CHUNK_COMPRESSED, 7) + b"\x00" * 4 + varint.encode_uint32(65537)),
        ("data chunk shorter than its CRC",
         enc + hdr(C.CHUNK_UNCOMPRESSED, 2) + b"\x00\x00"),
        ("garbage chunk", C.FRAMING_HEADER + b"\x00\x10\x00\x00garbage!"),
        ("corrupt tag stream", bytes(bad_tags)),
    ]


def phase_batch(seed: int):
    import numpy as np

    import snappy_tpu as s
    from snappy_tpu import engine
    from snappy_tpu.ops import host_codec
    from snappy_tpu.testing import payloads as P

    rng = np.random.default_rng(seed + 1)
    sizes = P.batch_sizes(512, 200, 256 * 1024, rng)
    batch = [P.generate(P.CLASSES[i % len(P.CLASSES)], int(n), rng)
             for i, n in enumerate(sizes)]
    t0 = time.perf_counter()
    encs = s.encode_batch(batch)
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    check(s.decode_batch(encs) == batch, "device batch round trip")
    t_dec = time.perf_counter() - t0
    check(all(encs[i] == engine.raw_compress(batch[i], backend="device")
              for i in range(min(32, len(batch)))), "encode_batch bytes differ from one-payload encodes")
    check(all(engine.raw_uncompress(e, backend="host") == (p, "ok")
              for e, p in zip(encs, batch)),
          "host codec decodes the device batch streams")
    check(s.decode_batch([host_codec.raw_compress(p) for p in batch]) == batch,
          "device decodes the host batch streams")
    print(f"batch of {len(batch)} payloads, {int(sizes.sum())} B (sizes {int(sizes.min())}"
          f"..{int(sizes.max())} B); first calls: encode {t_enc:.2f} s, "
          f"decode {t_dec:.2f} s", flush=True)


def phase_reference(payload: bytes, seed: int):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from snappy_tpu import engine
    from snappy_tpu.formats import varint
    from snappy_tpu.ops import crc32c_native, decode_cuda, host_codec
    from snappy_tpu.testing import oracle, payloads as P

    cuda = jax.jit(decode_cuda.decode_chunks)
    plain = jax.jit(lambda c, a, b: engine._decode_rows(c, a, b, "xla"))

    # 1. 1,024 mixed chunks plus the run, near-copy and long-literal classes.
    rng = np.random.default_rng(seed + 2)
    extra = [P.generate("runs", BLOCK, rng), (b"ab" * BLOCK)[:BLOCK],
             b"x" + (b"abc" * BLOCK)[: BLOCK - 1], rng.bytes(BLOCK)]
    bodies, decls = host_bodies(payload[: 1024 * BLOCK])
    xb, xd = host_bodies(b"".join(extra))
    # hand-built long literal and near copies at the head
    longlit = b"\xf4" + (40000 - 1).to_bytes(2, "little") + rng.bytes(40000)
    near = b"\x00a" + b"\x05\x01" * 3 + b"\x16\x02\x00"
    xb += [longlit, near]
    xd += [40000, 1 + 3 * 5 + 6]
    bodies, decls = bodies + xb, decls + xd
    want = [payload[k * BLOCK : (k + 1) * BLOCK] for k in range(1024)] + extra
    want += [bytes(oracle.decode_all_tags(b, d)[0]) for b, d in zip(xb[-2:], xd[-2:])]
    comp, cl, dl = engine.pack_rows(bodies, decls, len(bodies))
    got = [np.asarray(x) for x in cuda(comp, cl, dl)]
    ref = [np.asarray(x) for x in plain(comp, cl, dl)]
    check(got[1].all(), "CUDA decoder rejected a valid chunk")
    for k, w in enumerate(want):
        check(got[0][k, : len(w)].tobytes() == w, f"CUDA chunk {k} bytes")
    for g, r, what in zip(got, ref, ("bytes", "ok", "written")):
        check(np.array_equal(g, r), f"CUDA vs decode_jax: {what} differ")
    print(f"CUDA decoder == host codec == decode_jax on {len(bodies)} chunks",
          flush=True)

    # 2. 2,000 seeded mutants: accept/reject as the oracle, bytes when accepted.
    r = random.Random(seed)
    small = [host_codec.raw_compress(payload[k * MIB : k * MIB + 8192])
             for k in range(64)]
    mut, mdecl = [], []
    for i in range(2000):
        d, v = varint.decode_uint32(small[i % 64])
        b = bytearray(small[i % 64][v:])
        for _ in range(r.randrange(1, 4)):
            b[r.randrange(len(b))] = r.randrange(256)
        if i % 9 == 0:
            b = b[: r.randrange(1, len(b) + 1)]
        mut.append(bytes(b))
        mdecl.append(d)
    comp, cl, dl = engine.pack_rows(mut, mdecl, len(mut))
    out, ok, _ = (np.asarray(x) for x in cuda(comp, cl, dl))
    pok = np.asarray(plain(comp, cl, dl)[1])
    accepted = 0
    for k in range(len(mut)):
        ref_out, err = oracle.decode_all_tags(mut[k], mdecl[k])
        ref_ok = err is None and len(ref_out) == mdecl[k]
        check(bool(ok[k]) == ref_ok == bool(pok[k]), f"mutant {k}: accept/reject")
        if ref_ok:
            accepted += 1
            check(out[k, : mdecl[k]].tobytes() == bytes(ref_out), f"mutant {k} bytes")
    print(f"2000 mutants: {accepted} accepted, decisions == oracle == decode_jax",
          flush=True)

    # 3. A malformed row in a batch leaves its neighbours intact.
    iso = [bodies[0], b"\xff", bodies[1], b"\x00", bodies[2]]
    comp, cl, dl = engine.pack_rows(iso, [decls[0], 100, decls[1], 1, decls[2]], 8)
    out, ok, _ = (np.asarray(x) for x in cuda(comp, cl, dl))
    check(ok.tolist() == [True, False, True, False, True, False, False, False],
          f"isolation: ok flags {ok.tolist()}")
    check(all(out[j, : decls[k]].tobytes() == want[k] for j, k in ((0, 0), (2, 1), (4, 2))),
          "isolation: neighbour bytes")

    # 4. encode_jax: GPU bytes == CPU bytes, decodable by host codec and oracle.
    blocks, blens = engine._split_blocks(np.frombuffer(payload[: 32 * BLOCK], np.uint8))
    on = []
    for dev in (jax.devices()[0], jax.devices("cpu")[0]):
        res = engine._encode_step(jax.device_put(blocks, dev),
                                  jax.device_put(blens, dev), with_crc=True)
        on.append([np.asarray(x) for x in res])
    for g, c, what in zip(on[0], on[1], ("blocks", "lengths", "crcs")):
        check(np.array_equal(g, c), f"encode_jax GPU vs CPU: {what} differ")
    enc, totals = on[0][0], on[0][1]
    for k in range(0, 32, 4):
        blk = payload[k * BLOCK : (k + 1) * BLOCK]
        stream = bytes([0x80, 0x80, 0x04]) + enc[k, : totals[k]].tobytes()
        check(engine.raw_uncompress(stream, backend="host") == (blk, "ok"),
              f"host decode of block {k}")
        check(oracle.uncompress(stream) == (blk, None), f"oracle decode of block {k}")

    # 5. crc32c_jax on the GPU == crc32c_native on 256 x 64 KiB chunks.
    chunks = np.frombuffer(payload[: 256 * BLOCK], np.uint8).reshape(256, BLOCK).copy()
    lens = np.array([BLOCK - (k * 977) % BLOCK for k in range(256)], np.int32)
    for k in range(256):
        chunks[k, lens[k]:] = 0
    crcs = np.asarray(engine._crc_chunks_device(jnp.asarray(chunks), jnp.asarray(lens), BLOCK))
    want_crc = [crc32c_native.masked_crc32c(chunks[k, : lens[k]].tobytes()) for k in range(256)]
    check(crcs.tolist() == want_crc, "crc32c_jax vs crc32c_native")
    print("encode_jax GPU == CPU; crc32c_jax == crc32c_native on 256 chunks", flush=True)


def phase_gpu_tests():
    import pytest

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider", "tests"])
    check(rc == 0, f"gpu-marked tests failed (pytest exit {rc})")


def phase_ab(payload: bytes, enc: bytes, card: str):
    import jax
    import jax.numpy as jnp

    import snappy_tpu as s
    from snappy_tpu import engine

    bodies, decls = host_bodies(payload[: 512 * BLOCK])
    comp, cl, dl = (jax.device_put(x) for x in engine.pack_rows(bodies, decls, 512))
    step = {k: (lambda k=k: engine._decode_step(comp, cl, dl, kernel=k, with_crc=True))
            for k in ("cuda", "xla")}
    res = {k: jax.block_until_ready(f()) for k, f in step.items()}
    for a, b in zip(res["cuda"], res["xla"]):
        check(bool(jnp.array_equal(a, b)), "decode steps disagree")
    times = {"cuda": [], "xla": []}
    for order in (("cuda", "xla"), ("xla", "cuda")) * 2:
        for k in order:
            times[k] += timed(step[k], 5)
    mb = sum(decls) / MIB
    for k in ("cuda", "xla"):
        m = median(times[k])
        print(f"A/B decode+CRC step 512 x 64 KiB, {k}: median {m * 1e3:.3f} ms "
              f"({mb / m:.1f} MiB/s) over {len(times[k])} calls [{card}]", flush=True)

    def framed(kernel):
        orig = engine._chunk_kernel
        engine._chunk_kernel = lambda: kernel
        try:
            t0 = time.perf_counter()
            out = s.decode_framed(enc)
            return time.perf_counter() - t0, out
        finally:
            engine._chunk_kernel = orig

    for k in ("cuda", "xla"):
        check(framed(k)[1] == payload, f"decode_framed with {k}")  # warm
    ft = {"cuda": [], "xla": []}
    for order in (("cuda", "xla"), ("xla", "cuda")) * 2:
        for k in order:
            ft[k].append(framed(k)[0])
    for k in ("cuda", "xla"):
        m = median(ft[k])
        print(f"A/B decode_framed {len(payload) / MIB:.0f} MiB, {k}: median "
              f"{m * 1e3:.1f} ms ({len(payload) / MIB / m:.1f} MiB/s) over "
              f"{len(ft[k])} calls [{card}]", flush=True)


def phase_four(payload: bytes):
    import jax

    from snappy_tpu import engine
    from snappy_tpu.parallel import mesh as pmesh

    check(len(jax.devices()) >= 4, f"--four needs 4 GPUs, found {len(jax.devices())}")
    mesh = pmesh.default_mesh(4)
    one = engine.framed_compress(payload, backend="device")
    t0 = time.perf_counter()
    enc = pmesh.sharded_framed_compress(payload, mesh)
    t_enc = time.perf_counter() - t0
    check(enc == one, "sharded framed stream != one-card stream")
    t0 = time.perf_counter()
    out, reason = pmesh.sharded_framed_uncompress(enc, mesh)
    t_dec = time.perf_counter() - t0
    check(reason == "ok" and out == payload, f"sharded framed round trip: {reason}")
    raw = pmesh.sharded_raw_compress(payload, mesh)
    check(raw == engine.raw_compress(payload, backend="device"),
          "sharded raw stream != one-card stream")
    check(engine.raw_uncompress(raw, backend="device") == (payload, "ok"),
          "sharded raw round trip")
    bad = bytearray(enc)
    bad[14] ^= 0xFF
    check(pmesh.sharded_framed_uncompress(bytes(bad), mesh) == (None, "crc"),
          "sharded decode did not report crc")
    print(f"4-card mesh: framed {len(payload) / MIB:.0f} MiB == one-card bytes, "
          f"round trip ok, raw == one-card bytes, flipped CRC -> crc; first "
          f"calls (compile included): encode {t_enc:.2f} s, decode {t_dec:.2f} s",
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded path on 4 cards")
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    os.chdir(root)
    try:
        import snappy_tpu  # noqa: F401
    except ImportError as e:
        fail(f"snappy_tpu not found beside {__file__}: {e}")

    from snappy_tpu import config
    from snappy_tpu.ops import host_codec
    from snappy_tpu.testing import payloads as P

    config.ensure_compilation_cache()
    with phase("device"):
        card = phase_device()
    check(host_codec.available(), "native host codec did not build")
    config.set_backend("device")
    payload = P.mixed(64 * MIB, args.seed)

    import jax

    if args.four:
        with phase("four"):
            phase_four(payload)
        count = 4
    else:
        with phase("compile"):
            phase_compile()
        with phase("framed"):
            enc = phase_framed(payload)
        with phase("raw"):
            phase_raw(payload)
        with phase("batch"):
            phase_batch(args.seed)
        with phase("reference"):
            phase_reference(payload, args.seed)
        with phase("gpu tests"):
            phase_gpu_tests()
        with phase("decode A/B"):
            phase_ab(payload, enc, card)
        count = len(jax.devices())
    dev = jax.devices()[0]
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
