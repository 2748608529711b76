"""Benchmark harness: the host runtime and the device route on one GPU.

Mirrors the reference benchmark methodology (tests/benchmark.nim: time over
N samples on the snappy corpus, in-memory buffers), covering both execution
paths of the framework:

* host runtime (native C + thread fan-out over blocks/frames) — the path for
  host-resident bytes, directly comparable to the reference's single-core
  numbers (BASELINE.md);
* device route (JAX on the GPU: CUDA chunk decoder, XLA encoder and CRC) —
  timed as jitted slab steps on device-resident buffers, each call ending in
  ``block_until_ready``, and end to end through the public API.

Runs in one process and needs a GPU: without one it exits before timing
anything.  Prints ONE JSON line:
  {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ...,
   "device": {platform, kind, count, card}, "device_results": {GB/s},
   "host": {host-runtime GB/s}}

Headline: the device framed decode step (chunk decode + CRC of a 512-chunk
slab of the seeded mixed payload).  ``vs_baseline`` divides by the
reference's framed decompress on its largest input: 38,942,424 B /
25.389 ms = 1.534 GB/s (README.md:124, BASELINE.md; one x86 core).
Per-file tables and per-step lines go to stderr.
"""

import json
import os
import sys
import time

import numpy as np

# Reference inMemory times (ms) from BASELINE.md (compress, decompress).
REFERENCE_MS = {
    "html": (0.086, 0.056),
    "urls.10K": (1.052, 0.480),
    "fireworks.jpeg": (0.008, 0.005),
    "paper-100k.pdf": (0.010, 0.006),
    "html_x_4": (0.374, 0.218),
    "alice29.txt": (0.334, 0.186),
    "asyoulik.txt": (0.300, 0.165),
    "lcet10.txt": (0.907, 0.483),
    "plrabn12.txt": (1.241, 0.646),
    "geo.protodata": (0.076, 0.050),
    "kppkn.gtb": (0.279, 0.183),
    "Mark.Twain-Tom.Sawyer.txt": (0.024, 0.018),
}
REF_FRAMED_DEC_GBPS = 38_942_424 / 25.389e-3 / 1e9  # ssz state, README.md:124
REF_FRAMED_ENC_GBPS = 38_942_424 / 36.075e-3 / 1e9

SAMPLES = int(os.environ.get("SNAPPY_TPU_BENCH_SAMPLES", "20"))
# Set to a directory to capture a jax.profiler trace of the device section.
PROFILE_DIR = os.environ.get("SNAPPY_TPU_BENCH_PROFILE", "")
# Opt-in 1 GiB framed streams (BASELINE config 3).
BENCH_BIG = os.environ.get("SNAPPY_TPU_BENCH_BIG", "0") == "1"


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def mean_time(fn, samples=SAMPLES):
    """Best of samples: measures codec capability rather than ambient load
    (this host is shared; the reference used the mean of a quiet machine,
    benchmark.nim:20-23 — min-of-N is the standard equivalent on a noisy
    one)."""
    fn()
    times = []
    for _ in range(samples):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.min(times))


def bench_host(datasets):
    """Reference-fair methodology: like tests/benchmark.nim, inputs and
    outputs are pre-allocated buffers reused across samples (the reference
    passes caller buffers; timing fresh page-faulting allocations would
    benchmark the allocator, not the codec)."""
    import snappy_tpu as s
    from snappy_tpu import engine
    from snappy_tpu.ops import host_codec

    log("== host runtime (native C + threads) ==")
    total_b = total_enc = total_dec = 0.0
    ref_enc_ms = ref_dec_ms = 0.0
    for name, data in datasets.items():
        enc = engine.raw_compress(data, backend="host")
        arr = np.frombuffer(data, dtype=np.uint8)
        enc_scratch = np.empty(
            (len(enc) + 4096,), dtype=np.uint8
        )  # compressed output buffer

        def encode_once():
            # span encode into the reused buffer (header cost negligible)
            host_codec.get_lib().stpu_encode_span(
                arr.ctypes.data, len(arr), enc_scratch.ctypes.data
            )

        te = mean_time(encode_once)

        out_buf = bytearray(len(data))
        res = s.uncompress_into(enc, out_buf)
        assert res.is_ok() and bytes(out_buf) == data
        td = mean_time(lambda: s.uncompress_into(enc, out_buf))

        total_b += len(data)
        total_enc += te
        total_dec += td
        r = REFERENCE_MS.get(name)
        if r:
            ref_enc_ms += r[0]
            ref_dec_ms += r[1]
        log(
            f"{name:28s} {len(data):8d}B ratio={len(enc)/len(data):.3f} "
            f"enc={1e3*te:7.3f}ms ({len(data)/te/1e9:5.2f} GB/s) "
            f"dec={1e3*td:7.3f}ms ({len(data)/td/1e9:5.2f} GB/s)"
        )
    ref = (
        f" (reference x86 core: {total_b/(ref_enc_ms*1e-3)/1e9:.3f} / "
        f"{total_b/(ref_dec_ms*1e-3)/1e9:.3f})"
        if ref_enc_ms else ""  # synthetic payloads have no reference times
    )
    log(
        f"raw corpus aggregate: encode {total_b/total_enc/1e9:.3f} GB/s, "
        f"decode {total_b/total_dec/1e9:.3f} GB/s{ref}"
    )

    # Same-machine control: the real google/snappy C++ on THIS host's cores
    # (interleaved best-of to cancel shared-machine noise).  The reference
    # baseline was captured on a faster core; this isolates codec quality
    # from clock speed.
    from snappy_tpu.testing import cpp_snappy

    if cpp_snappy.available():
        ours_best = cpp_best = None
        items = list(datasets.items())
        for _ in range(7):
            t0 = time.perf_counter()
            for _, d in items:
                host_codec.raw_compress(d)
            dt = time.perf_counter() - t0
            ours_best = dt if ours_best is None or dt < ours_best else ours_best
            t0 = time.perf_counter()
            for _, d in items:
                cpp_snappy.encode(d)
            dt = time.perf_counter() - t0
            cpp_best = dt if cpp_best is None or dt < cpp_best else cpp_best
        log(
            f"same-machine C++ google/snappy encode: {total_b/cpp_best/1e9:.3f} GB/s "
            f"(ours {total_b/ours_best/1e9:.3f} GB/s, "
            f"{cpp_best/ours_best:.2f}x of C++)"
        )
        # Decode control (interleaved best-of, same corpus, REUSED
        # buffers on both sides — the same methodology as the per-file
        # table and the reference's own harness; an alloc-vs-alloc
        # variant mostly measured the two allocators): every
        # below-baseline host decode number gets the same
        # proportionality defense as encode.
        encs = [
            (host_codec.raw_compress(d), bytearray(len(d)))
            for _, d in items
        ]
        dec_ours_best = dec_cpp_best = None
        s_mod = __import__("snappy_tpu")
        for _ in range(7):
            t0 = time.perf_counter()
            for e, ob in encs:
                s_mod.uncompress_into(e, ob)
            dt = time.perf_counter() - t0
            dec_ours_best = (
                dt if dec_ours_best is None or dt < dec_ours_best else dec_ours_best
            )
            t0 = time.perf_counter()
            for e, ob in encs:
                cpp_snappy.decode_into(e, ob)
            dt = time.perf_counter() - t0
            dec_cpp_best = (
                dt if dec_cpp_best is None or dt < dec_cpp_best else dec_cpp_best
            )
        log(
            f"same-machine C++ google/snappy decode: {total_b/dec_cpp_best/1e9:.3f} GB/s "
            f"(ours {total_b/dec_ours_best/1e9:.3f} GB/s, "
            f"{dec_cpp_best/dec_ours_best:.2f}x of C++)"
        )

    # Large-payload steady state: chunk-parallel framed pipeline; encode
    # into a reused caller buffer (like the reference's benchmark).
    from snappy_tpu.formats import constants as Cc

    big = b"".join(datasets.values()) * 16  # ~47 MB
    fenc = engine.framed_compress(big, backend="host")
    fenc_buf = np.empty((Cc.max_compressed_len_framed(len(big)),), np.uint8)
    te = mean_time(
        lambda: host_codec.framed_compress_into(big, fenc_buf), samples=12
    )
    big_out = bytearray(len(big))
    res = s.uncompress_framed_into(fenc, big_out)
    assert res.is_ok() and res.unwrap() == (len(fenc), len(big))
    assert bytes(big_out) == big
    # 16 samples: the headline metric; min-of-N needs more draws to find a
    # quiet slot when the shared VM is loaded (observed 2x swings)
    td = mean_time(lambda: s.uncompress_framed_into(fenc, big_out), samples=16)
    framed_enc_gbps = len(big) / te / 1e9
    framed_dec_gbps = len(big) / td / 1e9
    log(
        f"framed {len(big)/1e6:.0f}MB: encode {framed_enc_gbps:.3f} GB/s "
        f"(ref {REF_FRAMED_ENC_GBPS:.3f}), decode {framed_dec_gbps:.3f} GB/s "
        f"(ref {REF_FRAMED_DEC_GBPS:.3f})"
    )
    # Large-payload raw for the record (decode of one raw stream is
    # inherently sequential — the format is not self-delimiting).
    renc = engine.raw_compress(big, backend="host")
    te = mean_time(lambda: engine.raw_compress(big, backend="host"), samples=5)
    td = mean_time(lambda: s.uncompress_into(renc, big_out), samples=5)
    log(
        f"raw    {len(big)/1e6:.0f}MB: encode {len(big)/te/1e9:.3f} GB/s "
        f"(threaded), decode {len(big)/td/1e9:.3f} GB/s (single-stream)"
    )
    if cpp_snappy.available():
        # Same-machine A/B on the big single raw stream (the reference's
        # 38 MB ssz line, README.md:123, is its strongest decode number);
        # reused output buffer on both sides.
        td_cpp = mean_time(
            lambda: cpp_snappy.decode_into(renc, big_out), samples=5
        )
        log(
            f"raw    {len(big)/1e6:.0f}MB single-stream C++ decode: "
            f"{len(big)/td_cpp/1e9:.3f} GB/s (ours {len(big)/td/1e9:.3f}, "
            f"{td_cpp/td:.2f}x of C++)"
        )

    # Stream adapters at the default 64-frame batch (the reference benches
    # its fastStreams/nimStreams columns too, tests/benchmark.nim): same
    # 47 MB payload through streams/sync.py and streams/aio.py.
    import asyncio
    import io

    from snappy_tpu.streams import aio as saio
    from snappy_tpu.streams import sync as ssync

    class _BufWriter:
        """Reused output buffer with a file-like write (allocation-free)."""

        def __init__(self, size):
            self.buf = bytearray(size)
            self.pos = 0

        def write(self, b):
            n = len(b)
            self.buf[self.pos : self.pos + n] = b
            self.pos += n
            return n

        def reset(self):
            self.pos = 0

    enc_sink = _BufWriter(Cc.max_compressed_len_framed(len(big)))

    def stream_enc():
        enc_sink.reset()
        ssync.compress_framed(io.BytesIO(big), enc_sink)

    tse = mean_time(stream_enc, samples=8)
    dec_sink = _BufWriter(len(big))

    def stream_dec():
        dec_sink.reset()
        ssync.uncompress_framed(io.BytesIO(fenc), dec_sink)

    stream_dec()
    assert bytes(dec_sink.buf[: dec_sink.pos]) == big
    tsd = mean_time(stream_dec, samples=8)
    log(
        f"stream adapters (sync, 47MB framed): encode "
        f"{len(big)/tse/1e9:.3f} GB/s, decode {len(big)/tsd/1e9:.3f} GB/s "
        f"({100*framed_enc_gbps*tse*1e9/len(big):.0f}% / "
        f"{100*framed_dec_gbps*tsd*1e9/len(big):.0f}% of in-memory time)"
    )

    async def aio_dec():
        reader = asyncio.StreamReader()
        reader.feed_data(fenc)
        reader.feed_eof()
        dec_sink.reset()

        class _W:  # minimal StreamWriter stand-in over the reused buffer
            def write(self, b):
                dec_sink.write(b)

            async def drain(self):
                pass

        await saio.uncompress_framed(reader, _W())

    def aio_dec_once():
        asyncio.run(aio_dec())

    aio_dec_once()
    assert bytes(dec_sink.buf[: dec_sink.pos]) == big
    tad = mean_time(aio_dec_once, samples=6)
    log(
        f"stream adapters (asyncio, 47MB framed): decode "
        f"{len(big)/tad/1e9:.3f} GB/s"
    )

    return {
        "framed_encode_gbps": round(framed_enc_gbps, 4),
        "framed_decode_gbps": round(framed_dec_gbps, 4),
        "stream_sync_encode_gbps": round(len(big) / tse / 1e9, 4),
        "stream_sync_decode_gbps": round(len(big) / tsd / 1e9, 4),
        "stream_aio_decode_gbps": round(len(big) / tad / 1e9, 4),
        "corpus_decode_gbps": round(total_b / total_dec / 1e9, 4),
        "corpus_encode_gbps": round(total_b / total_enc / 1e9, 4),
    }


def bench_big(datasets):
    """BASELINE config 3: 1 GiB framed streams — mixed-compressibility
    synthetic plus an incompressible stream — with CRC verification."""
    import snappy_tpu as s
    from snappy_tpu import engine

    log("== 1 GiB framed streams ==")
    corpus_blob = b"".join(datasets.values())
    reps = (1 << 30) // len(corpus_blob) + 1
    mixed = (corpus_blob * reps)[: 1 << 30]
    rng = np.random.default_rng(7)
    incompressible = rng.integers(0, 256, 1 << 30, dtype=np.uint8).tobytes()

    from snappy_tpu.formats import constants as Cc
    from snappy_tpu.ops import host_codec

    for name, payload in [("mixed 1GiB", mixed), ("incompressible 1GiB", incompressible)]:
        enc = engine.framed_compress(payload, backend="host")
        # reused caller buffer, like the decode side and the reference's
        # harness — a fresh ~1 GiB allocation per sample benchmarks page
        # faults, not the codec
        enc_buf = np.empty((Cc.max_compressed_len_framed(len(payload)),), np.uint8)
        te = mean_time(
            lambda: host_codec.framed_compress_into(payload, enc_buf), samples=3
        )
        out = bytearray(len(payload))
        res = s.uncompress_framed_into(enc, out)
        assert res.is_ok() and bytes(out) == payload
        td = mean_time(lambda: s.uncompress_framed_into(enc, out), samples=3)
        log(
            f"{name:22s} ratio={len(enc)/len(payload):.3f} "
            f"encode {len(payload)/te/1e9:.3f} GB/s "
            f"decode {len(payload)/td/1e9:.3f} GB/s"
        )


def device_info() -> dict:
    """Platform, kind and count as JAX reports them, plus the card's name and
    power limit from nvidia-smi.  Fails unless JAX's first device is a GPU."""
    import subprocess

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"device section needs a GPU; JAX found {dev.platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "card": card}


def device_time(fn, samples=10):
    """Median host-clock seconds of warmed calls, each ending in
    block_until_ready."""
    import jax

    jax.block_until_ready(fn())  # compile + warm
    times = []
    for _ in range(samples):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def bench_device(info):
    """Device route on the card: the jitted decode + CRC, encode and CRC
    steps at the engine's 512-chunk slab, and framed decode of a 64 MiB
    stream through the public API."""
    import jax

    import snappy_tpu as s
    from snappy_tpu import config as stpu_config
    from snappy_tpu import engine
    from snappy_tpu.formats import constants as C
    from snappy_tpu.formats import varint
    from snappy_tpu.ops import host_codec
    from snappy_tpu.testing import payloads

    stpu_config.ensure_compilation_cache()
    tag = f"[{info['kind']} x{info['count']}, {info['card']}]"
    log(f"== device route {tag} ==")
    dev = {}
    nb = engine._SLAB
    payload = payloads.mixed(64 << 20, seed=0)
    blob = payload[: nb * C.MAX_BLOCK_LEN]
    bodies, decls = [], []
    for i in range(nb):
        e = host_codec.raw_compress(blob[i * C.MAX_BLOCK_LEN : (i + 1) * C.MAX_BLOCK_LEN])
        _, v = varint.decode_uint32(e)
        bodies.append(e[v:])
        decls.append(C.MAX_BLOCK_LEN)
    comp, cl, dl = (jax.device_put(x) for x in engine.pack_rows(bodies, decls, nb))
    kernel = engine._chunk_kernel()

    t = device_time(lambda: engine._decode_step(comp, cl, dl, kernel=kernel, with_crc=True))
    dev["framed_decode_step_gbps"] = round(len(blob) / t / 1e9, 4)
    log(f"decode + CRC step ({kernel}, {nb} x 64 KiB): {1e3 * t:.3f} ms "
        f"({len(blob) / t / 1e9:.3f} GB/s) {tag}")
    t = device_time(lambda: engine._decode_step(comp, cl, dl, kernel=kernel, with_crc=False))
    dev["chunk_decode_gbps"] = round(len(blob) / t / 1e9, 4)
    log(f"decode step ({kernel}, {nb} x 64 KiB): {1e3 * t:.3f} ms "
        f"({len(blob) / t / 1e9:.3f} GB/s) {tag}")

    blocks, blens = engine._split_blocks(np.frombuffer(blob, np.uint8))
    db, dbl = jax.device_put(blocks), jax.device_put(blens)
    t = device_time(lambda: engine._encode_step(db, dbl, with_crc=True), samples=5)
    dev["framed_encode_step_gbps"] = round(len(blob) / t / 1e9, 4)
    log(f"encode + CRC step ({nb} x 64 KiB): {1e3 * t:.3f} ms "
        f"({len(blob) / t / 1e9:.3f} GB/s) {tag}")
    t = device_time(lambda: engine._crc_chunks_device(db, dbl, C.MAX_BLOCK_LEN))
    dev["crc32c_gbps"] = round(len(blob) / t / 1e9, 4)
    log(f"CRC32C step ({nb} x 64 KiB): {1e3 * t:.3f} ms "
        f"({len(blob) / t / 1e9:.3f} GB/s) {tag}")

    prev_backend = stpu_config.get_backend()
    stpu_config.set_backend("device")
    mib = len(payload) >> 20
    enc = s.encode_framed(payload)
    if s.decode_framed(enc) != payload:
        raise SystemExit("device framed round trip failed")
    t = mean_time(lambda: s.decode_framed(enc), samples=5)
    dev["framed_decode_e2e_gbps"] = round(len(payload) / t / 1e9, 4)
    log(f"decode_framed {mib} MiB end to end: {1e3 * t:.1f} ms "
        f"({len(payload) / t / 1e9:.3f} GB/s) {tag}")
    t = mean_time(lambda: s.encode_framed(payload), samples=3)
    dev["framed_encode_e2e_gbps"] = round(len(payload) / t / 1e9, 4)
    log(f"encode_framed {mib} MiB end to end: {1e3 * t:.1f} ms "
        f"({len(payload) / t / 1e9:.3f} GB/s) {tag}")
    stpu_config.set_backend(prev_backend)
    return dev


def main():
    from snappy_tpu.testing import corpus, payloads

    info = device_info()  # fail before the host section when there is no GPU
    files = corpus.available_corpus()
    if files:
        datasets = {n: corpus.read_data(n) for n in files}
    else:
        log("no corpus available; using seeded synthetic payloads")
        rng = np.random.default_rng(0)
        datasets = {k: payloads.generate(k, 1 << 20, rng) for k in payloads.CLASSES}

    host = bench_host(datasets)
    if BENCH_BIG:
        bench_big(datasets)
    if PROFILE_DIR:
        import jax

        with jax.profiler.trace(PROFILE_DIR):
            dev = bench_device(info)
        log(f"profiler trace written to {PROFILE_DIR}")
    else:
        dev = bench_device(info)

    # Headline: the device framed decode step (decode + CRC of a 512-chunk
    # slab).  ``vs_baseline`` divides by the reference's framed decompress
    # on its largest input (one x86 core).
    value = dev["framed_decode_step_gbps"]
    print(
        json.dumps(
            {
                "metric": "device_framed_decode_step",
                "value": value,
                "unit": "GB/s",
                "vs_baseline": round(value / REF_FRAMED_DEC_GBPS, 4),
                "device": info,
                "device_results": dev,
                "host": host,
            }
        )
    )


if __name__ == "__main__":
    main()
