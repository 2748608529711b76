"""Seeded synthetic payloads for smoke runs and benchmarks (numpy, fast).

The classes follow ``tools/gen_corpus.py``'s regimes, vectorised so that
tens of MiB take well under a second:

* ``text``    -- English-like words with Zipf-like reuse (copy-rich);
* ``markup``  -- HTML-ish tags with varying attribute numbers (mixed);
* ``records`` -- CSV rows of ids, timestamps, names, amounts (structured);
* ``random``  -- incompressible bytes (stored verbatim by the framed encoder);
* ``runs``    -- single-byte runs of 30..4000 bytes (overlapping copies).

Everything derives from the ``numpy.random.Generator`` passed in, so one
seed gives the same bytes on every machine.
"""

from __future__ import annotations

from typing import List

import numpy as np

CLASSES = ("text", "markup", "records", "random", "runs")
_LETTERS = np.frombuffer(b"etaoinshrdlucmfwypvbgkjqxz", np.uint8)


def _vocab(words: List[bytes]):
    """Pack words into a [k, maxlen + 1] table with a trailing separator."""
    width = max(len(w) for w in words) + 1
    table = np.zeros((len(words), width), np.uint8)
    lens = np.empty(len(words), np.int64)
    for i, w in enumerate(words):
        table[i, : len(w)] = np.frombuffer(w, np.uint8)
        lens[i] = len(w)
    return table, lens


def _zipf_stream(rng, table, lens, sep: int, size: int) -> bytes:
    """Concatenate Zipf-like draws from ``table`` separated by ``sep``."""
    avg = float(lens.mean()) + 1
    k = int(size / avg * 1.2) + 16
    ids = np.minimum(rng.exponential(80.0, k).astype(np.int64), len(lens) - 1)
    wl = lens[ids] + (1 if sep >= 0 else 0)
    starts = np.cumsum(wl) - wl
    total = int(wl.sum())
    wid = np.repeat(ids, wl)
    pos = np.arange(total, dtype=np.int64) - np.repeat(starts, wl)
    out = table[wid, pos]
    if sep >= 0:
        out[pos == lens[wid]] = sep
    return out[:size].tobytes()


def _text(rng, size):
    words = []
    for _ in range(800):
        n = int(rng.integers(2, 12))
        words.append(_LETTERS[rng.integers(0, len(_LETTERS), n)].tobytes())
    table, lens = _vocab(words)
    return _zipf_stream(rng, table, lens, ord(" "), size)


def _markup(rng, size):
    forms = (b"<div class='r%d'>", b"<span id='x%d'>", b"<a href='/p/%d'>",
             b"<td>%d</td>", b"</div>", b"</span>\n")
    tags = []
    for _ in range(2000):
        f = forms[int(rng.integers(len(forms)))]
        tags.append(f % int(rng.integers(1000)) if b"%d" in f else f)
    table, lens = _vocab(tags)
    return _zipf_stream(rng, table, lens, -1, size)


def _digits(values: np.ndarray, width: int) -> np.ndarray:
    """Zero-padded decimal digits of non-negative ints: [n, width] uint8."""
    pw = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    return (ord("0") + (values[:, None] // pw) % 10).astype(np.uint8)


def _records(rng, size):
    names = [b"alice", b"bob", b"carol", b"dave", b"erin", b"frank", b"grace",
             b"heidi", b"ivan", b"judy", b"mallory", b"niaj", b"olivia"]
    status = [b"ok", b"pending", b"failed", b"refunded"]
    ntab, _ = _vocab([n.ljust(8) for n in names])
    stab, _ = _vocab([s.ljust(8) for s in status])
    row = 8 + 1 + 10 + 1 + 8 + 1 + 9 + 1 + 8 + 1
    k = size // row + 1
    start = int(rng.integers(1, 10**6))
    cols = [
        _digits(start + np.arange(k, dtype=np.int64), 8),
        _digits(1_700_000_000 + np.cumsum(rng.integers(0, 40, k)), 10),
        ntab[rng.integers(0, len(names), k), :8],
        _digits(rng.integers(0, 10**9, k), 9),
        stab[rng.integers(0, len(status), k), :8],
    ]
    sep = np.full((k, 1), ord(","), np.uint8)
    parts = []
    for c in cols:
        parts += [c, sep]
    parts[-1] = np.full((k, 1), ord("\n"), np.uint8)
    return np.hstack(parts).reshape(-1)[:size].tobytes()


def _random(rng, size):
    return rng.integers(0, 256, size, dtype=np.uint8).tobytes()


def _runs(rng, size):
    k = size // 30 + 1
    lens = rng.integers(30, 4001, k)
    vals = rng.integers(0, 256, k, dtype=np.uint8)
    return np.repeat(vals, lens)[:size].tobytes()


_GEN = {"text": _text, "markup": _markup, "records": _records,
        "random": _random, "runs": _runs}


def generate(kind: str, size: int, rng: np.random.Generator) -> bytes:
    """``size`` bytes of payload class ``kind`` (one of ``CLASSES``)."""
    if size <= 0:
        return b""
    return _GEN[kind](rng, size)


def mixed(size: int, seed: int, piece: int = 1 << 20) -> bytes:
    """``size`` bytes of ``piece``-sized runs of every class, in seeded order."""
    rng = np.random.default_rng(seed)
    parts, total = [], 0
    while total < size:
        kind = CLASSES[int(rng.integers(len(CLASSES)))]
        n = min(piece, size - total)
        parts.append(generate(kind, n, rng))
        total += n
    return b"".join(parts)


def batch_sizes(n: int, lo: int, hi: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` sizes drawn log-uniform from [lo, hi]."""
    return np.exp(rng.uniform(np.log(lo), np.log(hi), n)).astype(np.int64)
