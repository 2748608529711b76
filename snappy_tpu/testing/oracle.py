"""Scalar reference-algorithm Snappy codec — **test oracle only, not product**.

This module re-derives, in plain Python, the sequential greedy encoder and the
sequential tag-loop decoder that the reference implements in Nim
(/root/reference/snappy/encoder.nim:184-426, /root/reference/snappy/decoder.nim:20-155,
both themselves ports of C++ google/snappy).  It exists to

* generate/validate fixtures for the device kernels (bit-exact decode, size
  yardstick for the encoder: the device encoder's output must decode
  identically and should be no larger than this oracle's output), and
* serve as the differential partner in fuzz tests, playing the role the
  C++ library plays in the reference test suite
  (/root/reference/tests/cpp_snappy.nim).

It is deliberately unoptimized; nothing in the product path imports it.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..formats import constants as C
from ..formats import varint
from ..formats.errors import CodecError

_HASH_MUL = 0x1E35A7BD
_MAX_HASH_TABLE_SIZE = 1 << 14


def _load32(data: bytes, i: int) -> int:
    return data[i] | (data[i + 1] << 8) | (data[i + 2] << 16) | (data[i + 3] << 24)


# ---------------------------------------------------------------------------
# Encoder (algorithm parity: encoder.nim:184-383 / C++ snappy greedy matcher)
# ---------------------------------------------------------------------------


def _emit_literal(out: bytearray, lit: bytes) -> None:
    """Literal tag: 1/2/3-byte headers for len-1 < 60 / < 2^8 / < 2^16
    (encoder.nim:44-73)."""
    n = len(lit) - 1
    if n < 60:
        out.append((n << 2) | C.TAG_LITERAL)
    elif n < (1 << 8):
        out.append((60 << 2) | C.TAG_LITERAL)
        out.append(n & 0xFF)
    else:
        assert n < (1 << 16)
        out.append((61 << 2) | C.TAG_LITERAL)
        out.append(n & 0xFF)
        out.append((n >> 8) & 0xFF)
    out.extend(lit)


def _emit_copy2(out: bytearray, offset: int, length: int) -> None:
    out.append(((length - 1) << 2) | C.TAG_COPY2)
    out.append(offset & 0xFF)
    out.append((offset >> 8) & 0xFF)


def _emit_copy(out: bytearray, offset: int, length: int) -> None:
    """Copy emission with the 68/64/60 long-copy split and the
    copy1-for-short-near-copies rule (encoder.nim:81-125)."""
    while length >= 68:
        _emit_copy2(out, offset, 64)
        length -= 64
    if length > 64:
        _emit_copy2(out, offset, 60)
        length -= 60
    if length >= 12 or offset >= 2048:
        _emit_copy2(out, offset, length)
    else:
        out.append(
            (((offset >> 8) & 0x7) << 5) | (((length - 4) & 0x7) << 2) | C.TAG_COPY1
        )
        out.append(offset & 0xFF)


def _find_match_length(data: bytes, i: int, j: int, limit: int) -> int:
    n = 0
    while j + n < limit and data[i + n] == data[j + n]:
        n += 1
    return n


def encode_block(data: bytes) -> bytes:
    """Greedy-match encode of one block (≤ 64 KiB) to a raw snappy tag stream.

    Algorithm parity with encoder.nim:184-383: lossy 2^8..2^14-entry hash
    table of positions, 32-iteration skip heuristic for incompressible data,
    match extension, literal/copy emission.  Output bytes may differ from the
    reference (both differ from C++ snappy too — the reference's own tests
    only require cross-decodability, test_snappy.nim:50-53); compressed size
    is equivalent because the algorithm is the same.
    """
    assert len(data) <= C.MAX_BLOCK_LEN
    out = bytearray()
    if len(data) < C.MIN_NON_LITERAL_BLOCK_SIZE:
        if data:
            _emit_literal(out, data)
        return bytes(out)

    table_size = 256
    while table_size < _MAX_HASH_TABLE_SIZE and table_size < len(data):
        table_size *= 2
    shift = 32 - table_size.bit_length() + 1
    table = [0] * table_size

    def hsh(u: int) -> int:
        return ((u * _HASH_MUL) & 0xFFFF_FFFF) >> shift

    s_limit = len(data) - C.INPUT_MARGIN
    next_emit = 0
    s = 1

    while True:
        # Probe loop with the 1/32 skip heuristic (encoder.nim:256-331).
        skip = 32
        next_s = s
        while True:
            s = next_s
            step = skip >> 5
            skip += step
            next_s = s + step
            if next_s > s_limit:
                # Emit remainder and finish.
                if next_emit < len(data):
                    _emit_literal(out, data[next_emit:])
                return bytes(out)
            cur = _load32(data, s)
            candidate = table[hsh(cur)]
            table[hsh(cur)] = s
            if cur == _load32(data, candidate):
                break

        if next_emit < s:
            _emit_literal(out, data[next_emit:s])

        # Match extension loop (encoder.nim:340-381).
        while True:
            base = s
            matched = 4 + _find_match_length(data, candidate + 4, s + 4, len(data))
            s += matched
            _emit_copy(out, base - candidate, matched)
            next_emit = s
            if s > s_limit:
                if next_emit < len(data):
                    _emit_literal(out, data[next_emit:])
                return bytes(out)
            prev = _load32(data, s - 1)
            table[hsh(prev)] = s - 1
            cur = _load32(data, s)
            candidate = table[hsh(cur)]
            table[hsh(cur)] = s
            if cur != _load32(data, candidate):
                s += 1
                break


def compress(data: bytes) -> bytes:
    """Raw-format compress: varint length prefix + per-64 KiB encode_block
    (snappy.nim:27-64)."""
    if len(data) > C.MAX_UNCOMPRESSED_LEN:
        raise ValueError("input too large")
    out = bytearray(varint.encode_uint32(len(data)))
    for pos in range(0, len(data), C.MAX_BLOCK_LEN):
        out.extend(encode_block(data[pos : pos + C.MAX_BLOCK_LEN]))
    if len(data) == 0:
        pass  # header-only stream: b"\x00"
    return bytes(out)


# ---------------------------------------------------------------------------
# Decoder (algorithm parity: decoder.nim:20-155)
# ---------------------------------------------------------------------------


def decode_all_tags(
    data: bytes, output_limit: int
) -> Tuple[Optional[bytearray], Optional[CodecError]]:
    """Sequential tag-dispatch decode with full input validation.

    Returns ``(output, None)`` or ``(partial_output, error)``.  Every
    malformed case — truncated tag extensions, literal length wraparound,
    literals overrunning input or output, offset 0, offset beyond written
    output, copies overrunning output — yields ``invalid_input``
    (decoder.nim:39-153).
    """
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        b = data[i]
        tag = b & 3
        if tag == C.TAG_LITERAL:
            lc = b >> 2
            if lc < 60:
                length = lc + 1
                i += 1
            else:
                extra = lc - 59  # 1..4 extension bytes
                if i + 1 + extra > n:
                    return out, CodecError.invalid_input
                value = 0
                for k in range(extra):
                    value |= data[i + 1 + k] << (8 * k)
                if value >= 0xFFFF_FFFF:  # +1 would wrap uint32
                    return out, CodecError.invalid_input
                length = value + 1
                i += 1 + extra
            if length > n - i:
                return out, CodecError.invalid_input
            if length > output_limit - len(out):
                return out, CodecError.invalid_input
            out.extend(data[i : i + length])
            i += length
            continue

        if tag == C.TAG_COPY1:
            if i + 2 > n:
                return out, CodecError.invalid_input
            length = 4 + ((b >> 2) & 0x7)
            offset = ((b & 0xE0) << 3) | data[i + 1]
            i += 2
        elif tag == C.TAG_COPY2:
            if i + 3 > n:
                return out, CodecError.invalid_input
            length = 1 + (b >> 2)
            offset = data[i + 1] | (data[i + 2] << 8)
            i += 3
        else:  # TAG_COPY4
            if i + 5 > n:
                return out, CodecError.invalid_input
            length = 1 + (b >> 2)
            offset = (
                data[i + 1]
                | (data[i + 2] << 8)
                | (data[i + 3] << 16)
                | (data[i + 4] << 24)
            )
            i += 5

        if offset == 0 or offset > len(out):
            return out, CodecError.invalid_input
        if length > output_limit - len(out):
            return out, CodecError.invalid_input
        src = len(out) - offset
        for k in range(length):  # bytewise: handles overlapping copies
            out.append(out[src + k])
    return out, None


def uncompress(data: bytes) -> Tuple[Optional[bytes], Optional[CodecError]]:
    """Raw-format uncompress: varint header, decode, written==header check
    (snappy.nim:84-110)."""
    # Decode-path varint rule: uint32, 5-byte limit (snappy.nim:92).
    value, read = varint.decode_uint32(data)
    if read <= 0 or value is None:
        return None, CodecError.invalid_input
    out, err = decode_all_tags(data[read:], value)
    if err is not None:
        return None, err
    if len(out) != value:
        return None, CodecError.invalid_input
    return bytes(out), None
