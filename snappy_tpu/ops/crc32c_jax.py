"""Device CRC32C for framed chunks — lane-parallel with GF(2) combine.

The reference computes CRC32C byte-sequentially in C (slicing-by-8,
/root/reference/snappy/crc32c.c:677-731).  A byte-serial loop leaves a wide
device idle, so this kernel exploits the linearity of CRC over GF(2):

1. split each (zero-padded) chunk into L lanes of S=64 bytes and run the
   table-driven register update on all lanes *in parallel* (16 sequential
   steps of slicing-by-4, each a vectorized 256-entry table gather);
2. combine lane registers with a log2(L)-level fold using precomputed
   32x32 GF(2) "advance by 2^j bytes" matrices (the zlib crc32_combine
   construction), applied as 32 masked XORs;
3. cancel the zero padding with precomputed *inverse* shift matrices
   selected by the bits of the pad length — so one fixed-shape kernel
   serves every chunk length;
4. apply the snappy masking rotr15 + 0xa282ead8
   (/root/reference/snappy/framing_format.txt:39-58).

Everything is uint32 integer math: exact, no device<->host round trips, and
batched over all chunks of a framed stream at once.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_POLY_REFLECTED = np.uint32(0x82F63B78)
_MASK_DELTA = np.uint32(0xA282EAD8)
# Bytes per lane: one 32-bit word per lane maximizes parallelism (no
# sequential word loop at all; the GF(2) combine tree absorbs the extra
# levels).
_LANE_BYTES = 4


# ---------------------------------------------------------------------------
# Host-side precompute: tables and GF(2) matrices (numpy, runs once)
# ---------------------------------------------------------------------------


@functools.cache
def _tables() -> np.ndarray:
    """Slicing-by-4 tables T[0..3], each 256 x uint32."""
    t = np.zeros((4, 256), dtype=np.uint64)
    for i in range(256):
        c = np.uint64(i)
        for _ in range(8):
            c = (c >> np.uint64(1)) ^ (
                np.uint64(_POLY_REFLECTED) if c & np.uint64(1) else np.uint64(0)
            )
        t[0, i] = c
    for k in range(1, 4):
        for i in range(256):
            t[k, i] = (t[k - 1, i] >> np.uint64(8)) ^ t[0, int(t[k - 1, i] & np.uint64(0xFF))]
    return t.astype(np.uint32)


def _mat_apply_np(mat: np.ndarray, vec: int) -> int:
    """Apply a GF(2) 32x32 matrix (32 uint32 columns) to a register value."""
    acc = 0
    v = int(vec)
    for i in range(32):
        if (v >> i) & 1:
            acc ^= int(mat[i])
    return acc


def _gf2_matmul_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.array([_mat_apply_np(a, int(col)) for col in b], dtype=np.uint32)


def _gf2_inverse_np(mat: np.ndarray) -> np.ndarray:
    """Invert a 32x32 GF(2) matrix by Gaussian elimination on bit rows."""
    # rows[i] = (mat_row_i : identity_row_i) as 64-bit ints; columns of `mat`
    # are register images of unit vectors, so bit j of column i is M[j][i].
    n = 32
    rows = []
    for r in range(n):
        m_bits = 0
        for c in range(n):
            if (int(mat[c]) >> r) & 1:
                m_bits |= 1 << c
        rows.append(m_bits | (1 << (n + r)))
    for col in range(n):
        piv = next(r for r in range(col, n) if (rows[r] >> col) & 1)
        rows[col], rows[piv] = rows[piv], rows[col]
        for r in range(n):
            if r != col and (rows[r] >> col) & 1:
                rows[r] ^= rows[col]
    inv = np.zeros(n, dtype=np.uint32)
    for c in range(n):  # column c of the inverse
        bits = 0
        for r in range(n):
            if (rows[r] >> (n + c)) & 1:
                bits |= 1 << r
        inv[c] = bits
    return inv


@functools.cache
def _shift_matrices():
    """Forward/inverse 'advance register by 2^j zero bytes' matrices.

    Returns (fwd, inv): each a list of 32-uint32-column matrices for
    j = 0..16 (shift by 1, 2, 4, ..., 65536 bytes).
    """
    t0 = _tables()[0].astype(np.uint64)
    # Shift-by-one-byte operator: c' = (c >> 8) ^ T0[c & 0xff]
    m1 = np.array(
        [
            ((np.uint64(1 << i) >> np.uint64(8)) ^ t0[(1 << i) & 0xFF]) & np.uint64(0xFFFFFFFF)
            for i in range(32)
        ],
        dtype=np.uint32,
    )
    fwd = [m1]
    for _ in range(16):
        fwd.append(_gf2_matmul_np(fwd[-1], fwd[-1]))
    m1_inv = _gf2_inverse_np(m1)
    inv = [m1_inv]
    for _ in range(16):
        inv.append(_gf2_matmul_np(inv[-1], inv[-1]))
    return fwd, inv


@functools.cache
def _shift_matrix_bytes(k: int) -> np.ndarray:
    """Forward shift matrix for exactly k zero bytes (k >= 0)."""
    fwd, _ = _shift_matrices()
    acc = np.array([np.uint32(1 << i) for i in range(32)], dtype=np.uint32)  # identity
    j = 0
    while k:
        if k & 1:
            acc = _gf2_matmul_np(fwd[j], acc)
        k >>= 1
        j += 1
    return acc


@functools.cache
def _init_term(padded_len: int) -> np.uint32:
    """S_P(0xFFFFFFFF): the init register advanced across the whole padded
    chunk; XORed into the folded lane registers."""
    return np.uint32(_mat_apply_np(_shift_matrix_bytes(padded_len), 0xFFFFFFFF))


# ---------------------------------------------------------------------------
# Device kernel
# ---------------------------------------------------------------------------


def _mat_apply_jnp(cols: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Apply a GF(2) matrix (32 uint32 columns) to a batch of registers.

    One broadcasted select + XOR-reduce keeps the graph small (an unrolled
    32-step loop made remote compiles pathologically slow)."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (v[..., None] >> shifts) & jnp.uint32(1)  # [..., 32]
    terms = (jnp.uint32(0) - bits) & cols  # [..., 32]
    return jax.lax.reduce(
        terms, jnp.uint32(0), jax.lax.bitwise_xor, dimensions=(terms.ndim - 1,)
    )


def _lane_registers(chunk_u32: jnp.ndarray) -> jnp.ndarray:
    """Zero-init CRC register per 64-byte lane.

    chunk_u32: [L, 64] int32 byte values -> uint32 [L].

    Bit-serial formulation: instead of the classic table step ``(c >> 8) ^
    T[(c ^ b) & 0xff]`` (a 256-entry gather per byte) the LFSR is clocked
    one bit at a time with pure XOR/shift/mask ops, elementwise across all
    lanes x chunks.  Bits of a little-endian 32-bit load are already in CRC
    order (LSB-first per byte, bytes in order).
    """
    lanes = chunk_u32.shape[0]
    c0 = jnp.zeros((lanes,), dtype=jnp.uint32)
    poly = jnp.uint32(_POLY_REFLECTED)

    def word_step(i, c):
        b = jax.lax.dynamic_slice_in_dim(chunk_u32, i * 4, 4, axis=1)
        x = c ^ (
            b[:, 0].astype(jnp.uint32)
            | (b[:, 1].astype(jnp.uint32) << 8)
            | (b[:, 2].astype(jnp.uint32) << 16)
            | (b[:, 3].astype(jnp.uint32) << 24)
        )
        # 32 LFSR clocks; after them the remaining high bits of x are zero.
        def clock(_, x):
            m = x & jnp.uint32(1)
            return (x >> 1) ^ ((jnp.uint32(0) - m) & poly)

        return jax.lax.fori_loop(0, 32, clock, x)

    return jax.lax.fori_loop(0, _LANE_BYTES // 4, word_step, c0)


def _crc32c_padded(chunk_bytes: jnp.ndarray, length: jnp.ndarray, padded_len: int):
    """CRC32C of chunk_bytes[:length].

    chunk_bytes: int32 [padded_len] byte values; bytes at index >= length
    MUST be zero (the caller zero-pads).  length: int32 scalar.
    Returns the unmasked standard CRC32C as uint32.
    """
    assert padded_len % _LANE_BYTES == 0 and padded_len > 0
    lanes = padded_len // _LANE_BYTES
    assert lanes & (lanes - 1) == 0, "padded_len must be 64 * power-of-two"
    regs = _lane_registers(chunk_bytes.reshape(lanes, _LANE_BYTES))

    # Fold lanes pairwise; at level j the right half spans LANE_BYTES*2^j
    # bytes.
    fwd, inv = _shift_matrices()
    lane_log2 = _LANE_BYTES.bit_length() - 1
    level = 0
    while regs.shape[0] > 1:
        cols = jnp.asarray(fwd[lane_log2 + level])
        left, right = regs[0::2], regs[1::2]
        regs = _mat_apply_jnp(cols, left) ^ right
        level += 1
    reg = regs[0] ^ jnp.uint32(_init_term(padded_len))

    # Cancel the zero tail: advance by -(padded_len - length) bytes.
    pad = (jnp.int32(padded_len) - length).astype(jnp.uint32)
    for j in range(17):
        cols = jnp.asarray(inv[j])
        bit = (pad >> jnp.uint32(j)) & jnp.uint32(1)
        reg = jnp.where(bit == 1, _mat_apply_jnp(cols, reg[None])[0], reg)
    return reg ^ jnp.uint32(0xFFFFFFFF)


def mask_crc(crc: jnp.ndarray) -> jnp.ndarray:
    """Snappy CRC masking (framing_format.txt:39-58)."""
    crc = crc.astype(jnp.uint32)
    return ((crc >> 15) | (crc << 17)) + _MASK_DELTA


@functools.partial(jax.jit, static_argnums=(2,))
def crc32c_chunks(chunks: jnp.ndarray, lengths: jnp.ndarray, padded_len: int):
    """Unmasked CRC32C for a batch of chunks.

    chunks: int32 [N, padded_len] byte values, zero-padded past lengths[i].
    lengths: int32 [N].  Returns uint32 [N].
    """
    return jax.vmap(lambda c, n: _crc32c_padded(c, n, padded_len))(chunks, lengths)


@functools.partial(jax.jit, static_argnums=(2,))
def masked_crc32c_chunks(chunks: jnp.ndarray, lengths: jnp.ndarray, padded_len: int):
    """Masked CRC32C (as stored in framed chunks) for a batch of chunks."""
    return mask_crc(crc32c_chunks(chunks, lengths, padded_len))


def crc32c(data: bytes) -> int:
    """Convenience scalar entry point (pads to a lane multiple)."""
    n = len(data)
    lanes = max(1, -(-n // _LANE_BYTES))
    lanes = 1 << (lanes - 1).bit_length()  # next power of two
    padded = lanes * _LANE_BYTES
    buf = np.zeros((1, padded), dtype=np.int32)
    buf[0, :n] = np.frombuffer(data, dtype=np.uint8)
    return int(crc32c_chunks(jnp.asarray(buf), jnp.asarray([n], dtype=jnp.int32), padded)[0])
