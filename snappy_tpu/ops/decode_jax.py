"""Array-parallel Snappy raw-stream decoder (XLA).

The reference decodes with a sequential tag-dispatch loop
(/root/reference/snappy/decoder.nim:20-155).  This decoder re-derives the
same semantics in plain ``jax.numpy`` as three data-parallel phases (the construction follows
the parallel-LZ77 literature, see PAPERS.md "Massively-Parallel Lossless
Data Decompression"):

  Phase 1 — speculative tag parse + pointer-doubling reachability.
    Every byte position is parsed AS IF a tag started there (vectorized),
    yielding a jump function ``next[i]`` = position of the following tag.
    The true tag positions are exactly the set reachable from position 0,
    computed in O(log #tags) scatter/gather rounds by composing the jump
    function with itself.  All of the reference decoder's validation rules
    (truncated extensions, literal wraparound, input/output overrun,
    offset 0, offset beyond written output — decoder.nim:39-153) are
    evaluated as vectorized predicates over the reached set.

  Phase 2 — output mapping.  An exclusive prefix-sum over per-tag output
    lengths assigns each tag its output span; segment ids broadcast per-tag
    data to each output byte.

  Phase 3 — copy resolution by pointer doubling.  Each copy output byte j
    initially points at j - offset; literals are fixpoints.  Overlapping
    copies (the reference's pattern-doubling loop, decoder.nim:130-144)
    become chains that collapse in O(log chain) gather rounds.  A final
    pair of gathers materializes the bytes.

Everything is fixed-shape int32/uint32 math under jit; compressed/output
lengths are runtime scalars, padded sizes are static (bucketed by caller).
It is the device route's chunk decoder on the CPU backend, the whole-stream
decoder for raw streams that cannot be split, and the plain reference the
CUDA chunk decoder (``ops/decode_cuda.py``) is tested against.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_U32 = jnp.uint32
_I32 = jnp.int32


def _parse_all_positions(comp_ext: jnp.ndarray, c_pad: int):
    """Speculatively parse a tag at every position.

    comp_ext: int32 [c_pad + 4] byte values (zero-extended).
    Returns per-position arrays over [0, c_pad):
      consumed (uint32): input bytes a tag starting here consumes
      outlen   (uint32): output bytes it produces
      hdr      (uint32): tag header length (incl. length-extension bytes)
      offset   (uint32): copy offset (0 for literals)
      is_lit   (bool)
      wrap_bad (bool):  literal length extension that would wrap uint32
                        (decoder.nim:54-75 rejects these)
    """
    b = comp_ext[:c_pad].astype(_U32)
    e1 = comp_ext[1 : c_pad + 1].astype(_U32)
    e2 = comp_ext[2 : c_pad + 2].astype(_U32)
    e3 = comp_ext[3 : c_pad + 3].astype(_U32)
    e4 = comp_ext[4 : c_pad + 4].astype(_U32)

    t = b & 3
    lc = b >> 2
    is_lit = t == 0

    # Literal length: 1-byte form for len codes < 60, else 1-4 little-endian
    # extension bytes (len codes 60..63), value+1 (decoder.nim:48-75).
    ex = jnp.clip(lc.astype(_I32) - 59, 0, 4).astype(_U32)
    ext_val = (
        jnp.where(ex >= 1, e1, 0)
        | (jnp.where(ex >= 2, e2, 0) << 8)
        | (jnp.where(ex >= 3, e3, 0) << 16)
        | (jnp.where(ex >= 4, e4, 0) << 24)
    )
    lit_len = jnp.where(lc < 60, lc + 1, ext_val + 1)
    wrap_bad = is_lit & (lc >= 60) & (ext_val == jnp.uint32(0xFFFFFFFF))

    # Copy forms (decoder.nim:87-109).
    copy1_len = 4 + ((lc) & 7)
    copy1_off = ((b & 0xE0) << 3) | e1
    copy2_len = 1 + lc
    copy2_off = e1 | (e2 << 8)
    copy4_len = 1 + lc
    copy4_off = e1 | (e2 << 8) | (e3 << 16) | (e4 << 24)

    hdr = jnp.where(
        is_lit, 1 + ex, jnp.where(t == 1, 2, jnp.where(t == 2, 3, 5))
    ).astype(_U32)
    outlen = jnp.where(
        is_lit, lit_len, jnp.where(t == 1, copy1_len, copy2_len)
    ).astype(_U32)
    offset = jnp.where(
        t == 1, copy1_off, jnp.where(t == 2, copy2_off, jnp.where(t == 3, copy4_off, 0))
    ).astype(_U32)
    consumed = hdr + jnp.where(is_lit, lit_len, 0)
    return consumed, outlen, hdr, offset, is_lit, wrap_bad


def _reachable(next_pos: jnp.ndarray, c_pad: int, comp_len: jnp.ndarray):
    """Mark positions reachable from 0 under the jump function.

    next_pos: int32 [c_pad + 2] with absorbing sentinels DONE=c_pad and
    ERR=c_pad+1 already encoded.  Returns (reached[c_pad] bool, done bool,
    err bool).  Doubling with early exit: after k rounds the reach set
    covers chains of length 2^k.
    """
    size = c_pad + 2
    max_iters = max(1, int(np.ceil(np.log2(size)))) + 1
    reach0 = (
        jnp.zeros((size,), dtype=jnp.int32)
        .at[0]
        .set(jnp.where(comp_len > 0, 1, 0))
    )

    def cond(state):
        it, changed, _, _ = state
        return changed & (it < max_iters)

    def body(state):
        it, _, reach, jmp = state
        # scatter: every reached i marks jmp[i]
        new_reach = reach.at[jmp].max(reach)
        jmp2 = jmp[jmp]
        changed = jnp.any(new_reach != reach)
        return it + 1, changed, new_reach, jmp2

    _, _, reach, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), jnp.bool_(True), reach0, next_pos)
    )
    done = reach[c_pad] > 0
    err = reach[c_pad + 1] > 0
    return reach[:c_pad] > 0, done, err


def _decode_raw_padded(
    comp: jnp.ndarray,
    comp_len: jnp.ndarray,
    out_len: jnp.ndarray,
    u_pad: int,
):
    """Decode one raw tag stream (no varint header).

    comp: int32 [c_pad] byte values, zero-padded beyond comp_len.
    comp_len, out_len: int32 scalars (out_len = expected/declared size).
    u_pad: static output padding, >= max possible out_len.

    Returns (out: uint8 [u_pad], ok: bool, written: int32 — equal to the
    total output the valid tag stream produces).
    """
    c_pad = comp.shape[0]
    comp_ext = jnp.concatenate([comp, jnp.zeros((4,), dtype=comp.dtype)])
    consumed, outlen, hdr, offset, is_lit, wrap_bad = _parse_all_positions(
        comp_ext, c_pad
    )

    idx = jax.lax.broadcasted_iota(_I32, (c_pad, 1), 0).squeeze(-1)
    comp_len_u = comp_len.astype(_U32)
    remaining = comp_len_u - idx.astype(_U32)  # valid where idx < comp_len
    in_range = idx < comp_len
    tag_in_ok = in_range & (consumed <= remaining)

    raw_next = jnp.where(tag_in_ok, idx.astype(_U32) + consumed, 0).astype(_I32)
    nxt = jnp.where(
        tag_in_ok,
        jnp.where(raw_next == comp_len, c_pad, raw_next),
        c_pad + 1,
    )
    jump = jnp.concatenate(
        [nxt, jnp.array([c_pad, c_pad + 1], dtype=_I32)]  # absorbing sentinels
    )
    reached, done, err = _reachable(jump, c_pad, comp_len)

    # Output layout: exclusive prefix sum of per-tag output lengths, with
    # contributions capped so overrun detection stays exact in uint32
    # (out_len < 2^31 and cap <= out_len+1 keeps the first overrunning
    # prefix below 2^32).
    out_len_u = out_len.astype(_U32)
    contrib = jnp.where(reached, jnp.minimum(outlen, out_len_u + 1), 0)
    incl = jnp.cumsum(contrib, dtype=_U32)
    out_start = incl - contrib  # exclusive
    written = jnp.where(c_pad > 0, incl[-1], 0).astype(_I32)

    overrun = jnp.any(reached & (out_start + contrib > out_len_u))
    bad_wrap = jnp.any(reached & wrap_bad)
    # Copy offset rules: offset != 0, offset <= bytes already written
    # (decoder.nim:111-113).
    bad_offset = jnp.any(
        reached & (~is_lit) & ((offset == 0) | (offset > out_start))
    )
    ok = done & (~err) & (~overrun) & (~bad_wrap) & (~bad_offset) & (
        written == out_len
    )

    # ---- Phase 2: per-output-byte mapping --------------------------------
    out_start_i = out_start.astype(_I32)
    scat_idx = jnp.where(reached, out_start_i, u_pad)  # dropped when == u_pad

    # Forward-fill (cummax works: comp positions and out starts both increase
    # along the output axis) the owning tag's comp position and out start.
    seg_comp = (
        jnp.full((u_pad,), -1, dtype=_I32)
        .at[scat_idx]
        .max(jnp.where(reached, idx, -1), mode="drop")
    )
    seg_comp = jax.lax.cummax(seg_comp)
    seg_out0 = (
        jnp.full((u_pad,), -1, dtype=_I32)
        .at[scat_idx]
        .max(jnp.where(reached, out_start_i, -1), mode="drop")
    )
    seg_out0 = jax.lax.cummax(seg_out0)

    seg_comp_c = jnp.clip(seg_comp, 0, c_pad - 1)
    j = jax.lax.broadcasted_iota(_I32, (u_pad, 1), 0).squeeze(-1)
    j_rel = j - jnp.maximum(seg_out0, 0)

    tag_is_lit = is_lit[seg_comp_c]
    tag_hdr = hdr[seg_comp_c].astype(_I32)
    tag_off = offset[seg_comp_c].astype(_I32)

    lit_src = seg_comp_c + tag_hdr + j_rel  # comp index of this literal byte
    ptr0 = jnp.where(tag_is_lit, j, jnp.clip(j - jnp.maximum(tag_off, 1), 0, u_pad - 1))

    # ---- Phase 3: resolve copy chains by pointer doubling ----------------
    max_iters = max(1, int(np.ceil(np.log2(u_pad)))) + 1

    def cond(state):
        it, changed, _ = state
        return changed & (it < max_iters)

    def body(state):
        it, _, p = state
        p2 = p[p]
        return it + 1, jnp.any(p2 != p), p2

    _, _, ptr = jax.lax.while_loop(cond, body, (jnp.int32(0), jnp.bool_(True), ptr0))

    src = jnp.clip(lit_src[ptr], 0, c_pad + 3)
    out_bytes = comp_ext[src].astype(jnp.uint8)
    out_bytes = jnp.where(j < out_len, out_bytes, 0)
    return out_bytes, ok, written


@functools.partial(jax.jit, static_argnums=(3,))
def decode_raw(comp, comp_len, out_len, u_pad: int):
    """Jitted whole-stream decode.  See ``_decode_raw_padded``."""
    return _decode_raw_padded(comp, comp_len, out_len, u_pad)


@functools.partial(jax.jit, static_argnums=(3,))
def decode_chunks(comp, comp_lens, out_lens, u_pad: int):
    """Batched decode of independent tag streams (framed chunks).

    comp: int32 [N, c_pad]; comp_lens/out_lens: int32 [N].
    Returns (out uint8 [N, u_pad], ok bool [N], written int32 [N]).
    """
    return jax.vmap(lambda c, cl, ol: _decode_raw_padded(c, cl, ol, u_pad))(
        comp, comp_lens, out_lens
    )
