/* Native host Snappy codec — the framework's CPU runtime path.
 *
 * Role parity: the reference keeps its hot loops in native code compiled
 * into the host library (encoder.nim/decoder.nim compile to C; crc32c.c is
 * C).  This file is the equivalent for snappy_tpu: a scalar block encoder
 * (greedy matcher with a positional hash table and skip heuristic, the same
 * algorithm family as /root/reference/snappy/encoder.nim:184-383) and a
 * validating raw-stream decoder (tag-dispatch loop with the same rejection
 * rules as /root/reference/snappy/decoder.nim:20-155), written from the
 * format specification.
 *
 * The Python engine fans block spans out over threads (ctypes releases the
 * GIL), so throughput scales with host cores; the device route's kernels
 * (ops/decode_cuda.py, ops/encode_jax.py) serve device-resident data.  Little-endian hosts only (the reference has the
 * same restriction, encoder.nim:127-128).
 */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#define MAX_BLOCK 65536u
#define INPUT_MARGIN 15u
#define MIN_NON_LITERAL 17u
/* 14 bits = 32 KiB of table: fits L1 on typical hosts (the 15-bit variant
 * compresses ~0.5% better but costs up to 60% throughput on cache-limited
 * cores); matches the reference's maxTableSize (encoder.nim:10-12). */
#define TABLE_BITS 14
#define TABLE_SIZE (1u << TABLE_BITS)

static inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}
static inline uint64_t load64(const uint8_t* p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
}
static inline uint32_t hash32(uint32_t u, int shift) {
  return (u * 0x1E35A7BDu) >> shift;
}

/* ---------------- encoder ---------------- */

static inline uint8_t* emit_literal(uint8_t* op, const uint8_t* lit, uint32_t len,
                                    const uint8_t* in_end) {
  uint32_t n = len - 1;
  if (n < 60) {
    *op++ = (uint8_t)(n << 2);
    /* Blind constant-size bursts for short literals (inlined vector
     * moves; a variable-size memcpy pays dispatch): the output overshoot
     * stays within the <=16-byte tolerance max_compressed_len provides
     * (encoder.nim:186-191), and reads stay inside the caller's input. */
    if (len <= 16 && lit + 16 <= in_end) {
      memcpy(op, lit, 16);
      return op + len;
    }
    if (len <= 32 && lit + 32 <= in_end) {
      memcpy(op, lit, 16);
      memcpy(op + 16, lit + 16, 16);
      return op + len;
    }
  } else if (n < 256) {
    *op++ = 60 << 2;
    *op++ = (uint8_t)n;
  } else {
    *op++ = 61 << 2;
    *op++ = (uint8_t)(n & 0xFF);
    *op++ = (uint8_t)(n >> 8);
  }
  memcpy(op, lit, len);
  return op + len;
}

static inline uint8_t* emit_copy2(uint8_t* op, uint32_t offset, uint32_t len) {
  *op++ = (uint8_t)(((len - 1) << 2) | 2);
  *op++ = (uint8_t)(offset & 0xFF);
  *op++ = (uint8_t)(offset >> 8);
  return op;
}

static inline uint8_t* emit_copy(uint8_t* op, uint32_t offset, uint32_t len) {
  /* 68/64/60 long-copy split + copy1 for short near copies
   * (contract parity: encoder.nim:81-125). */
  while (len >= 68) {
    op = emit_copy2(op, offset, 64);
    len -= 64;
  }
  if (len > 64) {
    op = emit_copy2(op, offset, 60);
    len -= 60;
  }
  if (len >= 12 || offset >= 2048) {
    op = emit_copy2(op, offset, len);
  } else {
    *op++ = (uint8_t)(((offset >> 8) << 5) | (((len - 4) & 7) << 2) | 1);
    *op++ = (uint8_t)(offset & 0xFF);
  }
  return op;
}

static inline uint32_t match_length(const uint8_t* s1, const uint8_t* s2,
                                    const uint8_t* limit) {
  const uint8_t* start = s2;
  while (s2 + 8 <= limit) {
    uint64_t x = load64(s1) ^ load64(s2);
    if (x) return (uint32_t)(s2 - start) + (uint32_t)(__builtin_ctzll(x) >> 3);
    s1 += 8;
    s2 += 8;
  }
  while (s2 < limit && *s1 == *s2) {
    s1++;
    s2++;
  }
  return (uint32_t)(s2 - start);
}

/* Encode one block (<= 64 KiB) into out; returns encoded length.
 * out must have room for max_compressed_len(n) bytes.
 *
 * `ways` (compile-time-specialized) selects the candidate table shape:
 * 1 = single entry per hash bucket (the reference's table, fastest);
 * 2 = two-entry LRU buckets (~0.5-2% denser output, ~10-15% slower) —
 * a level knob the reference does not offer. */
static inline uint32_t encode_block_impl(const uint8_t* in, uint32_t n,
                                         uint8_t* out, uint16_t* table,
                                         const int ways) {
  uint8_t* op = out;
  if (n < MIN_NON_LITERAL) {
    if (n) op = emit_literal(op, in, n, in + n);
    return (uint32_t)(op - out);
  }

  uint32_t table_size = 256;
  while (table_size < TABLE_SIZE && table_size < n) table_size <<= 1;
  int shift = 32 - __builtin_ctz(table_size);
  memset(table, 0, (size_t)ways * table_size * sizeof(uint16_t));

  const uint8_t* base = in;
  const uint8_t* ip = in + 1;
  const uint8_t* ip_limit = in + n - INPUT_MARGIN;
  const uint8_t* next_emit = in;
  const uint8_t* in_end = in + n;

  for (;;) {
    uint32_t skip = 32;
    const uint8_t* next_ip = ip;
    const uint8_t* candidate;

    /* probe loop with 1/32 skip heuristic (encoder.nim:256-331); the
     * reference's unrolled 4x4 dense phase was tried and measured slower
     * on this host's cores, so probes stay uniform */
    for (;;) {
      ip = next_ip;
      uint32_t step = skip >> 5;
      skip += step;
      next_ip = ip + step;
      if (next_ip > ip_limit) {
        if (next_emit < in_end)
          op = emit_literal(op, next_emit, (uint32_t)(in_end - next_emit), in_end);
        return (uint32_t)(op - out);
      }
      uint32_t cur = load32(ip);
      uint32_t h = hash32(cur, shift);
      if (ways == 1) {
        candidate = base + table[h];
        table[h] = (uint16_t)(ip - base);
        if (cur == load32(candidate)) break;
      } else {
        const uint8_t* c1 = base + table[2 * h];
        const uint8_t* c2 = base + table[2 * h + 1];
        table[2 * h + 1] = table[2 * h];
        table[2 * h] = (uint16_t)(ip - base);
        if (cur == load32(c1)) { candidate = c1; break; }
        if (cur == load32(c2)) { candidate = c2; break; }
      }
    }


    if (next_emit < ip)
      op = emit_literal(op, next_emit, (uint32_t)(ip - next_emit), in_end);

    /* match extension loop (encoder.nim:340-381) */
    for (;;) {
      const uint8_t* match_base = ip;
      uint32_t matched = 4 + match_length(candidate + 4, ip + 4, in_end);
      ip += matched;
      op = emit_copy(op, (uint32_t)(match_base - candidate), matched);
      next_emit = ip;
      if (ip > ip_limit) {
        if (next_emit < in_end)
          op = emit_literal(op, next_emit, (uint32_t)(in_end - next_emit), in_end);
        return (uint32_t)(op - out);
      }
      uint32_t prev = load32(ip - 1);
      uint32_t hp = hash32(prev, shift);
      uint32_t cur = load32(ip);
      uint32_t h = hash32(cur, shift);
      if (ways == 1) {
        table[hp] = (uint16_t)(ip - 1 - base);
        candidate = base + table[h];
        table[h] = (uint16_t)(ip - base);
        if (cur != load32(candidate)) {
          ip++;
          break;
        }
      } else {
        table[2 * hp + 1] = table[2 * hp];
        table[2 * hp] = (uint16_t)(ip - 1 - base);
        const uint8_t* c1 = base + table[2 * h];
        const uint8_t* c2 = base + table[2 * h + 1];
        table[2 * h + 1] = table[2 * h];
        table[2 * h] = (uint16_t)(ip - base);
        if (cur == load32(c1)) { candidate = c1; }
        else if (cur == load32(c2)) { candidate = c2; }
        else { ip++; break; }
      }
    }
  }
}

uint32_t stpu_encode_block(const uint8_t* in, uint32_t n, uint8_t* out,
                           uint16_t* table /* TABLE_SIZE entries, scratch */) {
  return encode_block_impl(in, n, out, table, 1);
}

uint32_t stpu_encode_block_l2(const uint8_t* in, uint32_t n, uint8_t* out,
                              uint16_t* table /* 2*TABLE_SIZE entries */) {
  return encode_block_impl(in, n, out, table, 2);
}

/* Encode a span of full blocks: writes concatenated block streams (no
 * varint header).  Returns total bytes written. */
size_t stpu_encode_span_level(const uint8_t* in, size_t n, uint8_t* out,
                              int level) {
  uint16_t table[2 * TABLE_SIZE];
  size_t written = 0;
  size_t pos = 0;
  while (pos < n) {
    uint32_t blen = (uint32_t)((n - pos < MAX_BLOCK) ? (n - pos) : MAX_BLOCK);
    written += (level >= 2)
                   ? stpu_encode_block_l2(in + pos, blen, out + written, table)
                   : stpu_encode_block(in + pos, blen, out + written, table);
    pos += blen;
  }
  return written;
}

size_t stpu_encode_span(const uint8_t* in, size_t n, uint8_t* out) {
  return stpu_encode_span_level(in, n, out, 1);
}

/* ---------------- decoder ---------------- */

/* Decode a raw tag stream (no varint header) into out[0..out_len).
 * Returns 0 on success (and *written == produced bytes), -1 on malformed
 * input.  Validation parity: decoder.nim:39-153.  Technique parity with
 * the reference's fast paths: unconditional 16-byte literal copies when
 * both sides have slack (decoder.nim:48-52), two-8-byte-word copy
 * expansion (decoder.nim:117-125), pattern-doubling for overlapping
 * copies with slack (decoder.nim:130-144), bytewise near the end. */
#define LIKELY(x) __builtin_expect(!!(x), 1)
#define UNLIKELY(x) __builtin_expect(!!(x), 0)

/* Fast-loop tag entry LUT: one entry gives trailer
 * byte count, op length and the copy-1 offset base, and one masked
 * unaligned 4-byte load serves the copy-1/2/4 offset alike, replacing
 * the tag-type branch chain (2-3 data-dependent mispredicts per op on
 * text) with a single literal-vs-copy branch.
 * Packing: trailer_bytes(3b) | len(8b << 4) | offset_base(11b << 12);
 * len == 0 marks the length-extended literals (slow path). */
static uint32_t dec_lut[256];
static uint32_t dec_wordmask[5] = {0, 0xFF, 0xFFFF, 0xFFFFFF, 0xFFFFFFFFu};
static int dec_lut_ready = 0;

static void dec_lut_init(void) {
  for (uint32_t c = 0; c < 256; c++) {
    uint32_t t = c & 3, e;
    if (t == 0) {
      uint32_t lc = c >> 2;
      e = lc < 60 ? (lc + 1) << 4 : (lc - 59); /* ext: len=0, tb=extra */
    } else if (t == 1) {
      e = 1 | ((4 + ((c >> 2) & 7)) << 4) | (((c & 0xE0) << 3) << 12);
    } else if (t == 2) {
      e = 2 | ((1 + (c >> 2)) << 4);
    } else {
      e = 4 | ((1 + (c >> 2)) << 4);
    }
    dec_lut[c] = e;
  }
  dec_lut_ready = 1;
}

int stpu_decode_tags(const uint8_t* in, size_t n, uint8_t* out, size_t out_len,
                     size_t* written) {
  size_t i = 0;
  size_t o = 0;
  if (!dec_lut_ready) dec_lut_init();

  /* Fast region: enough input slack to read tags + a 64B literal burst
   * blindly and enough output slack that any single op (<=64B copy or
   * literal burst) stays in bounds without per-op checks. */
  const size_t in_fast = n > 80 ? n - 80 : 0;
  const size_t out_fast = out_len > 96 ? out_len - 96 : 0;

  while (i < in_fast && o < out_fast) {
    uint32_t b = in[i];
    uint32_t e = dec_lut[b];
    uint32_t tb = e & 7;
    uint32_t w;
    memcpy(&w, in + i + 1, 4); /* blind trailer load (in_fast margin) */
    uint32_t trailer = w & dec_wordmask[tb];
    size_t len = (e >> 4) & 0xFF;
    if ((b & 3) == 0) {
      if (LIKELY(len)) {
        if (UNLIKELY(len > n - i - 1)) return -1;
        /* blind constant-size bursts (inlined vector moves) cover every
         * short-literal length: 16B for len <= 16, else 64B (len <= 60;
         * in_fast leaves 80B of input slack, out_fast 96B of output) */
        memcpy(out + o, in + i + 1, 16);
        if (UNLIKELY(len > 16)) {
          memcpy(out + o + 16, in + i + 17, 16);
          memcpy(out + o + 32, in + i + 33, 32);
        }
        i += 1 + len;
        o += len;
        continue;
      }
      /* length-extended literal (trailer = 1-4 LE length bytes); exact
       * checks since the length is unbounded */
      if (UNLIKELY(trailer >= 0xFFFFFFFFu)) return -1;
      len = (size_t)trailer + 1;
      i += 1 + tb;
      if (UNLIKELY(len > n - i)) return -1;
      if (UNLIKELY(len > out_len - o)) return -1;
      memcpy(out + o, in + i, len);
      i += len;
      o += len;
      continue;
    }
    uint32_t offset = (e >> 12) + trailer;
    i += 1 + tb;
    if (UNLIKELY(offset == 0 || (size_t)offset > o)) return -1;
    const uint8_t* src = out + o - offset;
    uint8_t* dst = out + o;
    o += len;
    if (LIKELY(offset >= 8)) {
      memcpy(dst, src, 8); /* blind 16B stamp covers len <= 16 */
      memcpy(dst + 8, src + 8, 8);
      if (UNLIKELY(len > 16)) {
        if (LIKELY(offset >= 32)) {
          /* blind constant-size 64B copy (copies cap at len 64; chunk 2
           * reads only bytes chunk 1 already committed when offset<64) */
          memcpy(dst, src, 32);
          memcpy(dst + 32, src + 32, 32);
        } else if (offset >= len) {
          memcpy(dst, src, len);
        } else {
          size_t remaining = len, avail = offset;
          uint8_t* d = dst;
          while (remaining > 0) {
            size_t take = avail < remaining ? avail : remaining;
            memcpy(d, src, take);
            d += take;
            remaining -= take;
            avail += take;
          }
        }
      }
      continue;
    }
    if (offset == 1) {
      memset(dst, src[0], len);
      continue;
    }
    {
      size_t remaining = len, avail = offset;
      uint8_t* d = dst;
      while (remaining > 0) {
        size_t take = avail < remaining ? avail : remaining;
        memcpy(d, src, take);
        d += take;
        remaining -= take;
        avail += take;
      }
    }
  }

  /* Careful loop: exact bounds checks for the stream tail (and for
   * length-extended literals, which re-enter here). */
  while (i < n) {
    uint32_t b = in[i];
    uint32_t tag = b & 3;
    if (tag == 0) { /* literal */
      uint32_t lc = b >> 2;
      uint64_t len;
      if (lc < 60) {
        len = lc + 1;
        i += 1;
        /* fast path: 16-byte blind copy when both sides have 16B slack */
        if (len <= 16 && i + 16 <= n && o + 16 <= out_len) {
          memcpy(out + o, in + i, 16);
          o += len;
          i += len;
          continue;
        }
      } else {
        uint32_t extra = lc - 59; /* 1..4 */
        if (i + 1 + extra > n) return -1;
        uint32_t v = 0;
        for (uint32_t k = 0; k < extra; k++) v |= (uint32_t)in[i + 1 + k] << (8 * k);
        if (v >= 0xFFFFFFFFu) return -1; /* +1 would wrap uint32 */
        len = (uint64_t)v + 1;
        i += 1 + extra;
      }
      if (len > n - i) return -1;
      if (len > out_len - o) return -1;
      memcpy(out + o, in + i, len);
      o += len;
      i += len;
      continue;
    }
    uint32_t len, offset;
    if (tag == 1) {
      if (i + 2 > n) return -1;
      len = 4 + ((b >> 2) & 7);
      offset = ((b & 0xE0) << 3) | in[i + 1];
      i += 2;
    } else if (tag == 2) {
      if (i + 3 > n) return -1;
      len = 1 + (b >> 2);
      offset = (uint32_t)in[i + 1] | ((uint32_t)in[i + 2] << 8);
      i += 3;
    } else {
      if (i + 5 > n) return -1;
      len = 1 + (b >> 2);
      offset = (uint32_t)in[i + 1] | ((uint32_t)in[i + 2] << 8) |
               ((uint32_t)in[i + 3] << 16) | ((uint32_t)in[i + 4] << 24);
      i += 5;
    }
    if (offset == 0 || (size_t)offset > o) return -1;
    if ((size_t)len > out_len - o) return -1;
    const uint8_t* src = out + o - offset;
    uint8_t* dst = out + o;
    o += len;
    if (len <= 16 && offset >= 8 && o + 16 <= out_len) {
      /* two blind 8-byte word copies (decoder.nim:117-125) */
      memcpy(dst, src, 8);
      memcpy(dst + 8, src + 8, 8);
      continue;
    }
    if (offset >= len) {
      memcpy(dst, src, len); /* fully non-overlapping */
      continue;
    }
    if (offset == 1) {
      memset(dst, src[0], len);
      continue;
    }
    /* Overlapping: window doubling — each round copies the valid pattern
       window behind the cursor, which then doubles (decoder.nim:130-144). */
    {
      uint8_t* d = dst;
      size_t remaining = len;
      size_t avail = offset;
      while (remaining > 0) {
        size_t take = avail < remaining ? avail : remaining;
        memcpy(d, src, take); /* src + take <= d: disjoint */
        d += take;
        remaining -= take;
        avail += take;
      }
    }
  }
  *written = o;
  return 0;
}

/* ---------------- framed slab pipelines ---------------- */

/* From crc32c.c (compiled into the same shared object). */
extern uint32_t snappy_tpu_masked_crc32c(const uint8_t* buf, size_t len);

static inline uint8_t* put_varint(uint8_t* p, uint32_t v) {
  while (v >= 0x80) {
    *p++ = (uint8_t)(v | 0x80);
    v >>= 7;
  }
  *p++ = (uint8_t)v;
  return p;
}

#define CHUNK_COMPRESSED 0x00
#define CHUNK_UNCOMPRESSED 0x01
#define MIN_NON_LITERAL_FRAME 17u

/* Compress frames covering in[lo, hi) (lo must be 64 KiB aligned within the
 * logical stream) into framed chunks at outbuf.  Implements the reference's
 * per-frame contract: masked CRC of the payload, compressed form kept only
 * when it saves >= 1/8 (encoder.nim:385-426).  Returns bytes written. */
size_t stpu_encode_framed_slab_level(const uint8_t* in, size_t lo, size_t hi,
                                     uint8_t* outbuf, int level) {
  uint16_t table[2 * TABLE_SIZE];
  uint8_t scratch[MAX_BLOCK + MAX_BLOCK / 6 + 64];
  uint8_t* op = outbuf;
  for (size_t fs = lo; fs < hi; fs += MAX_BLOCK) {
    uint32_t flen = (uint32_t)((hi - fs < MAX_BLOCK) ? (hi - fs) : MAX_BLOCK);
    uint32_t crc = snappy_tpu_masked_crc32c(in + fs, flen);
    uint8_t* blob = scratch;
    uint8_t* bp = put_varint(blob, flen);
    uint32_t blob_len = 0;
    int tried = 0;
    uint32_t enc_len = 0;
    if (flen >= MIN_NON_LITERAL_FRAME) {
      enc_len = (level >= 2) ? stpu_encode_block_l2(in + fs, flen, bp, table)
                             : stpu_encode_block(in + fs, flen, bp, table);
      blob_len = (uint32_t)(bp - blob) + enc_len;
      tried = 1;
    }
    /* Keep-compressed threshold on the encoded block alone, the varint
     * header excluded — the reference compares blockLen (encoder.nim:408). */
    if (tried && enc_len <= flen - flen / 8) {
      uint32_t data_len = 4 + blob_len;
      *op++ = CHUNK_COMPRESSED;
      *op++ = (uint8_t)(data_len & 0xFF);
      *op++ = (uint8_t)((data_len >> 8) & 0xFF);
      *op++ = (uint8_t)((data_len >> 16) & 0xFF);
      memcpy(op, &crc, 4);
      op += 4;
      memcpy(op, blob, blob_len);
      op += blob_len;
    } else {
      uint32_t data_len = 4 + flen;
      *op++ = CHUNK_UNCOMPRESSED;
      *op++ = (uint8_t)(data_len & 0xFF);
      *op++ = (uint8_t)((data_len >> 8) & 0xFF);
      *op++ = (uint8_t)((data_len >> 16) & 0xFF);
      memcpy(op, &crc, 4);
      op += 4;
      memcpy(op, in + fs, flen);
      op += flen;
    }
  }
  return (size_t)(op - outbuf);
}

size_t stpu_encode_framed_slab(const uint8_t* in, size_t lo, size_t hi,
                               uint8_t* outbuf) {
  return stpu_encode_framed_slab_level(in, lo, hi, outbuf, 1);
}

/* Decode a slab of framed chunks directly into their output offsets.
 * Arrays describe n chunks: kinds (0 compressed / 1 verbatim), source
 * offset/length of the tag stream or payload within `stream`, declared
 * output length, absolute output offset, stored masked CRC.
 * Returns 0 on success, 1 on malformed data, 2 on CRC mismatch. */
int stpu_decode_framed_slab(const uint8_t* stream, const uint8_t* kinds,
                            const int64_t* src_off, const int64_t* src_len,
                            const int64_t* declared, const int64_t* out_off,
                            const uint32_t* stored_crc, int n, uint8_t* out,
                            int check_crc) {
  for (int k = 0; k < n; k++) {
    uint8_t* dst = out + out_off[k];
    size_t want = (size_t)declared[k];
    if (kinds[k] == 0) {
      size_t written = 0;
      if (stpu_decode_tags(stream + src_off[k], (size_t)src_len[k], dst, want,
                           &written) != 0 ||
          written != want)
        return 1;
    } else {
      memcpy(dst, stream + src_off[k], want);
    }
    if (check_crc && snappy_tpu_masked_crc32c(dst, want) != stored_crc[k])
      return 2;
  }
  return 0;
}

/* ---------------- framed chunk walk ---------------- */

/* Strict uint32 LEB128 (5-byte limit, the decode-path rule,
 * snappy.nim:92).  Returns bytes consumed, or 0 on truncation/overflow. */
static inline uint32_t walk_varint(const uint8_t* p, size_t n,
                                   uint32_t* val) {
  uint64_t v = 0;
  size_t lim = n < 5 ? n : 5;
  for (size_t i = 0; i < lim; i++) {
    v |= (uint64_t)(p[i] & 0x7f) << (7 * i);
    if (!(p[i] & 0x80)) {
      if (v >> 32) return 0;
      *val = (uint32_t)v;
      return (uint32_t)(i + 1);
    }
  }
  return 0;
}

/* Count chunk headers by hopping them (no validation beyond length
 * containment) so callers can size the walk arrays exactly. */
long stpu_framed_count(const uint8_t* s, size_t n, size_t start) {
  size_t read = start;
  long k = 0;
  while (n - read >= 4) {
    uint32_t dlen = (uint32_t)s[read + 1] | ((uint32_t)s[read + 2] << 8) |
                    ((uint32_t)s[read + 3] << 16);
    if (n - read - 4 < dlen) break;
    read += 4 + dlen;
    k++;
  }
  return k;
}

#define STPU_MAX_FRAME 65536u

/* The reference's sequential chunk walk (snappy.nim:199-265) with the
 * resume protocol: validate chunks one at a time, STOP (without error)
 * at the first chunk that does not fit `budget`, and record decode jobs
 * for the taken prefix.  Walk-time failures are DEFERRED: the caller
 * must decode the taken prefix first (an earlier chunk's decode/CRC
 * error takes precedence), then report *status.
 *
 * Fills per-JOB arrays (data chunks only; skippable chunks consume input
 * but record nothing).  Returns the job count.
 *   *status: 0 clean EOF, 1 stopped at budget (resume point),
 *            2 invalid_input, 3 crc_mismatch, 4 unknown_chunk
 *   *read_end: input offset of the first unprocessed chunk header
 *   *total_out: planned output bytes of the taken prefix */
long stpu_framed_walk(const uint8_t* s, size_t n, size_t start,
                      uint64_t budget, int check_integrity, uint8_t* kinds,
                      int64_t* src_off, int64_t* src_len, int64_t* declared,
                      int64_t* out_off, uint32_t* stored_crc, long cap,
                      int* status, int64_t* read_end, int64_t* total_out) {
  size_t read = start;
  uint64_t written = 0;
  long k = 0;
  *status = 0;
  while (n - read > 0) {
    if (n - read < 4) {
      *status = 2;
      break;
    }
    uint32_t cid = s[read];
    uint32_t dlen = (uint32_t)s[read + 1] | ((uint32_t)s[read + 2] << 8) |
                    ((uint32_t)s[read + 3] << 16);
    if (n - read - 4 < dlen) {
      *status = 2;
      break;
    }
    size_t dpos = read + 4;
    if (cid == 0x00) { /* compressed */
      if (dlen < 4) {
        *status = 2;
        break;
      }
      uint32_t inner;
      uint32_t used = walk_varint(s + dpos + 4, dlen - 4, &inner);
      if (used == 0 || inner > STPU_MAX_FRAME) {
        *status = 2;
        break;
      }
      if (inner > budget - written) {
        *status = 1; /* resume point: this chunk's header offset */
        break;
      }
      if (k >= cap) {
        *status = 2;
        break;
      }
      kinds[k] = 0;
      src_off[k] = (int64_t)(dpos + 4 + used);
      src_len[k] = (int64_t)(dlen - 4 - used);
      declared[k] = inner;
      out_off[k] = (int64_t)written;
      memcpy(&stored_crc[k], s + dpos, 4);
      written += inner;
      k++;
    } else if (cid == 0x01) { /* uncompressed */
      if (dlen < 4) {
        *status = 2;
        break;
      }
      uint32_t inner = dlen - 4;
      if (inner > STPU_MAX_FRAME || inner > budget - written) {
        /* The reference verifies this chunk's CRC BEFORE the size cap
         * and before noticing it does not fit (snappy.nim:244-251). */
        if (check_integrity) {
          uint32_t st;
          memcpy(&st, s + dpos, 4);
          if (snappy_tpu_masked_crc32c(s + dpos + 4, dlen - 4) != st) {
            *status = 3;
            break;
          }
        }
        *status = inner > STPU_MAX_FRAME ? 2 : 1;
        break;
      }
      if (k >= cap) {
        *status = 2;
        break;
      }
      kinds[k] = 1;
      src_off[k] = (int64_t)(dpos + 4);
      src_len[k] = inner;
      declared[k] = inner;
      out_off[k] = (int64_t)written;
      memcpy(&stored_crc[k], s + dpos, 4);
      written += inner;
      k++;
    } else if (cid < 0x80 && cid != 0xff) { /* reserved unskippable */
      *status = 4;
      break;
    }
    /* skippable (cid >= 0x80) and the 0xff stream header: consume */
    read += 4 + dlen;
  }
  *read_end = (int64_t)read;
  *total_out = (int64_t)written;
  return k;
}

/* ---------------- block-parallel raw decode ---------------- */

/* Branchless tag-metrics LUT for the boundary scan: for tag byte b,
 * pack header length (bits 0-2), literal flag (bit 3) and op output
 * length (bits 4-10).  0 marks the length-extended literals (tag codes
 * 60-63), which take the slow path.  An earlier boundary scan that
 * mirrored the decoder's branchy parse (incl. copy-offset extraction)
 * measured ~88% of a full decode, killing the parallel variant; this
 * one needs no offsets (the per-segment decoder re-validates copy reach
 * against its own segment start) and its only data-dependent branch is
 * the rare extended literal — ~5x cheaper per op. */
static uint16_t scan_lut[256];
static int scan_lut_ready = 0;

static void scan_lut_init(void) {
  for (int b = 0; b < 256; b++) {
    uint32_t t = b & 3;
    uint32_t hdr, len, islit = 0;
    if (t == 0) {
      uint32_t lc = (uint32_t)b >> 2;
      if (lc >= 60) { scan_lut[b] = 0; continue; }
      hdr = 1; len = lc + 1; islit = 1;
    } else if (t == 1) {
      hdr = 2; len = 4 + (((uint32_t)b >> 2) & 7);
    } else if (t == 2) {
      hdr = 3; len = 1 + ((uint32_t)b >> 2);
    } else {
      hdr = 5; len = 1 + ((uint32_t)b >> 2);
    }
    scan_lut[b] = (uint16_t)(hdr | (islit << 3) | (len << 4));
  }
  scan_lut_ready = 1;
}

/* One op step of the metrics-only parse: advances *i past the op at *i
 * and adds its output length to *o.  Returns 1 on success, 0 when the op
 * is malformed or runs past n.  Fully branchless for the common tags:
 * the literal/copy mix is branch-predictor-hostile (it alternates data-
 * dependently), so the advance folds the literal payload in with a mask
 * instead of a conditional. */
static inline int scan_op(const uint8_t* in, size_t n, size_t* i, size_t* o) {
  uint32_t e = scan_lut[in[*i]];
  if (LIKELY(e)) {
    size_t hdr = e & 7;
    size_t len = e >> 4;
    size_t adv = hdr + ((size_t)0 - ((e >> 3) & 1) & len);
    if (UNLIKELY(adv > n - *i)) return 0;
    *i += adv;
    *o += len;
    return 1;
  }
  /* length-extended literal (1-4 extra LE length bytes) */
  {
    uint32_t lc = (uint32_t)in[*i] >> 2;
    uint32_t extra = lc - 59;
    if (UNLIKELY(extra > n - *i - 1)) return 0;
    uint32_t v = 0;
    for (uint32_t k = 0; k < extra; k++)
      v |= (uint32_t)in[*i + 1 + k] << (8 * k);
    if (UNLIKELY(v >= 0xFFFFFFFFu)) return 0;
    size_t len = (size_t)v + 1;
    *i += 1 + extra;
    if (UNLIKELY(len > n - *i)) return 0;
    *i += len;
    *o += len;
    return 1;
  }
}

/* Sequential boundary scan over the true op chain from *io_i while
 * *io_i < limit: emits the input offset of each 64 KiB output boundary
 * landing on an op start.  Resumable: cursors and the boundary target
 * live in the caller.  Returns the updated segment count, or -1
 * (malformed / output overrun) or -2 (an op straddles a boundary, or
 * too many segments) — same verdicts as the full scan. */
static long scan_range(const uint8_t* in, size_t n, size_t limit,
                       size_t out_len, size_t* io_i, size_t* io_o,
                       size_t* io_next_target, int64_t* in_offs, long seg,
                       long cap) {
  size_t i = *io_i, o = *io_o, next_target = *io_next_target;
  while (i < limit) {
    if (UNLIKELY(o >= next_target)) {
      if (o != next_target || seg >= cap) return -2;
      in_offs[seg++] = (int64_t)i;
      next_target += 65536;
      if (next_target > out_len) next_target = out_len + 1; /* no more cuts */
    }
    if (UNLIKELY(!scan_op(in, n, &i, &o))) return -1;
    if (UNLIKELY(o > out_len)) return -1;
  }
  *io_i = i;
  *io_o = o;
  *io_next_target = next_target;
  return seg;
}

/* Scan a raw tag stream without moving data, locating the input offset
 * where each 64 KiB *output* block begins.  Block-based encoders (ours,
 * the reference, google/snappy) never let a tag or a copy source cross a
 * 64 KiB output boundary, which makes those blocks independently
 * decodable; the scan proves the tag-alignment half for this particular
 * stream, and the per-segment decoders prove the copy-reach half (a
 * copy reaching before its segment fails their offset>written check).
 *
 * Returns the number of segments found (in_offs[k] = input offset of
 * output byte k*65536, plus a final entry in_offs[nseg] = n), or -1 when
 * the stream is malformed / totals mismatch, or -2 when it is valid-
 * looking but not block-parallel (an op straddles a boundary) — callers
 * fall back to the sequential decoder, which is authoritative. */
long stpu_raw_scan_blocks(const uint8_t* in, size_t n, size_t out_len,
                          int64_t* in_offs, long cap) {
  if (!scan_lut_ready) scan_lut_init();
  size_t i = 0, o = 0, next_target = 0;
  long seg = scan_range(in, n, n, out_len, &i, &o, &next_target, in_offs, 0,
                        cap);
  if (seg < 0) return seg;
  if (i != n || o != out_len) return -1;
  if (seg >= cap) return -2;
  in_offs[seg] = (int64_t)n;
  return seg;
}

/* ---- parallel boundary scan (speculative strided op index) ----
 *
 * The sequential scan's per-op cost is a serial load->LUT->advance
 * dependency chain (~6 ns/op floor), so for large streams the scan is
 * parallelized the classic speculative way: split the compressed body
 * into spans, parse each span speculatively from its first byte (usually
 * mid-op), and stitch.  The op successor function p -> p + oplen(p) is
 * deterministic, so the true chain and a speculative chain merge forever
 * at their first common position — which on real tag streams happens
 * within a few ops.  A span whose speculation never merges (or that
 * errored) is re-scanned sequentially from its true entry, so the worst
 * case degrades to the sequential scan, never to a wrong answer.
 *
 * Phase 1 records every STRIDE-th visited op as (pos, cum-output) pairs;
 * the stitch binary-searches those and re-walks at most STRIDE ops to
 * land exactly, keeping the index 16x smaller than an every-op index. */
#define SCAN_STRIDE 8

/* Phase 1: speculative strided op index of one span [s_lo, s_hi).
 * pos[]/cum[] receive up to cap records (op input offset relative to
 * s_lo, speculative output bytes before that op).  On return: *n_rec
 * records written, *exit_pos = first op position >= s_hi (absolute; the
 * op at it was NOT consumed), *exit_cum = speculative output at exit,
 * *err = 1 when the parse hit a malformed op (exit_pos = that op). */
void stpu_scan_span_index(const uint8_t* in, size_t n, int64_t s_lo,
                          int64_t s_hi, uint32_t* pos, uint32_t* cum,
                          long cap, long* n_rec, int64_t* exit_pos,
                          int64_t* exit_cum, int* err) {
  if (!scan_lut_ready) scan_lut_init();
  size_t i = (size_t)s_lo, o = 0;
  long rec = 0;
  unsigned stride = 0;
  *err = 0;
  while (i < (size_t)s_hi) {
    if (stride == 0 && rec < cap) {
      pos[rec] = (uint32_t)(i - (size_t)s_lo);
      cum[rec] = (uint32_t)o;
      rec++;
    }
    stride = (stride + 1) % SCAN_STRIDE;
    if (UNLIKELY(!scan_op(in, n, &i, &o))) {
      *err = 1;
      break;
    }
  }
  *n_rec = rec;
  *exit_pos = (int64_t)i;
  *exit_cum = (int64_t)o;
}

/* Largest record index in [lo, hi) with key[idx] <= want, or -1. */
static long rec_search(const uint32_t* key, long lo, long hi, uint32_t want) {
  long ans = -1;
  while (lo < hi) {
    long mid = lo + (hi - lo) / 2;
    if (key[mid] <= want) {
      ans = mid;
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return ans;
}

/* Phase 2: stitch the per-span speculative indexes into the true chain
 * and emit 64 KiB output-boundary input offsets.  Span k's records live
 * at [rec_off[k], rec_off[k]+n_rec[k]) in the flat pos/cum arrays; spans
 * are [span_lo[k], span_lo[k+1]).  A span whose speculation missed the
 * true entry (or errored) is re-scanned sequentially.  Same return
 * contract as stpu_raw_scan_blocks. */
long stpu_raw_scan_stitch(const uint8_t* in, size_t n, size_t out_len,
                          long nspans, const int64_t* span_lo,
                          const uint32_t* pos, const uint32_t* cum,
                          const int64_t* rec_off, const int64_t* n_rec,
                          const int64_t* exit_pos, const int64_t* exit_cum,
                          const int* errs, int64_t* in_offs, long cap) {
  if (!scan_lut_ready) scan_lut_init();
  size_t e = 0;      /* true input cursor (always at an op start) */
  size_t out = 0;    /* true output produced before e */
  size_t next_target = 0;
  long seg = 0;
  for (long k = 0; k < nspans; k++) {
    size_t s_lo = (size_t)span_lo[k];
    size_t s_hi = (size_t)span_lo[k + 1];
    if (e >= s_hi) continue; /* an earlier op straddled this whole span */
    long base = (long)rec_off[k];
    int merged = 0;
    size_t merge_cum = 0;
    if (!errs[k] && n_rec[k] > 0) {
      /* Two-pointer merge-find: the true chain enters the span at e; the
       * speculative chain started at s_lo <= e with a different phase.
       * Walk both forward (emitting boundaries on the true side) until
       * they land on a common position — from there the speculative
       * index IS the true chain.  Total work is ~2x the (short) prefix
       * before the merge; if they never meet, the true walk has simply
       * scanned the span sequentially, which is the fallback anyway. */
      long idx =
          rec_search(pos + base, 0, (long)n_rec[k], (uint32_t)(e - s_lo));
      size_t si = s_lo + pos[base + (idx < 0 ? 0 : idx)];
      size_t so = cum[base + (idx < 0 ? 0 : idx)];
      while (e < s_hi) {
        while (si < e) {
          if (UNLIKELY(!scan_op(in, n, &si, &so))) {
            si = (size_t)-1; /* spec chain dead: no merge possible */
            break;
          }
        }
        if (si == e) {
          merged = 1;
          merge_cum = so;
          break;
        }
        if (UNLIKELY(out >= next_target)) {
          if (out != next_target || seg >= cap) return -2;
          in_offs[seg++] = (int64_t)e;
          next_target += 65536;
          if (next_target > out_len) next_target = out_len + 1;
        }
        if (UNLIKELY(!scan_op(in, n, &e, &out))) return -1;
        if (UNLIKELY(out > out_len)) return -1;
      }
    }
    if (merged) {
      /* Fast-forward through the span via the index: emit every 64 KiB
       * boundary whose output offset lands inside it. */
      if (UNLIKELY((size_t)exit_cum[k] < merge_cum)) return -1;
      size_t span_out = (size_t)exit_cum[k] - merge_cum;
      if (UNLIKELY(span_out > out_len - out)) return -1;
      size_t out_end = out + span_out;
      while (next_target <= out_len && next_target < out_end) {
        /* spec cum value at the boundary op */
        uint32_t want = (uint32_t)(merge_cum + (next_target - out));
        long j = rec_search(cum + base, 0, (long)n_rec[k], want);
        if (j < 0) return -2;
        /* walk from record j to the op whose pre-op cum == want */
        size_t wi = s_lo + pos[base + j];
        size_t wo = cum[base + j];
        int hit = 0;
        for (int t = 0; t <= SCAN_STRIDE; t++) {
          if (wo == want && wi >= e) {
            hit = 1;
            break;
          }
          if (wo > want) break;
          if (!scan_op(in, n, &wi, &wo)) break;
        }
        if (!hit) return -2; /* boundary inside an op: not block-parallel */
        if (seg >= cap) return -2;
        in_offs[seg++] = (int64_t)wi;
        next_target += 65536;
      }
      /* a boundary exactly at the span exit is the next span's problem */
      e = (size_t)exit_pos[k];
      out = out_end;
    } else if (e < s_hi) {
      /* error-flagged span, empty index, or dead spec chain: finish the
       * span with the authoritative sequential walk. */
      seg = scan_range(in, n, s_hi, out_len, &e, &out, &next_target, in_offs,
                       seg, cap);
      if (seg < 0) return seg;
    }
  }
  /* tail: e may sit exactly at n (or an op straddled past the last span) */
  if (e < n) {
    seg = scan_range(in, n, n, out_len, &e, &out, &next_target, in_offs, seg,
                     cap);
    if (seg < 0) return seg;
  }
  if (e != n || out != out_len) return -1;
  /* a boundary landing exactly at the stream end is fine (out==target) */
  if (seg >= cap) return -2;
  in_offs[seg] = (int64_t)n;
  return seg;
}

/* Decode a slab of pre-scanned segments (segment k: input
 * [in_offs[k], in_offs[k+1]) -> output [k*65536, ...)).  Returns 0 on
 * success, 1 when any segment is malformed or not self-contained (the
 * caller falls back to the sequential decoder for the exact verdict). */
int stpu_decode_raw_segments(const uint8_t* in, const int64_t* in_offs,
                             long seg_lo, long seg_hi, uint8_t* out,
                             size_t out_len) {
  for (long k = seg_lo; k < seg_hi; k++) {
    size_t o_lo = (size_t)k * 65536;
    size_t o_hi = o_lo + 65536 < out_len ? o_lo + 65536 : out_len;
    size_t written = 0;
    if (stpu_decode_tags(in + in_offs[k], (size_t)(in_offs[k + 1] - in_offs[k]),
                         out + o_lo, o_hi - o_lo, &written) != 0 ||
        written != o_hi - o_lo)
      return 1;
  }
  return 0;
}

/* ---- framed-stream header scan (codec.nim:178-214 semantics) -----------
 * Walks chunk headers from `start`, validating structure exactly like
 * formats/framing.scan_frames: truncated header/payload, data chunk with
 * data_len < 4, compressed chunk whose inner LEB128 uint64 is truncated /
 * longer than 10 bytes / overflowing, reserved unskippable ids
 * (0x02..0x7f), any known chunk with uncompressed payload > 65536.
 * Writes one record of 4 x int64 per chunk:
 *   (id, header_pos, data_len, uncompressed_len)   [data_pos = hdr + 4]
 * Returns the chunk count, -1 when malformed, -2 when more than `cap`
 * chunks exist (caller retries with a bigger table).  This is the
 * O(n_chunks) pass that would otherwise walk Python bytes per chunk on
 * multi-MB streams (round-5 VERDICT item 4). */
long stpu_scan_frames(const uint8_t* in, size_t n, size_t start,
                      int64_t* rec, size_t cap) {
  size_t read = start;
  long cnt = 0;
  while (read < n) {
    if (n - read < 4) return -1;
    uint32_t w = (uint32_t)in[read] | ((uint32_t)in[read + 1] << 8) |
                 ((uint32_t)in[read + 2] << 16) |
                 ((uint32_t)in[read + 3] << 24);
    uint32_t cid = w & 0xff;
    size_t dlen = (size_t)(w >> 8);
    if (n - read - 4 < dlen) return -1;
    size_t dpos = read + 4;
    uint64_t unc = 0;
    if (cid == 0x00) { /* compressed: inner LEB128 uint64 after the CRC */
      if (dlen < 4) return -1;
      const uint8_t* p = in + dpos + 4;
      size_t avail = dlen - 4;
      size_t lim = avail < 10 ? avail : 10;
      uint64_t v = 0;
      int shift = 0, ok = 0;
      for (size_t i = 0; i < lim; i++) {
        uint8_t b = p[i];
        if (shift >= 64 || (shift == 63 && (b & 0x7f) > 1)) break;
        v |= (uint64_t)(b & 0x7f) << shift;
        if (!(b & 0x80)) { ok = 1; break; }
        shift += 7;
      }
      if (!ok) return -1;
      unc = v;
    } else if (cid == 0x01) { /* uncompressed: payload after the CRC */
      if (dlen < 4) return -1;
      unc = dlen - 4;
    } else if (cid < 0x80) { /* reserved unskippable: cannot size */
      return -1;
    } /* skippable 0x80..0xfe and the 0xff stream header: unc = 0 */
    if (unc > 65536) return -1;
    if ((size_t)cnt >= cap) return -2;
    rec[4 * cnt + 0] = (int64_t)cid;
    rec[4 * cnt + 1] = (int64_t)read;
    rec[4 * cnt + 2] = (int64_t)dlen;
    rec[4 * cnt + 3] = (int64_t)unc;
    cnt++;
    read += 4 + dlen;
  }
  return cnt;
}

int stpu_using_native(void) { return 1; }
