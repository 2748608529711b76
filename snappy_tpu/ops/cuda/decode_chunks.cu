// Snappy chunk decoder for NVIDIA Hopper, called from JAX through the XLA FFI.
//
// One thread block (one warp) decodes one independent tag stream of at most
// 64 KiB output (a framed chunk, or one 64 KiB block of a raw stream).  The
// output window lives in shared memory; every copy reads bytes the same warp
// wrote, so nothing but the final window ever reaches device memory.
//
//   parse   lane 0 walks up to kQueue tags with the host decoder's exact
//           validation and writes one (src, dst, len, off) descriptor per
//           tag into a shared-memory queue.
//   emit    the warp executes the descriptors in order.  Lane i writes byte
//           i (mod 32) of each op.  A copy reads out[dst - off + i % off],
//           which never touches the op's own destination, so overlapping
//           copies (offset < length) replicate their pattern with no
//           intra-op ordering; a __syncwarp is needed only when a copy's
//           source reaches bytes written since the last one.
//   store   the window goes to device memory with 16-byte stores, zeroed
//           past the bytes written (the CRC that follows reads whole rows).
//
// The compressed row is read from device memory through L1 (non-coherent
// loads); only the 64 KiB window takes shared memory, so three blocks fit on
// an SM.  Staging the row in shared memory too (one cp.async.bulk with an
// mbarrier, about 141 KB a block, one block per SM) measured 1.9x slower on
// an H200 at 512 chunks: the walk is latency-bound and wants occupancy.
//
// Validation (any failure clears ok; same rules as ops/decode_jax.py and
// stpu_decode_tags in ops/native/snappy_codec.c):
//   truncated tag header or literal length extension; literal length that
//   wraps uint32; literal past the input or the output; copy offset 0 or
//   past the bytes written; output overrun; consumed == comp_len and
//   written == declared.  A row with comp_len 0 is not ok (as decode_jax).
//
// Interface: comp u8[n, width], comp_len s32[n], declared s32[n] ->
//            out u8[n, 65536], status s32[n, 2] = (ok, written).

#include <cuda_runtime.h>

#include <cstdint>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kWindow = 65536;
constexpr int kQueue = 32;
// Shared memory: the descriptor queue, then the output window.
constexpr int kHeader = kQueue * 16;

struct Op {
  int32_t src;  // literal: comp index; copy: unused
  int32_t dst;
  int32_t len;
  int32_t off;  // 0 for a literal
};

__device__ __forceinline__ uint32_t comp_byte(const uint8_t* cin, int64_t i) {
  return __ldg(cin + i);
}

__global__ void __launch_bounds__(32)
    decode_chunks_kernel(const uint8_t* __restrict__ comp, int64_t width,
                         const int32_t* __restrict__ comp_len,
                         const int32_t* __restrict__ declared,
                         uint8_t* __restrict__ out, int32_t* __restrict__ status) {
  extern __shared__ __align__(16) uint8_t smem[];
  Op* queue = reinterpret_cast<Op*>(smem);
  uint8_t* win = smem + kHeader;

  const int lane = threadIdx.x;
  const int64_t row = blockIdx.x;
  const uint8_t* cin = comp + row * width;
  const int64_t n = comp_len[row];
  const int64_t m = declared[row];
  const bool shape_ok = n > 0 && n <= width && m >= 0 && m <= kWindow;

  // Parser state lives in lane 0; the warp sees it through shuffles.
  int64_t pos = 0;  // input cursor
  int64_t w = 0;    // bytes written
  bool err = !shape_ok;
  int32_t fence = 0;  // bytes every lane is guaranteed to see

  while (true) {
    int cnt = 0;
    if (lane == 0) {
      while (!err && pos < n && cnt < kQueue) {
        const uint32_t b = comp_byte(cin, pos);
        const uint32_t t = b & 3;
        Op op;
        op.dst = static_cast<int32_t>(w);
        if (t == 0) {
          const uint32_t lc = b >> 2;
          int64_t len;
          int64_t hdr;
          if (lc < 60) {
            len = lc + 1;
            hdr = 1;
          } else {
            const int64_t ex = lc - 59;
            if (pos + 1 + ex > n) { err = true; break; }
            uint32_t v = 0;
            for (int k = 0; k < ex; ++k) v |= comp_byte(cin, pos + 1 + k) << (8 * k);
            if (v == 0xFFFFFFFFu) { err = true; break; }
            len = static_cast<int64_t>(v) + 1;
            hdr = 1 + ex;
          }
          if (len > n - pos - hdr || len > m - w) { err = true; break; }
          op.src = static_cast<int32_t>(pos + hdr);
          op.len = static_cast<int32_t>(len);
          op.off = 0;
          pos += hdr + len;
        } else {
          const int64_t hdr = t == 1 ? 2 : (t == 2 ? 3 : 5);
          if (pos + hdr > n) { err = true; break; }
          const uint32_t b1 = comp_byte(cin, pos + 1);
          uint32_t off;
          int64_t len;
          if (t == 1) {
            len = 4 + ((b >> 2) & 7);
            off = ((b & 0xE0u) << 3) | b1;
          } else {
            len = 1 + (b >> 2);
            off = b1 | (comp_byte(cin, pos + 2) << 8);
            if (t == 3) {
              off |= (comp_byte(cin, pos + 3) << 16) |
                     (comp_byte(cin, pos + 4) << 24);
            }
          }
          if (off == 0 || off > w || len > m - w) { err = true; break; }
          op.src = 0;
          op.len = static_cast<int32_t>(len);
          op.off = static_cast<int32_t>(off);
          pos += hdr;
        }
        w += op.len;
        queue[cnt++] = op;
      }
    }
    cnt = __shfl_sync(0xFFFFFFFFu, cnt, 0);
    __syncwarp();
    for (int k = 0; k < cnt; ++k) {
      const Op op = queue[k];
      if (op.off == 0) {
        const uint8_t* s = cin + op.src;
        uint8_t* d = win + op.dst;
        int i = lane;
        for (; i + 96 < op.len; i += 128) {
          const uint8_t a0 = comp_byte(s, i);
          const uint8_t a1 = comp_byte(s, i + 32);
          const uint8_t a2 = comp_byte(s, i + 64);
          const uint8_t a3 = comp_byte(s, i + 96);
          d[i] = a0;
          d[i + 32] = a1;
          d[i + 64] = a2;
          d[i + 96] = a3;
        }
        for (; i < op.len; i += 32) d[i] = comp_byte(s, i);
      } else {
        const int32_t base = op.dst - op.off;
        const int32_t reach = base + (op.off < op.len ? op.off : op.len);
        if (reach > fence) {
          __syncwarp();
          fence = op.dst;
        }
        uint8_t* d = win + op.dst;
        if (op.off >= op.len) {
          for (int i = lane; i < op.len; i += 32) d[i] = win[base + i];
        } else {
          for (int i = lane; i < op.len; i += 32) d[i] = win[base + i % op.off];
        }
      }
    }
    // The queue is rewritten next round; later copies may read this round.
    __syncwarp();
    if (cnt > 0) fence = __shfl_sync(0xFFFFFFFFu, static_cast<int32_t>(w), 0);
    const int more = __shfl_sync(0xFFFFFFFFu, (!err && pos < n) ? 1 : 0, 0);
    if (!more) break;
  }

  const int32_t written = __shfl_sync(0xFFFFFFFFu, static_cast<int32_t>(w), 0);
  if (lane == 0) {
    const bool ok = !err && pos == n && w == m;
    status[2 * row] = ok ? 1 : 0;
    status[2 * row + 1] = static_cast<int32_t>(w);
  }
  uint4* dst = reinterpret_cast<uint4*>(out + row * kWindow);
  const uint4* src = reinterpret_cast<const uint4*>(win);
  for (int v = lane; v < kWindow / 16; v += 32) {
    const int32_t j0 = v * 16;
    union {
      uint4 v4;
      uint8_t b[16];
    } x;
    x.v4 = make_uint4(0, 0, 0, 0);
    if (j0 + 16 <= written) {
      x.v4 = src[v];
    } else if (j0 < written) {
      for (int k = 0; k < 16; ++k) x.b[k] = j0 + k < written ? win[j0 + k] : 0;
    }
    dst[v] = x.v4;
  }
}

ffi::Error DecodeChunksImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> comp,
                            ffi::Buffer<ffi::S32> comp_len, ffi::Buffer<ffi::S32> declared,
                            ffi::ResultBuffer<ffi::U8> out,
                            ffi::ResultBuffer<ffi::S32> status) {
  const auto dims = comp.dimensions();
  if (dims.size() != 2) return ffi::Error::InvalidArgument("comp must be [n, width]");
  const int64_t rows = dims[0];
  const int64_t width = dims[1];
  const auto out_dims = out->dimensions();
  if (comp_len.element_count() != static_cast<size_t>(rows) ||
      declared.element_count() != static_cast<size_t>(rows) || out_dims.size() != 2 ||
      out_dims[0] != rows || out_dims[1] != kWindow ||
      status->element_count() != static_cast<size_t>(2 * rows)) {
    return ffi::Error::InvalidArgument("decode_chunks: operand shapes disagree");
  }
  if (rows == 0) return ffi::Error::Success();
  if (rows > 0x7FFFFFFF) return ffi::Error::InvalidArgument("too many rows");
  constexpr size_t smem = kHeader + kWindow;
  // Per device: the attribute applies to the current device only.
  cudaError_t e = cudaFuncSetAttribute(
      decode_chunks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(e));
  decode_chunks_kernel<<<static_cast<unsigned>(rows), 32, smem, stream>>>(
      comp.typed_data(), width, comp_len.typed_data(), declared.typed_data(),
      out->typed_data(), status->typed_data());
  e = cudaGetLastError();
  if (e != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(e));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(SnappyDecodeChunks, DecodeChunksImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::U8>>()
                                  .Ret<ffi::Buffer<ffi::S32>>());
