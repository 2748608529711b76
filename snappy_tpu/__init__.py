"""snappy_tpu — a Snappy codec framework on JAX.

A from-scratch implementation of Google's Snappy raw block format and framed
format (with masked CRC32C), with the capabilities of the reference
implementation status-im/nim-snappy: a native C host runtime, and a device
route of batched kernels -- a CUDA chunk decoder on NVIDIA GPUs (XLA's
array-parallel decoder on the CPU backend), sort-based match finding, and a
GF(2)-combined CRC32C -- with block/frame data parallelism over device
meshes.

Public API surface (see api.py for the reference-parity table):

    encode / decode                      raw format, bytes in/out
    encode_batch / decode_batch          many raw streams, batched dispatch
    compress_into / uncompress_into      raw format, caller buffers, Result
    encode_framed / decode_framed        framed format, bytes in/out
    compress_framed_into                 framed, caller buffer, Result
    uncompress_framed_into               resumable framed decode, Result
    uncompressed_len[_framed]            stream sizing
    max_compressed_len[_framed]          worst-case output sizing
    is_framed_stream                     magic sniff
    masked_crc32c                        masked CRC32C (backend-routed)
"""

from .api import (  # noqa: F401
    compress_framed_into,
    compress_into,
    decode,
    decode_batch,
    decode_framed,
    encode,
    encode_batch,
    encode_framed,
    is_framed_stream,
    uncompress_framed_into,
    uncompress_into,
    uncompressed_len,
    uncompressed_len_framed,
)
from .engine import masked_crc32c  # noqa: F401
from .formats.constants import (  # noqa: F401
    max_compressed_len,
    max_compressed_len_framed,
)
from .formats.errors import (  # noqa: F401
    CodecError,
    Err,
    FrameError,
    InputTooLarge,
    MalformedSnappyData,
    Ok,
    SnappyDecodingError,
    SnappyEncodingError,
    SnappyError,
    UnexpectedEofError,
)

# Kept in sync with pyproject.toml (pinned by tests/test_api.py).
__version__ = "0.6.0"
