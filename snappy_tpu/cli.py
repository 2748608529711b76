"""Command-line utility: compress / decompress files with snappy_tpu.

Compatible with the framed-format files produced by other snappy tools
(e.g. ``snzip``): ``python -m snappy_tpu.cli -d file.sz``.
"""

from __future__ import annotations

import argparse
import sys
import time

from . import api
from .formats import framing


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="snappy_tpu", description="Snappy codec (raw + framed)"
    )
    from . import __version__

    p.add_argument("--version", action="version", version=f"%(prog)s {__version__}")
    p.add_argument("-d", "--decompress", action="store_true")
    p.add_argument(
        "--raw", action="store_true", help="use the raw block format (no framing)"
    )
    p.add_argument("--no-crc", action="store_true", help="skip CRC verification")
    p.add_argument(
        "-l",
        "--level",
        type=int,
        default=1,
        choices=(1, 2),
        help="compression level: 1 fast (default), 2 denser",
    )
    p.add_argument("-o", "--output", default=None)
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("input")
    args = p.parse_args(argv)

    data = (
        sys.stdin.buffer.read() if args.input == "-" else open(args.input, "rb").read()
    )

    t0 = time.perf_counter()
    if args.decompress:
        fmt = "raw" if args.raw or not framing.is_snappy_framed_stream(data) else "framed"
        if fmt == "framed":
            out = api.decode_framed(data, check_integrity=not args.no_crc)
        else:
            out = api.decode(data)
        if out == b"" and len(data) > 1:
            print("error: malformed snappy input", file=sys.stderr)
            return 1
        default_name = (
            args.input[:-3] if args.input.endswith(".sz") else args.input + ".out"
        )
    else:
        out = (
            api.encode(data, level=args.level)
            if args.raw
            else api.encode_framed(data, level=args.level)
        )
        default_name = args.input + (".rawsz" if args.raw else ".sz")
    dt = time.perf_counter() - t0

    dest = args.output or default_name
    if dest == "-":
        sys.stdout.buffer.write(out)
    else:
        with open(dest, "wb") as f:
            f.write(out)
    if args.verbose:
        big = max(len(data), len(out))
        print(
            f"{len(data)} -> {len(out)} bytes "
            f"({len(out)/max(1,len(data)):.3f}) in {1e3*dt:.1f} ms "
            f"({big/dt/1e9:.2f} GB/s)",
            file=sys.stderr,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
