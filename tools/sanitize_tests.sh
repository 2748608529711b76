#!/usr/bin/env bash
# ASan+UBSan leg for the native C codec.
#
# Parity target: the reference compiles every Linux test build with UBSan
# (/root/reference/snappy.nimble:21-28).  We add ASan: the decoder's blind
# 16-byte burst copies and fast-region arithmetic are exactly the code where
# an out-of-bounds access would otherwise go unnoticed.
#
# Two parts:
#   1. A fully sanitized native test binary (sanitize_driver.c) that
#      round-trips the corpus and mutation-fuzzes the raw + framed decoders
#      20k iterations per file.  Whole-binary instrumentation, no Python.
#   2. The host-path pytest suites with the ctypes .so rebuilt under
#      ASan+UBSan (LD_PRELOAD of libasan).  Device/JAX tests are deselected:
#      XLA's CPU runtime is not ASan-clean under interposition, which is an
#      upstream limitation, not a codec gap — the device path has no native
#      code of ours.
set -euo pipefail
cd "$(dirname "$0")/.."

CC_BIN="${CC:-cc}"
NATIVE=snappy_tpu/ops/native
BUILD=$(mktemp -d)
trap 'rm -rf "$BUILD"' EXIT

echo "== [1/2] sanitized native driver =="
"$CC_BIN" -O1 -g -fsanitize=address,undefined -fno-sanitize-recover=all \
  "$NATIVE/sanitize_driver.c" "$NATIVE/snappy_codec.c" "$NATIVE/crc32c.c" \
  -o "$BUILD/sanitize_driver"
CORPUS="${SNAPPY_TPU_CORPUS:-/root/reference/tests}/data"
FILES=()
for f in html urls.10K fireworks.jpeg paper-100k.pdf alice29.txt \
         geo.protodata kppkn.gtb Mark.Twain-Tom.Sawyer.txt \
         baddata1.snappy baddata2.snappy baddata3.snappy; do
  [ -f "$CORPUS/$f" ] && FILES+=("$CORPUS/$f")
done
if [ "${#FILES[@]}" -eq 0 ]; then
  # CI runners don't have the reference corpus: generate the deterministic
  # synthetic one instead of silently degrading to fuzzing this script.
  echo "corpus not found at $CORPUS; generating synthetic corpus"
  python tools/gen_corpus.py "$BUILD/corpus"
  for f in "$BUILD"/corpus/*; do
    [ -f "$f" ] && FILES+=("$f")
  done
  if [ "${#FILES[@]}" -eq 0 ]; then
    echo "FATAL: no corpus files available" >&2
    exit 1
  fi
fi
ASAN_OPTIONS="abort_on_error=1" UBSAN_OPTIONS="print_stacktrace=1:halt_on_error=1" \
  "$BUILD/sanitize_driver" "${FILES[@]}"

echo "== [2/2] host-path pytest under sanitized ctypes .so =="
LIBASAN="$($CC_BIN -print-file-name=libasan.so)"
if [ ! -e "$LIBASAN" ]; then
  echo "libasan.so not found; skipping pytest leg" >&2
  exit 0
fi
SNAPPY_TPU_SANITIZE=1 \
ASAN_OPTIONS="detect_leaks=0:abort_on_error=1" \
UBSAN_OPTIONS="print_stacktrace=1:halt_on_error=1" \
SNAPPY_TPU_BACKEND=host \
LD_PRELOAD="$LIBASAN" \
python -m pytest tests/test_framed.py tests/test_formats.py \
  tests/test_oracle.py tests/test_crc32c.py \
  -q -k "not device and not jax and not chunks" "$@"

echo "== [3/3] coverage-guided fuzz (fixed budget) =="
FUZZ_ITERS="${FUZZ_ITERS:-100000}" bash tools/fuzz_coverage.sh "${FILES[@]}"
echo "sanitizer leg PASSED"
