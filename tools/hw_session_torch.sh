#!/bin/sh
# One-shot card session of the port: run every card-side item in
# priority order on an NVIDIA card.  Each step is logged on its own and
# failure-isolated, and the bench headline goes first, so a short
# session still captures it.  The twin of tools/hw_session.sh.
#
#   sh tools/hw_session_torch.sh [outdir]
#       # default chiprun_out/hw_session in the checkout (.gitignore
#       # lists chiprun_out/), so two checkouts never share it
#
# Steps (headline first):
#   1. bench_torch.py --all              -> headline JSON + the table
#                                           (BENCH_DETAILS_torch.json)
#   2. tools/tpu_smoke_torch.py          -> the family smoke (the JAX
#                                           smoke's 20 families)
#   3. tools/benchmark_suite_torch.py --quick -> per-family timed rows
#   4. tools/tune_conv2d_torch.py --quick     -> 2D crossover re-check
#   5. tools/tune_overlap_save_torch.py --quick -> 1D step re-check
#   6. tools/profile_overlap_save_torch.py    -> the headline kernel's
#                                 breakdown (in place of the JAX
#                                 session's repro_pallas2d.py bisect,
#                                 which has no port: the card has no
#                                 Mosaic lowering to bisect)
#   7. tools/run_tests_torch.py --cuda   -> the card suite under the
#                                           line tracer: the table of
#                                           ops/cuda_kernels.py and
#                                           its card-only lines
#   8. tools/gen_wavelet_tables_torch.py -> the whole table regenerated
#                                           and held to the committed
#                                           rows (the npz is written
#                                           only if a row changed)
#   9. python3 chip_smoke.py             -> every phase, the kernels line
# and the card's name and power limit last.
set -u
OUT=${1:-$(dirname "$0")/../chiprun_out/hw_session}
mkdir -p "$OUT"
OUT=$(cd "$OUT" && pwd)   # absolutize before the repo-root cd below
cd "$(dirname "$0")/.."
PY=${PYTHON:-python3}

echo "== hw_session_torch $(date -u +%FT%TZ) -> $OUT"

run() {
  name=$1; shift
  echo "== $name: $*"
  start=$(date +%s)
  "$@" >"$OUT/$name.out" 2>"$OUT/$name.err"
  rc=$?
  echo "== $name: rc=$rc (${name}.out/.err, $(($(date +%s) - start))s)"
  return 0
}

# every step under a hard `timeout -k` (TERM then KILL): a call wedged
# in native code clears only with its process.  Keep the host idle for
# the session: a concurrent build or test run shows up in every
# chained time.
run bench        timeout -k 60 3000 $PY bench_torch.py --all
cp -f BENCH_DETAILS_torch.json "$OUT/" 2>/dev/null || true
run smoke        timeout -k 60 1800 $PY tools/tpu_smoke_torch.py
run suite        timeout -k 60 2400 $PY tools/benchmark_suite_torch.py \
                   --quick
run tune_conv2d  timeout -k 60 1800 $PY tools/tune_conv2d_torch.py --quick
run tune_os      timeout -k 60 1800 $PY tools/tune_overlap_save_torch.py \
                   --quick
run profile_os   timeout -k 60 1200 $PY tools/profile_overlap_save_torch.py
run cuda_cov     timeout -k 60 2400 $PY tools/run_tests_torch.py --cuda \
                   --out-dir "$OUT"
run wavelet      timeout -k 60 1800 $PY tools/gen_wavelet_tables_torch.py
run chip_smoke   timeout -k 60 1200 $PY chip_smoke.py

echo "== headline:"
head -1 "$OUT/bench.out" 2>/dev/null
echo "== card:"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader 2>&1
echo "== done $(date -u +%FT%TZ)"
