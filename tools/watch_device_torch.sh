#!/bin/sh
# Poll for a CUDA card and fire the port's card session the moment one
# answers.  The twin of tools/watch_device.sh.
#
#   sh tools/watch_device_torch.sh [outdir] [interval_s]
#       # defaults: chiprun_out/hw_session in the checkout, 480
#
# Probes via veles.simd_tpu_torch.utils.platform.probe_device_count (a
# killable subprocess probe: a CUDA init that hangs in the CUDA library
# cannot be interrupted in-process).  One line per probe goes to
# stdout; on success it execs tools/hw_session_torch.sh and exits with
# its status.
set -u
OUT=${1:-$(dirname "$0")/../chiprun_out/hw_session}
INTERVAL=${2:-480}
mkdir -p "$OUT"
OUT=$(cd "$OUT" && pwd)   # absolutize before the repo-root cd below
cd "$(dirname "$0")/.."
PY=${PYTHON:-python3}

while :; do
  n=$(timeout 120 $PY -c "
from veles.simd_tpu_torch.utils.platform import probe_device_count
print(probe_device_count(timeout=90.0))" 2>/dev/null || echo 0)
  echo "$(date -u +%FT%TZ) devices=$n"
  if [ "${n:-0}" -gt 0 ] 2>/dev/null; then
    echo "$(date -u +%FT%TZ) card found -> hw_session_torch"
    exec sh tools/hw_session_torch.sh "$OUT"
  fi
  sleep "$INTERVAL"
done
