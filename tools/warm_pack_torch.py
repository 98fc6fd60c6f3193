#!/usr/bin/env python3
"""Build the port's warm pack: the CUDA kernel library, packed and
stamped for the card that built it.

The port's twin of ``tools/warm_pack.py``.  The JAX tool drives every
serving shape class so each compiled program exports itself into the
pack; the port compiles no program per shape, and its one costly
first-use build is the kernel library (``nvcc`` over ``csrc/*.cu``).
So the port's pack holds one entry, ``kernels|<hash>`` (the library
and its build log, ``runtime/artifacts.store_kernel_library``): this
tool loads the library (building it when it is not built yet), stores
it in ``on`` mode, then preloads the pack once to prove the entry
unpacks and places.

Ship the directory and point services at it::

    VELES_SIMD_ARTIFACTS=readonly \\
    VELES_SIMD_ARTIFACT_DIR=/etc/veles/warm_pack_torch python3 serve.py

``serve.Server.start()`` (and subprocess replicas) then place the
library under the kernel build root, so no nvcc runs before the first
request; ``tools/cold_start_torch.py`` measures the gain.  The store's
stamps (card name, torch and CUDA versions) refuse a pack built for
another card.

Run:  python3 tools/warm_pack_torch.py [--dir warm_pack_torch]

It runs on the card only: the kernel library is built for it, and a
CPU process has none to pack (``VELES_SIMD_PLATFORM=cpu`` exits 2, as
does a process without a card).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
    __file__)), os.pardir))

DEFAULT_DIR = "warm_pack_torch"


def build(pack: str) -> dict:
    """Load the kernel library, store it in ``pack`` and preload the
    pack back; returns ``{"stored": outcome, "preload": report,
    "store": info}``."""
    from veles.simd_tpu_torch import obs
    from veles.simd_tpu_torch.ops import cuda_kernels as ck
    from veles.simd_tpu_torch.runtime import artifacts

    ck.load_library()
    obs.enable()
    artifacts.set_artifact_dir(pack)
    try:
        with artifacts.artifacts_mode_override("on"):
            stored = artifacts.store_kernel_library()
            report = artifacts.preload()
        info = artifacts.store().info()
    finally:
        artifacts.set_artifact_dir(None)
    return {"stored": stored, "preload": report, "store": info}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default=DEFAULT_DIR,
                    help=f"pack directory (default {DEFAULT_DIR}/)")
    args = ap.parse_args(argv)
    from veles.simd_tpu_torch.utils.platform import select_device

    if select_device() != "cuda":
        print("warm_pack_torch: the pack holds the CUDA kernel library, "
              "built for the card; a CPU process has none to pack",
              file=sys.stderr)
        return 2
    from veles.simd_tpu_torch.runtime import artifacts
    from veles.simd_tpu_torch.utils.platform import smi_line

    out = build(args.dir)
    print(f"pack {args.dir}: {out['stored']} (schema "
          f"{artifacts.ARTIFACT_SCHEMA}, {artifacts.version_stamp()}, "
          f"device {artifacts.device_stamp()!r}) | card {smi_line()}")
    print(f"preload check: {out['preload']['loaded']} loaded, "
          f"{out['preload']['failed']} failed")
    print(json.dumps(out, indent=1, sort_keys=True, default=str))
    ok = (out["stored"] == "stored" and out["preload"]["loaded"] == 1
          and not out["preload"]["failed"])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
