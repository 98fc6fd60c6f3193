"""Run one cell of the benchmark of ``veles.simd_tpu_torch`` on this
machine's NVIDIA card.

    python3 cellbench/run.py --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

Run from the root of a checkout.  The last line of standard output is
one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``; ``check`` last, each
number compared beside its limit); the check's numbers are also the
last lines of standard error.  With ``--trace 0`` the metrics are the
cell's end-to-end ones, with ``--trace 1`` its per-layer ones.  Exits
with a code other than 0, and prints no result, without enough cards,
without the program in the checkout, or with JAX or the JAX package
imported.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _fail(code: int, why: str) -> int:
    print(f"cellbench: {why}", file=sys.stderr)
    return code


def _finite(v):
    """``v`` with every float that is not finite written as a string,
    so that the line is strict JSON."""
    if isinstance(v, dict):
        return {k: _finite(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_finite(x) for x in v]
    if isinstance(v, float) and not math.isfinite(v):
        return repr(v)
    return v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seconds <= 0:
        return _fail(2, "--seconds must be positive")
    if sys.path and Path(sys.path[0]).resolve() == ROOT / "cellbench":
        sys.path[0] = str(ROOT)
    elif str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from cellbench import harness

    harness.set_environment()
    try:
        cell = harness.load_cell(args.workload)
    except harness.SpecError as e:
        return _fail(2, str(e))
    import torch

    phases = {"torch": time.perf_counter() - T_START}
    if not torch.cuda.is_available():
        return _fail(3, "no CUDA device: the benchmark measures the card "
                        "only")
    if torch.cuda.device_count() < cell.chips:
        return _fail(3, f"{cell.name} needs {cell.chips} cards, "
                        f"{torch.cuda.device_count()} found")
    why = harness.load_program()
    if why:
        return _fail(4, why)
    phases["program"] = time.perf_counter() - T_START
    line = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                       "cuda", T_START, phases=phases)
    found = harness.forbidden_modules()
    if found:
        return _fail(5, f"JAX or the JAX package was imported: "
                        f"{', '.join(found)}")
    for name, v in line["check"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(_finite(line), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
