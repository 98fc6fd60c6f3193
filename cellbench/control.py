"""The readings that a cell's limits are set from.

    python3 cellbench/control.py --workload <name> --seeds 1 2 3 ... \\
        [--seconds 2]

For each seed, in one process on the card: a short run of the cell at
its own sizes and load (the timed path, its sample of calls compared
with the reference, exactly as ``run.py`` compares them), and the
control's reading on the same operands: the reference computed one
precision lower (TF32 operands for the float32 with TF32 off that the
configurations state), put in the program's place.  Prints one JSON
line a seed, ``{"seed", "program", "control"}``, then the largest
program reading and the smallest control reading.  A limit lies
between the two.  The benchmark's own runs never run the control.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if sys.path and Path(sys.path[0]).resolve() == ROOT / "cellbench":
        sys.path[0] = str(ROOT)
    from cellbench import harness
    import torch

    harness.set_environment()
    if not torch.cuda.is_available():
        print("cellbench: no CUDA device", file=sys.stderr)
        return 3
    why = harness.load_program()
    if why:
        print(f"cellbench: {why}", file=sys.stderr)
        return 4
    cell = harness.load_cell(args.workload)
    program, control = [], []
    for seed in args.seeds:
        line = harness.run(cell, seed, args.seconds, False, "cuda",
                           T_START, control=True)
        program.append(line["check"]["max_rel_err"]["value"])
        control.append(line["control"]["max_rel_err"])
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "program": program[-1],
                          "control": control[-1],
                          "calls": line["attempted"],
                          "compared": line["calls_compared"]}),
              flush=True)
    print(json.dumps({"workload": cell.name, "seeds": len(args.seeds),
                      "program_max": max(program),
                      "control_min": min(control)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
