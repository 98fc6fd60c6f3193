#!/usr/bin/env python3
"""The static route picks of the sharded Fourier family in both
packages, at the JAX tests' geometries.

    JAX_PLATFORMS=cpu python3 tools/compare_fourier_picks.py

For each geometry of ``tests/test_parallel_fourier.py`` (the signal
length, the shards of the ``sp`` axis and the rows) it prints one JSON
line: the Cooley-Tukey split with both factors divisible by the shard
count, the ``parallel.fourier`` static pick of the JAX package
(``veles.simd_tpu.parallel.fourier``, whose cost model carries the TPU
v5e rates of ``veles.simd_tpu.utils.benchmark``) and of the port
(``veles.simd_tpu_torch.parallel.fourier``, the H100's rates), and
each model's two sides in microseconds: the factorized matmul route
and the local FFT.  The models' times are the cost models' outputs,
not measurements.  Runs on the CPU; needs no card.
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
    __file__)), os.pardir))

# (n, shards, rows): tests/test_parallel_fourier.py's geometries
GEOMETRIES = [(512, 8, 1), (960, 8, 1), (1024, 8, 1), (1024, 8, 3),
              (1536, 8, 1), (4096, 8, 1), (4096, 4, 1), (12288, 8, 1),
              (1 << 17, 8, 1), (1 << 18, 8, 1), (1 << 18, 1, 1)]


def main() -> int:
    from veles.simd_tpu.ops import spectral as jsp
    from veles.simd_tpu.parallel import fourier as jfr
    from veles.simd_tpu_torch.parallel import fourier as tfr

    for n, s, rows in GEOMETRIES:
        n1, n2 = jsp.ct_factor(n, multiple=s) or (0, 0)
        row = {"n": n, "shards": s, "rows": rows, "n1": n1, "n2": n2}
        for name, fr in (("jax", jfr), ("port", tfr)):
            row[f"{name}_pick"] = fr._select_fourier_route(
                "rfft", n, s, rows, n1, n2)
            if n1:
                t_mm, t_fft, _ = fr._modeled_costs(n, n1, n2, rows, s)
                row[f"{name}_matmul_us"] = round(t_mm * 1e6, 4)
                row[f"{name}_fft_us"] = round(t_fft * 1e6, 4)
        row["differ"] = row["jax_pick"] != row["port_pick"]
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
