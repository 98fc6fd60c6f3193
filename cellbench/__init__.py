"""The benchmark of ``veles.simd_tpu_torch`` on an NVIDIA H100: one
command, ``python3 cellbench/run.py``, and the data files it reads."""
