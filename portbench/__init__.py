"""Benchmark of the mvedit_tpu_torch port (see run.py)."""
