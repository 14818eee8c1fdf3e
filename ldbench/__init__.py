"""ldbench: the benchmark of weightedld_tpu_torch (see run.py)."""
