"""The benchmark of the PyTorch and CUDA port (`se_tpu_torch`) on one
H100: `run.py` runs one cell once; `BENCHMARK.json` at the root of the
repository names the cells, metrics and bounds."""
