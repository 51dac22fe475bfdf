"""The benchmark of `anoddpm_torch` on one H100: ``python3 benchmark/run.py``.

`run.py` runs one cell of `BENCHMARK.json`; `core/` is the harness, the
inputs and the yardstick (FLOPs, bytes, the device trace); `reference/` is
the plain fp32 PyTorch reference that decides `correct`; `metrics/` holds
one reader per metric; `configs/` and `traffic/` the cells' data.
"""
