"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``): one cell
of ``BENCHMARK.json`` run once by ``qlm_bench/run.py``.  See README.md."""
