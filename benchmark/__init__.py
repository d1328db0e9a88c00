"""The benchmark of ``rnnwavefunctions_tpu_torch``, the PyTorch and CUDA
port: one cell run once by ``python3 -m benchmark.run``; its cells, metrics
and bounds in ``BENCHMARK.json`` at the root of the repository."""
