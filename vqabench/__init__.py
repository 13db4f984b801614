"""The benchmark of the PyTorch/H100 port: ``python3 -m vqabench.run``
(see ``vqabench/run.py``); cells in ``BENCHMARK.json``."""
