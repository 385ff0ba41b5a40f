"""The benchmark of the PyTorch port (``nerfmlp_torch``): see
``BENCHMARK.json`` at the root and ``python -m benchmark.run --help``."""
