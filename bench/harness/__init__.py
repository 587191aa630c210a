"""The benchmark of the PyTorch/CUDA port (``repro_torch``): a harness
driven by ``BENCHMARK.json`` and the data files beside it. It imports no
JAX and nothing of the JAX package; only ``load_port`` and the drivers
reach into ``repro_torch``, the system under test."""
