"""The benchmark of ``c_raytracer_tpu_torch`` on NVIDIA cards: see
``BENCHMARK.json`` at the repository's root and ``core.py``."""
