"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

``run.py`` runs one cell; ``BENCHMARK.json`` at the checkout's root names
the cells, the configurations (``configs/``), the traffic mixes
(``traffic/``), the limits of each cell's check (``limits/``) and the
metrics, each per-layer metric read by ``metrics/<name>.py``.
"""
