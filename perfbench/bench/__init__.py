"""The benchmark's general code: what every cell shares.  A configuration,
a traffic mix and a per-layer metric each live in files of their own
(``configs/``, ``traffic/``, ``metrics/``), found by the names in
``BENCHMARK.json``."""
