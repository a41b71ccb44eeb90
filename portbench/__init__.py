"""The benchmark of patrol's PyTorch and CUDA port (``patrol_tpu_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once. Everything that
belongs to one configuration, traffic mix or per-layer metric is a file of
its own under ``configs/``, ``traffic/`` or ``metrics/``, found by the name
the manifest gives it. ``reference/`` is the plain reference that decides
``correct``; it imports nothing of the program.
"""
