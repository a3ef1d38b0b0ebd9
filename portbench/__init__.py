"""The benchmark of ``nvdb_tpu_torch`` on one NVIDIA GPU.

``python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON object as the
last line of its standard output. Everything a cell needs is found by name:
its configuration in ``configs/<name>.json``, its traffic in
``traffic/<name>.json``, the corpus generator in ``corpora/<name>.py``, the
index under test in ``indexes/<kind>.py`` and each per-layer metric's reader
in ``metrics/<name>.py``. ``reference.py`` is the plain reference that
decides ``correct``; it imports nothing of the program.
"""
