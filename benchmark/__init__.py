"""The benchmark of ``advancedps_tpu_torch`` on one NVIDIA H100.

``python -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line.  Every
configuration, traffic mix, driver loop, per-cell limit, metric reader and
kernel count is a file of its own under this folder, found by the name
``BENCHMARK.json`` gives it (see :mod:`benchmark.manifest`).
"""
