"""The benchmark of moptimizer_0_tpu_torch, the PyTorch and CUDA port.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once on the CUDA cards of this machine and
prints its result as the last line of standard output. Configurations
(``configs/``), traffic mixes (``traffic/``) and per-layer metrics
(``metrics/``) are files found by the names in ``BENCHMARK.json``; the plain
reference that decides ``correct`` is in ``reference/`` and imports nothing
of the port.
"""
