"""The benchmark of the PyTorch and CUDA port, ``rvgrt_tpu_torch``.

``run.py`` is its command (``python3 -m port_bench.run --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``), ``drive.py`` drives the port,
``check.py`` holds what the port produced against ``reference/``,
``flight.py`` makes the traffic from ``traffic/<name>.json``, each metric is
a reader in ``metrics/<name>.py``, each configuration a file in
``configs/``, each cell's limits a file in ``limits/``; ``control.py`` reads
the numbers the limits are set from.  ``BENCHMARK.json``, at the root of the
repository, names them all.  Tests: ``python -m pytest port_bench/tests``.
"""
