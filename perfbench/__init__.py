"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on the H100.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once and prints one JSON line.  Everything a
cell needs is data: ``configs/<config>.json``, ``workloads/<cell>.json``
(its driver kind, traffic and limits), ``drivers/<kind>.py`` and one
reader ``metrics/<metric>.py`` per per-layer metric, all found by the names
in ``BENCHMARK.json``.
"""
