"""The serving benchmark of the PyTorch/CUDA port (``repro_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and prints
one JSON line.  Everything that belongs to one configuration, traffic mix,
per-layer metric or cell sits in a file of its own under this folder and is
found by its name (:mod:`portbench.manifest`).
"""
