"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of CAPSim.

``run.py`` runs one cell of ``BENCHMARK.json`` and prints one JSON line.
Everything a cell needs is found by name: ``workloads/<cell>.json`` (the
deployment and the correctness limits), ``configs/<config>.json`` (the
model's sizes), ``traffic/<traffic>.json`` (the input mix, read by the
driver ``drivers/<kind>.py`` it names) and ``metrics/<metric>.py`` (one
reader per metric).  The inputs come from ``frontend/``, a frozen copy of
the port's numpy front-end, and ``correct`` from ``reference/``, plain
PyTorch that imports nothing of the program.
"""
