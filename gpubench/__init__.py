"""The benchmark of the PyTorch port (``repro_torch``) on NVIDIA GPUs.

``python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line.  Everything that judges the program lives here: the traffic
generators (:mod:`gpubench.graphs`), the plain references and their FLOP
and byte formulas (:mod:`gpubench.reference`), the reading of the
profiler's trace (:mod:`gpubench.devtrace`), the peaks
(:mod:`gpubench.peaks`) and the comparison that decides ``correct``
(:mod:`gpubench.check`).  Only :mod:`gpubench.program` imports the
program.
"""
