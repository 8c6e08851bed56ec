"""The serving benchmark of ``repro_torch`` on one H100.

``python perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything a cell is made of is data found by name:
``configs/<config>.json`` (the model's published numbers and each cut),
``traffic/<mix>.json`` (the closed loop's lengths, clients and trace
span), ``limits/<cell>.json`` (the correctness limits, with the
readings they were set from) and ``metrics/<metric>.py`` (one reader a
metric).  The yardstick (``yardstick.py``: peaks, FLOP and byte
counts), the traffic generator (``traffic.py``), the weights
(``weights.py``), the trace reduction (``trace_reduce.py``) and the
plain reference that decides ``correct`` (``reference.py``) live here,
outside the program, so that a change to the program cannot move them.
"""
