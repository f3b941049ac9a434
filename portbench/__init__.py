"""The benchmark of serenedb_tpu_torch: whole SQL statements over the
port's Postgres wire from concurrent clients, on one NVIDIA H100.

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` and prints one JSON line.
Everything a cell needs is found by name: `configs/<config>.json` (the
deployment), `gen/<config>.py` (its data from the seed),
`reference/<config>.py` (the plain answers), `traffic/<mix>.json` (the
clients and their statements) and `metrics/<metric>.py` (one reader per
per-layer metric).
"""
