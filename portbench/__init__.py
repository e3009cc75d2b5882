"""The port's benchmark: one cell of `BENCHMARK.json` run once.

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>` from the root of a checkout. A cell names a configuration
(`configs/<name>.json`: the matrix generator and its parameters), a traffic
mix (`traffic/<name>.json`: parameters that `drive.py` reads) and, through
`BENCHMARK.json`, its per-layer metrics (`metrics/<name>.py`, one reader
each). Nothing here imports JAX or the JAX package; `reference.py` and the
generators import nothing of the port either.
"""
