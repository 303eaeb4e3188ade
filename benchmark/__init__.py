"""The benchmark of glu_tpu_torch on NVIDIA H100 cards.

`python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of BENCHMARK.json once and prints one JSON line. Everything a
cell needs is found by name (plugins.py): its configuration in
`configs/<config>.json`, its traffic mix in `traffic/<traffic>.json`
(parameters that the one generator, `workload.py`, reads), the op that the
mix names in `ops/<op>.py` (the program's call, its plain reference, its
control and its check), each input distribution in `dists/<dist>.py`, and
each metric's reader in `metrics/<metric>.py`. The plain reference's
arithmetic is in `reference/`. Nothing here imports jax or the JAX package.
"""
