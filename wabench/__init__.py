"""wabench: the benchmark of webaudio_tpu_torch on NVIDIA H100s.

    python3 -m wabench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

runs one cell of BENCHMARK.json once.  Everything that belongs to one
configuration, traffic mix or metric is found by its name:
`configs/<config>.json` (the sizes) beside `configs/<config>.py` (the
graph, built through the port's public API, behind the hooks that every
configuration has alike), `traffic/<mix>.json` (the parameters of the
request loop that its `driver` key names, `drivers/<driver>.py`),
`metrics/<metric>.py` (a reader; `metrics/<quantity>.py` serves
`<quantity>.<suffix>`), `limits/<workload>.json` (the limits of the
output check) and `reference/<config>.py` (the plain reference, which
imports nothing of the port).  The tests' small sizes sit in each
configuration's and mix's file under "tiny".
"""
