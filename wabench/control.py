"""The readings that the output check's limits are set from (not run by
the benchmark's own runs):

    python3 -m wabench.control --workload <name> --seconds <s> --seeds <n> [<n> ...] [--precisions <p> ...]

For each seed, in one process: a run of the cell (set-up, a window of
`--seconds` at the cell's own load, its sample of results), then
- the program's reading: its outputs against the plain reference, as
  the run's check compares them;
- the control's reading: the reference computed in the precision below
  the configuration's (float64 -> float32; float32, which the port runs
  with TF32 off -> tfloat32, every operation rounded) put in the
  program's place and compared the same way;
- the same for each further precision of `--precisions`, such as
  "float32,fir=tfloat32" (a configuration's reference may round one
  stage apart).
One JSON line a seed on standard output.  The limit lies above the
largest program reading and below the smallest control reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from wabench import run as runner
from wabench.core import bench

BELOW = {"float64": "float32", "float32": "tfloat32"}


def readings(cell, seed, seconds, device="cuda", further=()):
    t0 = time.perf_counter()
    run, drv, _, forbidden = runner.execute(cell, seed, seconds, 0,
                                            device=device, t0=t0)
    if forbidden:
        raise RuntimeError(f"the run loaded {forbidden}")
    program = drv.check()
    below = BELOW[cell.cfg["precision"]]
    drv.substitute(below)
    control = drv.check()
    others = {}
    for precision in further:
        drv.substitute(precision)
        others[precision] = drv.check()
    return {"workload": cell.name, "seed": seed,
            "requests": len(run.requests),
            "failed": sum(1 for r in run.requests if not r.ok),
            "program": program, "control": control,
            "control_precision": below, "further": others}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--precisions", nargs="*", default=[])
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("wabench.control: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        cell = bench.cell(args.workload)
        print(json.dumps(readings(cell, seed, args.seconds,
                                  further=args.precisions)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
