"""Readings for the limits of `correct`: the check's numbers for a cell
over many seeds, of the program or of the control (the reference one
precision below, reference/control.py) put in its place, in one process.

  python3 evd_bench/control.py --workload gen1_serve_b128 \\
      --system control --seconds 1 --seeds 11 12 13

Each seed is a whole run of the cell (its set-up, a window of --seconds
at the cell's own batch and shapes, the steps the check captures, the
check); one JSON line a seed. The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--system", choices=("program", "control"),
                    required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch
    from evd_bench import harness, program
    from evd_bench.reference import control

    if not torch.cuda.is_available():
        print("evd_bench.control: no CUDA device", file=sys.stderr)
        return 2
    build = program.build if args.system == "program" else control.build
    bench = harness.Bench()
    for seed in args.seeds:
        t = time.perf_counter()
        result, rows = harness.run(bench, args.workload, seed, args.seconds,
                                   False, torch.device("cuda", 0), t,
                                   build=build)
        print(json.dumps({"workload": args.workload, "system": args.system,
                          "seed": seed, "correct": result["correct"],
                          "steps": result["attempted"],
                          "seconds": time.perf_counter() - t,
                          "readings": {k: v for k, v, _ in rows}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    sys.exit(main())
