"""Run one cell of the benchmark once and print its result line.

  python3 evd_bench/run.py --workload <name> --seed <n> --seconds <s> \\
      --trace <0|1>

(or `python3 -m evd_bench.run ...`) from the repository root, on a machine
with the cards the cell asks for. The last line of standard output is one
JSON object: correct, attempted, failed, metrics (the cell's end-to-end
metrics, or with --trace 1 its per-layer ones), device, with --trace 1 the
trace's breakdown, and last the numbers the check compared with their
limits, which are also the last lines of standard error. Without a card,
with fewer cards than the cell asks for, or with JAX or the JAX package
loaded once the window has closed, it exits non-zero and prints no
result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "frlw_evd_tpu")


def loaded_forbidden():
    """Modules whose top-level name (before the first dot, compared whole)
    is JAX's or the JAX package's."""
    return sorted(k for k in sys.modules if k.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from evd_bench import harness

    bench = harness.Bench()
    chips = bench.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"evd_bench: {args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count {torch.cuda.device_count()}; no result",
              file=sys.stderr)
        return 2
    result, rows = harness.run(bench, args.workload, args.seed, args.seconds,
                               args.trace == 1, torch.device("cuda", 0), T0)
    found = loaded_forbidden()
    if found:
        print(f"evd_bench: loaded after the window: {found}; no result",
              file=sys.stderr)
        return 3
    for name, value, limit in rows:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def keep_bytecode():
    """Keep compiled bytecode, of torch and the port alike, in a fixed
    directory inside the checkout, and write it even where the environment
    turns writing off, so that only the first run in a checkout compiles
    the modules it imports: without it every process compiled torch's
    sources again (about 2 s of set-up on an H100 host)."""
    sys.pycache_prefix = str(Path(__file__).resolve().parent.parent
                             / "build" / "pycache")
    sys.dont_write_bytecode = False


if __name__ == "__main__":
    keep_bytecode()
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    sys.exit(main())
