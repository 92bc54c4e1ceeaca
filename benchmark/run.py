"""Run one cell of the benchmark once and print its result as the last line
of standard output:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell's pieces are found by name (`harness.py`). The run sets up (the
program's kernels built or loaded, seeded weights and traffic on the card,
every shape warmed up), measures for `--seconds`, with `--trace 1` also
profiles a short window, then checks what the timed path produced against
the plain reference (`reference/`). It exits non-zero, printing no result,
without enough CUDA devices or when a JAX module got loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    harness.run_env()
    cell = harness.find_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"run.py: {args.workload} needs {cell.chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
