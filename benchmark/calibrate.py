"""The readings that a cell's correctness limits are set from, in one
process at the cell's own size:

    python3 benchmark/calibrate.py --workload <name> --seeds 12 \\
        [--controls 3] [--faults 3] [--seconds 4] [--first-seed <n>]

For each seed: the cell's set-up (the first checked steps, or a short
window of sweeps) and the check's numbers for the program ("program"
lines); for the first `--controls` seeds the same numbers with the
reference in the next lower precision in the program's place ("control");
for training cells and the first `--faults` seeds, the program with half of
each batch left out and the mean taken over the rest ("fault_half_batch").
One JSON line each on standard output; the benchmark's own runs never run
this.
"""

import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import harness  # noqa: E402


@contextlib.contextmanager
def half_batch():
    """The trainer's step over the first half of each batch's rows."""
    from mvp_pytorch_tpu_torch.training.trainer import Trainer
    orig = Trainer._step

    def step(self, batch):
        return orig(self, {k: v[:v.shape[0] // 2] for k, v in batch.items()})
    Trainer._step = step
    try:
        yield
    finally:
        Trainer._step = orig


def readings(cell, seed, device, seconds, kind):
    import torch
    drv = cell.driver.Driver(cell, seed, device)
    fault = half_batch() if kind == "fault_half_batch" else \
        contextlib.nullcontext()
    with fault:
        drv.setup()
        if cell.traffic["driver"] != "train_step":
            drv.window(seconds)
    drv.free()
    out = {"kind": "program" if kind == "control" else kind, "seed": seed,
           "numbers": drv.check(), "detail": dict(drv.detail)}
    lines = [out]
    if kind == "control":
        lines.append({"kind": "control", "seed": seed,
                      "numbers": drv.control(), "detail": dict(drv.detail)})
    del drv
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--first-seed", type=int, default=3_000_000_000)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    harness.run_env()
    cell = harness.find_cell(args.workload)
    training = cell.traffic["driver"] == "train_step"
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        kinds = ["control" if i < args.controls else "program"]
        if training and i < args.faults:
            kinds.append("fault_half_batch")
        for kind in kinds:
            t = time.perf_counter()
            for line in readings(cell, seed, args.device, args.seconds,
                                 kind):
                line["s"] = time.perf_counter() - t
                print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
