"""Real-weight parity runbook: a reference checkpoint -> the two-stage
retrieval eval -> the published R@K, in one command (the JAX package's
`tools_tpu/parity_runbook.py`).

    python -m mvp_pytorch_tpu_torch.tools.parity_runbook \\
        --reference_ckpt /path/to/mvptr_base_coco \\
        --feature_tsv   predictions.tsv (imageid2idx.json beside it) \\
        --captions_json retrieval captions json (RetrievalDataset contract) \\
        --out /tmp/parity_run \\
        [--expected '{"fine_i2t_retrieval_R@1": 77.3,
                      "fine_t2i_retrieval_R@1": 60.1}'] [--tol 0.5] \\
        [--extra_eval_args '--platform cpu']

The reference checkpoint directory (`pytorch_model.bin`, `config.json`,
`vocab.txt`) is read as it is: this package's models carry the reference's
state-dict keys, so there is no convert step. Expected-metric keys are
section-qualified: {coarse|fine}_{i2t|t2i}_retrieval_R@{1,5,10}.

Steps:
  1. the two-stage retrieval eval (`python -m
     mvp_pytorch_tpu_torch.tasks.retrieval --do_eval --model_name_or_path
     <reference_ckpt>`: the reference's test_coarse -> rerank -> test_fine
     flow, reference oscar/run_retrieval.py:694-871), on the card unless
     `--extra_eval_args` holds `--platform cpu`; it writes
     `<out>/eval/test_eval.json`;
  2. compare its R@K against `--expected` (e.g. the published MSCOCO
     5k-test IR/TR R@1 60.1/77.3, reference README.md:15-22).

Exit code: the eval's own when it fails; 1 when a metric is missing or
outside `--tol`; 0 otherwise, also when no `--expected` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def flatten_metrics(res: dict) -> dict:
    """test_eval.json -> a flat dict. Keys are section-qualified
    ({coarse|fine}_{i2t|t2i}_retrieval_R@K): coarse and fine report the
    same {direction}_{R@K} leaves, so an unqualified key would let fine
    overwrite coarse."""
    flat = {}
    for section, v in res.items():     # section: coarse | fine
        if isinstance(v, dict):
            for dirn, m in v.items():  # dirn: i2t_retrieval | t2i_retrieval
                if isinstance(m, dict):
                    for k, val in m.items():   # k: R@1 | R@5 | R@10
                        flat[f"{section}_{dirn}_{k}"] = val
                else:
                    flat[f"{section}_{dirn}"] = m
        else:
            flat[section] = v
    return flat


def compare_metrics(flat: dict, expected: dict, tol: float) -> list:
    """Expected values are percent (the reference README's convention);
    fractions are scaled to percent. Returns the failures (empty: parity)."""
    failures = []
    for k, want in expected.items():
        got = flat.get(k)
        if got is None:
            failures.append(f"{k}: metric missing (have {sorted(flat)})")
            continue
        got_pct = got * 100.0 if got <= 1.0 else got
        if abs(got_pct - want) > tol:
            failures.append(f"{k}: got {got_pct:.2f}, expected {want} "
                            f"(tol {tol})")
        else:
            print(f"PARITY RUNBOOK: {k} OK ({got_pct:.2f} vs {want})")
    return failures


def eval_command(args) -> list:
    """The two-stage eval's command line; every flag is one that
    `tasks/retrieval.py`'s parser takes."""
    cmd = [sys.executable, "-m", "mvp_pytorch_tpu_torch.tasks.retrieval",
           "--model_name_or_path", args.reference_ckpt,
           "--output_dir", os.path.join(args.out, "eval"), "--do_eval",
           "--feature_tsv", args.feature_tsv,
           "--captions_json", args.captions_json,
           "--num_captions_per_img", str(args.num_captions_per_img),
           "--eval_batch_size", str(args.eval_batch_size)]
    if args.id2phrase:
        cmd += ["--id2phrase", args.id2phrase]
    return cmd + [a for a in args.extra_eval_args.split() if a]


def get_args(argv=None):
    p = argparse.ArgumentParser(
        description="reference checkpoint -> two-stage eval -> compare")
    p.add_argument("--reference_ckpt", required=True,
                   help="checkpoint dir (pytorch_model.bin + config.json + "
                        "vocab.txt)")
    p.add_argument("--feature_tsv", required=True,
                   help="predictions.tsv with imageid2idx.json beside it "
                        "(FeatureStore contract)")
    p.add_argument("--captions_json", required=True,
                   help="retrieval captions json (RetrievalDataset "
                        "contract)")
    p.add_argument("--id2phrase", default=None,
                   help="optional id2phrase json (phrase vocab)")
    p.add_argument("--num_captions_per_img", type=int, default=5)
    p.add_argument("--out", required=True)
    p.add_argument("--expected", default=None,
                   help="JSON dict of expected metrics, e.g. "
                        '\'{"fine_i2t_retrieval_R@1": 77.3, '
                        '"fine_t2i_retrieval_R@1": 60.1}\' '
                        "(percent, reference README.md:15-22)")
    p.add_argument("--tol", type=float, default=0.5,
                   help="absolute tolerance in percentage points")
    p.add_argument("--eval_batch_size", type=int, default=64)
    p.add_argument("--extra_eval_args", default="",
                   help="extra flags forwarded to tasks.retrieval (e.g. "
                        "'--platform cpu --dtype float32')")
    return p.parse_args(argv)


def main(argv=None, timeout: Optional[float] = None) -> int:
    """Run the runbook; `timeout` bounds the eval's seconds (None: no
    bound; past it `subprocess.TimeoutExpired` is raised)."""
    args = get_args(argv)
    os.makedirs(args.out, exist_ok=True)

    # 1. eval (two-stage retrieval)
    sys.stdout.flush()
    t0 = time.perf_counter()
    rc = subprocess.run(eval_command(args), cwd=REPO,
                        timeout=timeout).returncode
    if rc != 0:
        print(f"PARITY RUNBOOK: eval failed rc={rc}", file=sys.stderr,
              flush=True)
        return rc
    print(f"PARITY RUNBOOK: eval took {time.perf_counter() - t0:.1f} s",
          flush=True)

    # 2. compare
    with open(os.path.join(args.out, "eval", "test_eval.json")) as f:
        res = json.load(f)
    print(f"PARITY RUNBOOK: eval metrics {json.dumps(res)}")
    if not args.expected:
        print("PARITY RUNBOOK: no --expected given; done (record the "
              "metrics above)")
        return 0
    failures = compare_metrics(flatten_metrics(res),
                               json.loads(args.expected), args.tol)
    if failures:
        print("PARITY RUNBOOK: FAILED\n  " + "\n  ".join(failures),
              file=sys.stderr)
        return 1
    print("PARITY RUNBOOK: all expected metrics within tolerance")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
