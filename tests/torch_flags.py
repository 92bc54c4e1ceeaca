"""The check that a port driver runs the training loop's tooling flags
(`--profile_dir`, `--async_ckpt`), shared by the driver tests. JAX-free."""

import json
import os

import torch

# the flags that raised as later port items until the tooling was ported
TOOLING_FLAGS = ("async_ckpt", "profile_dir")
RUN = ["--synthetic", "--tiny", "--platform", "cpu", "--do_train",
       "--max_steps", "2", "--ckpt_period", "2", "--log_period", "1",
       "--dtype", "float32", "--worker_start_method", "spawn",
       "--num_workers", "1"]


def trace_events(prof_dir):
    """The events of the one trace file in `prof_dir`."""
    files = os.listdir(prof_dir)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json"), files
    with open(os.path.join(prof_dir, files[0])) as f:
        return json.load(f)["traceEvents"]


def load_checkpoint(out, step):
    d = os.path.join(out, f"checkpoint-{step:07d}")
    return {name: torch.load(os.path.join(d, name), weights_only=True)
            for name in ("pytorch_model.bin", "optimizer.pt")}


def assert_tensors_equal(a, b, path=""):
    """Equal nested dicts of tensors (and other values), bit for bit."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            assert_tensors_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


def check_tooling_flag(main, flag, out, extra=()):
    """`main` (a driver's) runs two tiny training steps with `--{flag}`:
    with --profile_dir one trace of the second step (one `train_step`
    region); with --async_ckpt a checkpoint equal, bit for bit, to the one a
    synchronous run writes."""
    run = RUN + list(extra)
    if flag == "profile_dir":
        prof = os.path.join(out, "prof")
        hist = main(["--output_dir", out, "--profile_dir", prof,
                     "--profile_start", "1", "--profile_steps", "1"]
                    + run)["train"]
        assert len(hist) == 2
        steps = [e for e in trace_events(prof)
                 if e.get("name") == "train_step"
                 and e.get("cat") == "user_annotation"]
        assert len(steps) == 1, steps
        return
    assert flag == "async_ckpt", flag
    main(["--output_dir", os.path.join(out, "async"), "--async_ckpt"] + run)
    main(["--output_dir", os.path.join(out, "sync")] + run)
    assert_tensors_equal(load_checkpoint(os.path.join(out, "async"), 2),
                         load_checkpoint(os.path.join(out, "sync"), 2))
