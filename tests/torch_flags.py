"""Helpers shared by the port's driver tests: how a driver's loader workers
start in a process that holds JAX, the loader's deadline, the environment of
a port subprocess, and the check that a driver runs the training loop's
tooling flags (`--profile_dir`, `--async_ckpt`). JAX-free."""

import contextlib
import functools
import json
import multiprocessing
import os
import tempfile

import pytest
import torch

# A process that holds JAX must not fork, so the drivers' loader workers
# start from a fork server: a fresh interpreter (exec'd, holding no JAX) that
# imports the port's drivers once, of which each worker is a fork. A spawned
# worker would import torch anew, about 3 s a worker. The server listens on
# a socket under the temporary directory; where that path would not fit a
# socket address (107 bytes), the workers are spawned.
multiprocessing.set_forkserver_preload(["mvp_pytorch_tpu_torch.tasks.common"])
WORKERS = ["--worker_start_method",
           "forkserver" if len(tempfile.gettempdir()) <= 64 else "spawn",
           "--num_workers"]
LOADER_TIMEOUT = 60.0

# the tooling flags, which each training driver takes
TOOLING_FLAGS = ("async_ckpt", "profile_dir")
RUN = ["--synthetic", "--tiny", "--platform", "cpu", "--do_train",
       "--max_steps", "2", "--ckpt_period", "2", "--log_period", "1",
       "--dtype", "float32"] + WORKERS + ["1"]


@contextlib.contextmanager
def bounded_loader():
    """The drivers' loader workers must answer within LOADER_TIMEOUT s, or
    the run fails instead of waiting."""
    from mvp_pytorch_tpu_torch.data.loader import ProcessLoader
    from mvp_pytorch_tpu_torch.tasks import common
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(common, "ProcessLoader",
                   functools.partial(ProcessLoader, timeout=LOADER_TIMEOUT))
        yield


def subprocess_env():
    """The test's environment for a port subprocess: no PYTHONPATH, and one
    OpenMP thread, as the test's own process runs torch. A pool of a thread
    per core in each of the suite's workers oversubscribes the host and
    slows a step many times."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    return env


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


def tooling_runs(main, out, extra=()):
    """Two tiny training steps of a driver's `main`, twice: a synchronous
    run with --profile_dir tracing the second step, and a run with
    --async_ckpt. Returns {flag: what `check_tooling_flag` reads}."""
    run = RUN + list(extra)
    sync, prof = os.path.join(out, "sync"), os.path.join(out, "prof")
    with bounded_loader():
        hist = main(["--output_dir", sync, "--profile_dir", prof,
                     "--profile_start", "1", "--profile_steps", "1"]
                    + run)["train"]
        main(["--output_dir", os.path.join(out, "async"), "--async_ckpt"]
             + run)
    return {"profile_dir": (hist, trace_events(prof)),
            "async_ckpt": (load_checkpoint(os.path.join(out, "async"), 2),
                           load_checkpoint(sync, 2))}


def check_tooling_flag(runs, flag):
    """Of `tooling_runs`: with --profile_dir two steps and one trace of the
    second (one `train_step` region); with --async_ckpt a checkpoint equal,
    bit for bit, to the one the synchronous run writes."""
    if flag == "profile_dir":
        hist, events = runs[flag]
        assert len(hist) == 2
        steps = [e for e in events
                 if e.get("name") == "train_step"
                 and e.get("cat") == "user_annotation"]
        assert len(steps) == 1, steps
        return
    assert flag == "async_ckpt", flag
    assert_tensors_equal(*runs[flag])
