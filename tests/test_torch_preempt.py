"""The port's preemption checkpoint, on the CPU.

The retrieval command line runs in a subprocess of its own session (it
imports only the port, so its loader workers fork). A SIGTERM to the whole
process group after the first `metrics.jsonl` line must give rc 0, exactly
one checkpoint at a step s < --max_steps, no eval, and a resume to s + 3
whose weights equal those of an uninterrupted run to s + 3 (within 1e-6;
dropout is drawn from (seed, step), so the resume repeats it). Over two
gloo ranks under the port's launcher, a SIGTERM to rank 1 alone makes both
ranks save at the same step and exit 0.
"""

import glob
import json
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from torch_flags import subprocess_env

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 90
RUN = [sys.executable, "-m", "mvp_pytorch_tpu_torch.tasks.retrieval",
       "--synthetic", "--tiny", "--platform", "cpu", "--do_train",
       "--dtype", "float32", "--train_batch_size", "8", "--log_period", "1",
       "--scheduler", "constant", "--hidden_dropout_prob", "0.1",
       "--num_workers", "2", "--worker_start_method", "fork"]
WEIGHT_TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    """torch single-threaded in this process: no intra-op thread pool is left
    behind for a later test in the same worker that forks."""
    torch.set_num_threads(1)


def run(args, timeout=DEADLINE_S):
    res = subprocess.run(args, cwd=ROOT, env=subprocess_env(),
                         capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0, res.stderr[-3000:]
    return res


def start(args):
    """`args` in a new session (its own process group)."""
    return subprocess.Popen(args, cwd=ROOT, env=subprocess_env(), text=True,
                            start_new_session=True, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)


def wait_for_metrics(proc, out):
    """Block until `out`'s metrics.jsonl has a line; fail past the
    deadline or if `proc` ends first."""
    path = os.path.join(out, "train_logs", "metrics.jsonl")
    deadline = time.monotonic() + DEADLINE_S
    while not (os.path.exists(path) and os.path.getsize(path) > 0):
        if proc.poll() is not None:
            pytest.fail(f"ended with {proc.returncode} before a metrics "
                        f"line: {proc.stdout.read()[-3000:]}")
        if time.monotonic() > deadline:
            os.killpg(proc.pid, signal.SIGKILL)
            pytest.fail("no metrics line within the deadline")
        time.sleep(0.05)


def finish(proc):
    """(rc, output) of `proc`, killed past the deadline."""
    try:
        out, _ = proc.communicate(timeout=DEADLINE_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        pytest.fail(f"did not exit within {DEADLINE_S} s: {out[-3000:]}")
    return proc.returncode, out


def checkpoints(out):
    return sorted(os.path.basename(d)
                  for d in glob.glob(os.path.join(out, "checkpoint-*")))


def weights(out, step):
    return torch.load(os.path.join(out, f"checkpoint-{step:07d}",
                                   "pytorch_model.bin"), weights_only=True)


def max_diff(a, b):
    assert sorted(a) == sorted(b)
    return max(float((a[k].double() - b[k].double()).abs().max())
               for k in a)


@pytest.mark.budget(240)
def test_sigterm_to_the_group_saves_stops_and_resumes(tmp_path):
    out = str(tmp_path / "preempted")
    proc = start(RUN + ["--output_dir", out, "--max_steps", "500",
                        "--ckpt_period", "500", "--async_ckpt",
                        "--do_eval"])
    wait_for_metrics(proc, out)
    os.killpg(proc.pid, signal.SIGTERM)
    rc, log = finish(proc)
    assert rc == 0, log[-3000:]
    ckpts = checkpoints(out)
    assert len(ckpts) == 1, ckpts
    s = int(ckpts[0].split("-")[-1])
    assert 1 <= s < 500
    assert f"preemption checkpoint saved at step {s}; stopping" in log
    assert not os.path.exists(os.path.join(out, "eval_logs.json"))
    with open(os.path.join(out, "last_checkpoint")) as f:
        assert f.read().strip() == ckpts[0]

    res = run(RUN + ["--output_dir", out, "--max_steps", str(s + 3)])
    assert "resumed from" in res.stdout + res.stderr
    whole = str(tmp_path / "whole")
    run(RUN + ["--output_dir", whole, "--max_steps", str(s + 3)])
    assert max_diff(weights(out, s + 3), weights(whole, s + 3)) <= WEIGHT_TOL


def rank_pids(launcher_pid):
    """{rank: pid} of the launcher's children (their RANK variable)."""
    pids = {}
    with open(f"/proc/{launcher_pid}/task/{launcher_pid}/children") as f:
        children = [int(p) for p in f.read().split()]
    for pid in children:
        with open(f"/proc/{pid}/environ", "rb") as f:
            env_vars = dict(kv.split(b"=", 1) for kv in f.read().split(b"\0")
                            if b"=" in kv)
        pids[int(env_vars[b"RANK"])] = pid
    return pids


@pytest.mark.budget(240)
def test_sigterm_to_one_rank_stops_both_at_one_step(tmp_path):
    out = str(tmp_path / "two")
    proc = start([sys.executable, "-m", "mvp_pytorch_tpu_torch.tools.launch",
                  "--nproc", "2", "--"] + RUN[1:]
                 + ["--output_dir", out, "--max_steps", "500",
                    "--ckpt_period", "500"])
    wait_for_metrics(proc, out)
    pids = rank_pids(proc.pid)
    assert sorted(pids) == [0, 1]
    os.kill(pids[1], signal.SIGTERM)
    rc, log = finish(proc)
    assert rc == 0, log[-3000:]
    ckpts = checkpoints(out)
    assert len(ckpts) == 1, ckpts
    s = int(ckpts[0].split("-")[-1])
    assert 1 <= s < 500
    with open(os.path.join(out, ckpts[0], "opt_shards",
                           "manifest.json")) as f:
        assert json.load(f)["world_size"] == 2
    assert sorted(os.listdir(os.path.join(out, ckpts[0], "opt_shards"))) == [
        "manifest.json", "shard-00000.npz", "shard-00001.npz"]
    # rank 1 wrote its pieces into the one checkpoint (and exited 0: the
    # launcher's rc is 0 only if every rank's is); rank 0 logs for both
    with open(os.path.join(out, "log.txt")) as f:
        assert f"preemption checkpoint saved at step {s}; stopping" in f.read()
