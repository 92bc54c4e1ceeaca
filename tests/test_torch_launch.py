"""The port's launcher (`tools/launch.py`) and rendezvous
(`parallel/distributed.py`), on the CPU.

- the env contract: WORLD_SIZE, RANK, LOCAL_RANK, COORDINATOR_ADDRESS and
  its MASTER_ADDR / MASTER_PORT; rank 0's output passes through, rank 1's
  is prefixed; OMP_NUM_THREADS=1 for more than one rank unless the caller
  set it (said on stderr), a caller's value kept;
- the first failure takes the job down and sets the launcher's exit code;
- a SIGTERM to the launcher reaches every rank;
- a rendezvous that cannot complete raises within DIST_INIT_TIMEOUT_S;
- one rank joins no group unless a parallel flag asks for one (then gloo
  under --platform cpu); without --platform cpu the card is required, with
  no fall back to the CPU or to gloo;
- the drivers' parallel flags over 2 ranks write a checkpoint that holds
  the optimizer's shards, the config and the vocabulary.

Every launch runs with a deadline. The three driver runs share one module
fixture; a run past its deadline is recorded as that run's result, so it
fails its own case only.
"""

import json
import os
import signal
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest

from mvp_pytorch_tpu_torch.parallel import distributed
from mvp_pytorch_tpu_torch.tools.launch import free_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE = 60


def run(args, env=None, timeout=DEADLINE):
    """`env` entries override the test's environment; a None value unsets
    the variable."""
    env = dict({k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
               **(env or {}))
    env = {k: v for k, v in env.items() if v is not None}
    return subprocess.run([sys.executable] + args, cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def launch(nproc, code, **kw):
    return run(["-m", "mvp_pytorch_tpu_torch.tools.launch", "--nproc",
                str(nproc), "--", "-c", code], **kw)


ENV_CODE = ("import json, os; print(json.dumps({k: os.environ.get(k) for k "
            "in ('WORLD_SIZE', 'RANK', 'LOCAL_RANK', 'COORDINATOR_ADDRESS', "
            "'MASTER_ADDR', 'MASTER_PORT', 'OMP_NUM_THREADS')}))")
OMP_LINE = "launch: OMP_NUM_THREADS is not set"


def rank_envs(res, nproc):
    """The environment each rank printed (ENV_CODE)."""
    envs = [json.loads(res.stdout.strip())]
    for r in range(1, nproc):
        line = next(ln for ln in res.stderr.splitlines()
                    if ln.startswith(f"[rank {r}] {{"))
        envs.append(json.loads(line[len(f"[rank {r}] "):]))
    return envs


def test_env_contract_and_output():
    res = launch(2, ENV_CODE, env={"OMP_NUM_THREADS": None})
    assert res.returncode == 0, res.stderr
    env0, env1 = rank_envs(res, 2)
    for rank, env in enumerate((env0, env1)):
        assert env["WORLD_SIZE"] == "2"
        assert env["RANK"] == env["LOCAL_RANK"] == str(rank)
        host, port = env["COORDINATOR_ADDRESS"].rsplit(":", 1)
        assert (env["MASTER_ADDR"], env["MASTER_PORT"]) == (host, port)
        assert env["OMP_NUM_THREADS"] == "1"
    assert env0["COORDINATOR_ADDRESS"] == env1["COORDINATOR_ADDRESS"]
    assert sum(OMP_LINE in ln for ln in res.stderr.splitlines()) == 1


@pytest.mark.parametrize("nproc, given", [(2, "3"), (1, None)],
                         ids=["callers_value_kept", "one_rank_unchanged"])
def test_thread_setting_left_alone(nproc, given):
    """A caller's own OMP_NUM_THREADS reaches every rank as it was; one rank
    gets the environment unchanged (unset stays unset)."""
    res = launch(nproc, ENV_CODE, env={"OMP_NUM_THREADS": given})
    assert res.returncode == 0, res.stderr
    assert [e["OMP_NUM_THREADS"] for e in rank_envs(res, nproc)] == \
        [given] * nproc
    assert OMP_LINE not in res.stderr


def test_first_failure_takes_the_job_down():
    code = ("import os, sys, time\n"
            "if os.environ['RANK'] == '1': sys.exit(3)\n"
            "time.sleep(50)\n")
    t0 = time.monotonic()
    res = launch(2, code)
    assert res.returncode == 3
    assert time.monotonic() - t0 < 30
    assert "rank 1 exited rc=3" in res.stderr


def test_sigterm_reaches_every_rank(tmp_path):
    code = ("import os, signal, sys, time\n"
            f"d = {str(tmp_path)!r}\n"
            "r = os.environ['RANK']\n"
            "def term(*a):\n"
            "    open(os.path.join(d, 'term' + r), 'w').close(); sys.exit(0)\n"
            "signal.signal(signal.SIGTERM, term)\n"
            "open(os.path.join(d, 'ready' + r), 'w').close()\n"
            "time.sleep(50)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "mvp_pytorch_tpu_torch.tools.launch",
         "--nproc", "2", "--", "-c", code], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        deadline = time.monotonic() + DEADLINE
        while not all((tmp_path / f"ready{r}").exists() for r in "01"):
            assert time.monotonic() < deadline and proc.poll() is None
            time.sleep(0.1)
        proc.send_signal(signal.SIGTERM)
        proc.communicate(timeout=DEADLINE)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
    assert proc.returncode == 0
    assert all((tmp_path / f"term{r}").exists() for r in "01")


def test_failed_rendezvous_raises_within_the_timeout():
    code = ("from mvp_pytorch_tpu_torch.parallel import distributed\n"
            "distributed.initialize('cpu')\n")
    t0 = time.monotonic()
    res = run(["-c", code], env={
        "WORLD_SIZE": "2", "RANK": "0", "DIST_INIT_TIMEOUT_S": "3",
        "COORDINATOR_ADDRESS": f"localhost:{free_port()}"})
    assert res.returncode != 0
    assert time.monotonic() - t0 < 40
    assert "Error" in res.stderr


def test_one_rank_starts_a_group_only_when_asked():
    code = ("import json, types\n"
            "from mvp_pytorch_tpu_torch.parallel import distributed as d\n"
            "a = types.SimpleNamespace(platform='cpu', fsdp={fsdp})\n"
            "i = d.init_runtime(a)\n"
            "print(json.dumps([i['world_size'], i['backend'], "
            "d.dist.is_initialized()]))\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "PYTHONPATH")}
    for fsdp, want in ((False, [1, "gloo", False]), (True, [1, "gloo", True])):
        res = subprocess.run([sys.executable, "-c", code.format(fsdp=fsdp)],
                             cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=DEADLINE)
        assert res.returncode == 0, res.stderr
        assert json.loads(res.stdout.strip().splitlines()[-1]) == want


def test_no_fallback_without_a_card(monkeypatch):
    monkeypatch.setattr(distributed.torch.cuda, "is_available",
                        lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        distributed.initialize(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        distributed.init_runtime(SimpleNamespace(platform=None, fsdp=True))


def test_coordinator_address_maps_to_master(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("MASTER_PORT", raising=False)
    monkeypatch.setenv("COORDINATOR_ADDRESS", "node7:1234")
    distributed._env_rendezvous()
    assert os.environ["MASTER_ADDR"] == "node7"
    assert os.environ["MASTER_PORT"] == "1234"


# the drivers' parallel flags over 2 gloo ranks: flag sets -> what the
# checkpoint must hold
CLI_RUNS = {
    "retrieval_fsdp_coarse_block": (
        "retrieval", ["--do_train", "--do_eval", "--fsdp", "--coarse_block",
                      "16", "--hidden_dropout_prob", "0"]),
    "retrieval_gpipe": (
        "retrieval", ["--do_train", "--pipeline_parallel", "2",
                      "--pipeline_microbatches", "2"]),
    "pretrain_tp_sp_moe": (
        "pretrain", ["--model_parallel", "2", "--sequence_parallel",
                     "--moe_experts", "4", "--moe_top_k", "2"]),
}


def run_cli(task, flags, out):
    """One driver over 2 gloo ranks through the launcher, with a deadline;
    returns (exit code, log), the exit code None for a run killed at the
    deadline."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "mvp_pytorch_tpu_torch.tools.launch",
         "--nproc", "2", "--", "-m", f"mvp_pytorch_tpu_torch.tasks.{task}",
         "--output_dir", str(out), "--synthetic", "--tiny", "--platform",
         "cpu", "--max_steps", "2", "--train_batch_size", "8",
         "--num_workers", "1", "--ckpt_period", "2"] + flags,
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=DEADLINE)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        log, _ = proc.communicate()
        return None, f"{log}\n{task} {flags} ran past {DEADLINE} s"
    return proc.returncode, log


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Each of CLI_RUNS once (the runs start processes: module setup); a
    run past its deadline is that run's result, not the fixture's error."""
    out = {}
    for run, (task, flags) in CLI_RUNS.items():
        d = tmp_path_factory.mktemp(run) / "out"
        out[run] = run_cli(task, flags, d) + (d,)
    return out


@pytest.mark.parametrize("run", list(CLI_RUNS))
def test_driver_flags_run_on_two_ranks(cli_runs, run):
    rc, log, out = cli_runs[run]
    assert rc == 0, log[-4000:]
    ckpt = out / "checkpoint-0000002"
    with open(ckpt / "opt_shards" / "manifest.json") as f:
        assert json.load(f)["world_size"] == 2
    cfg = json.loads((ckpt / "config.json").read_text())
    assert cfg["pipeline_stages"] == (2 if "gpipe" in run else 0)
    assert cfg["moe_experts"] == (4 if "moe" in run else 0)
    assert (ckpt / "pytorch_model.bin").exists()
    # the driver's vocabulary, copied from the output directory
    assert (ckpt / "vocab.txt").read_bytes() == \
        (out / "vocab.txt").read_bytes()
    if "coarse_block" in run:
        assert "coarse:" in (out / "log.txt").read_text()
