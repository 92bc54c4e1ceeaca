"""The port's tooling against the JAX package's, on the CPU: the TSV helpers,
`utils/misc.py`, `cached_path`, `inspect_ckpt`, the training loop's
telemetry and the load-test client; and, port only, `AsyncSaver`, the
profiler hooks and the `--profile_dir` window of a resumed run.

Same inputs on both sides: `tsv_concat` / `tsv_reorder` / `tsv_delete`
write byte-identical `.tsv` and `.lineidx` files; `weighted_sample` draws
the same indices from the same `random.Random`; `set_seed` leaves Python's
and numpy's streams where the JAX one leaves them; `cached_path` gives the
same answers for a local path, a `file://` URL, a cached URL and a missing
file; `inspect_ckpt` reports the same config and parameter count for the
port's checkpoint of weights converted from a JAX tiny pretraining model as
the JAX tool for the JAX checkpoint; a CLI's metrics.jsonl log lines carry
the JAX CLI's telemetry keys, but the memory keys, which on the CPU are the
named difference.
"""

import functools
import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvp_pytorch_tpu.convert import export_state_dict
from mvp_pytorch_tpu.data import tsv as jax_tsv
from mvp_pytorch_tpu.models import pretrain as jax_pretrain
from mvp_pytorch_tpu.models.config import ModelConfig as JaxConfig
from mvp_pytorch_tpu.tasks import retrieval as jax_retrieval
from mvp_pytorch_tpu.tools import inspect_ckpt as jax_inspect
from mvp_pytorch_tpu.training.checkpoint import save_pretrained
from mvp_pytorch_tpu.utils import file_utils as jax_files
from mvp_pytorch_tpu.utils import misc as jax_misc
from mvp_pytorch_tpu_torch.convert import load_jax_params
from mvp_pytorch_tpu_torch.data import tsv as port_tsv
from mvp_pytorch_tpu_torch.models import BiPretrainModel, ModelConfig
from mvp_pytorch_tpu_torch.tasks import retrieval as port_retrieval
from mvp_pytorch_tpu_torch.tools import inspect_ckpt as port_inspect
from mvp_pytorch_tpu_torch.tools import load_test_serve
from mvp_pytorch_tpu_torch.training import profiler
from mvp_pytorch_tpu_torch.training.checkpoint import (AsyncSaver,
                                                       CheckpointManager)
from mvp_pytorch_tpu_torch.training.optim import make_optimizer
from mvp_pytorch_tpu_torch.training.trainer import Trainer
from mvp_pytorch_tpu_torch.utils import file_utils as port_files
from mvp_pytorch_tpu_torch.utils import misc as port_misc
from torch_flags import WORKERS, assert_tensors_equal, trace_events

# the JAX loop's memory keys on the CPU (live jax arrays; XLA's buffer
# assignment), which the port has no counterpart of there: on the card it
# logs hbm_peak_gb / hbm_gb / hbm_limit_gb and step_peak_gb / step_args_gb /
# step_temp_gb
JAX_CPU_MEMORY_KEYS = {"hbm_live_gb", "step_peak_gb", "step_args_gb",
                       "step_temp_gb", "step_out_gb"}
# the port's own per-step keys (the loader's and the loop's timings)
PORT_STEP_KEYS = {"data_ms", "step_ms", "worker_ms"}
TELEMETRY = {"steps_per_sec", "examples_per_sec", "time_data",
             "time_compute"}
# the tied LM decoders that `convert.export_state_dict` materialises and the
# port's pretraining model does not store (it ties them functionally)
TIED_DECODERS = {"cls.predictions.decoder.weight", "half_mlm.decoder.weight"}


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    """torch single-threaded in this process: no intra-op thread pool is left
    behind for a later test in the same worker that forks."""
    torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# TSV helpers and utils
# ---------------------------------------------------------------------------

def write_sources(d):
    rs = np.random.RandomState(0)
    paths = []
    for i in range(2):
        rows = [[f"k{i}_{j}", str(rs.randint(1000)), "x" * rs.randint(1, 9)]
                for j in range(7)]
        path = os.path.join(d, f"src{i}.tsv")
        jax_tsv.tsv_writer(rows, path)
        paths.append(path)
    with open(paths[1], "a") as f:    # an empty line, which concat drops
        f.write("\n")
    return paths


def file_bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("op", ["concat", "reorder", "delete"])
def test_tsv_helpers_write_the_jax_files(tmp_path, op):
    srcs = write_sources(str(tmp_path))
    outs = {}
    for name, mod in (("jax", jax_tsv), ("port", port_tsv)):
        out = str(tmp_path / name / "out.tsv")
        if op == "concat":
            mod.tsv_concat(srcs, out)
        elif op == "reorder":
            mod.tsv_reorder(srcs[0], [6, 0, 3, 3, 1], out)
        else:
            mod.tsv_delete(srcs[0], [5, 1, 1], out)
        outs[name] = out
    for ext in (".tsv", ".lineidx"):
        got = file_bytes(outs["port"].replace(".tsv", ext))
        assert got == file_bytes(outs["jax"].replace(".tsv", ext)), ext
        assert got
    assert len(port_tsv.TSVFile(outs["port"])) == {
        "concat": 14, "reorder": 5, "delete": 5}[op]


def test_weighted_sample_draws_the_jax_indices():
    weights = [0.5, 3.0, 0.0, 1.5, 2.0]
    got = [port_misc.weighted_sample(weights, r)
           for r in [random.Random(7)] for _ in range(200)]
    want = [jax_misc.weighted_sample(weights, r)
            for r in [random.Random(7)] for _ in range(200)]
    assert got == want and 2 not in got and len(set(got)) == 4


def test_set_seed_leaves_the_streams_where_jax_does(tmp_path):
    port_misc.set_seed(123)
    got = (random.random(), np.random.rand(4))
    jax_misc.set_seed(123)
    want = (random.random(), np.random.rand(4))
    assert got[0] == want[0] and np.array_equal(got[1], want[1])
    d = str(tmp_path / "a" / "b")
    port_misc.mkdir(d)
    port_misc.mkdir(d)          # exists: quiet
    assert os.path.isdir(d)


def test_cached_path_agrees_with_jax_on_local_branches(tmp_path):
    local = tmp_path / "weights.bin"
    local.write_bytes(b"x")
    cache = str(tmp_path / "cache")
    url = "https://example.com/model/weights.bin"
    assert port_files.url_to_filename(url) == jax_files.url_to_filename(url)
    os.makedirs(cache)
    cached = os.path.join(cache, jax_files.url_to_filename(url))
    with open(cached, "wb") as f:
        f.write(b"y")
    for arg in (str(local), f"file://{local}", url):
        assert (port_files.cached_path(arg, cache)
                == jax_files.cached_path(arg, cache))
    for mod in (jax_files, port_files):
        with pytest.raises(FileNotFoundError):
            mod.cached_path(str(tmp_path / "missing"), cache)
        with pytest.raises(ValueError, match="unsupported scheme"):
            mod.cached_path("ftp://example.com/x", cache)


def test_cached_path_names_the_cache_of_an_uncached_url(tmp_path,
                                                        monkeypatch):
    """No fetch: an uncached remote URL raises, naming its cache file (the
    JAX function would try the network here, so only the port runs)."""
    import urllib.request

    def no_network(*a, **k):
        raise AssertionError("cached_path tried to fetch")
    monkeypatch.setattr(urllib.request, "urlopen", no_network)
    url = "s3://bucket/model.bin"
    want = os.path.join(str(tmp_path), port_files.url_to_filename(url))
    with pytest.raises(RuntimeError, match=want):
        port_files.cached_path(url, str(tmp_path))


# ---------------------------------------------------------------------------
# inspect_ckpt
# ---------------------------------------------------------------------------

def tiny_pretrain_params():
    cfg = JaxConfig(vocab_size=120, only_word_size=100, hidden_size=32,
                    num_hidden_layers=2, num_attention_heads=4,
                    intermediate_size=64, max_position_embeddings=64,
                    img_feature_dim=22, dtype="float32", qa_answer_size=7)
    la, t, r = 9, 4, 5
    z = functools.partial(jnp.zeros, dtype=jnp.int32)
    o = functools.partial(jnp.ones, dtype=jnp.int32)
    keys = {k: jax.random.PRNGKey(i) for i, k in
            enumerate(("params", "hardneg", "dropout", "wra"), 7)}
    params = jax.jit(lambda: jax_pretrain.BiPretrainModel(cfg).init(
        keys, z((2, la)), o((2, la)), z((2, la)),
        jnp.full((2, la), -1, jnp.int32), z((2, t)), o((2, t + r)),
        o((2, t)), jnp.full((2, t + r), -1, jnp.int32),
        jnp.zeros((2, r, 22)), jnp.asarray([[1, 3], [1, 2]]),
        jnp.asarray([[la, la + r]] * 2), z((2,)), z((2,)),
        max_tag_length=t, deterministic=True))()["params"]
    return cfg, jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.budget(120)
def test_inspect_ckpt_reports_what_the_jax_tool_reports(tmp_path, capsys):
    cfg, params = tiny_pretrain_params()
    jdir = str(tmp_path / "jax")
    save_pretrained(jdir, params, config=cfg)
    model = BiPretrainModel(ModelConfig.from_pretrained(jdir), qa_pairs=True,
                            device="cpu")
    load_jax_params(model, params)
    ckpt = CheckpointManager(str(tmp_path / "port"))
    pdir = ckpt.save(3, model, make_optimizer(model, 1e-3),
                     config=model.config, args={"seed": 1, "lr": 1e-3})
    want, got = jax_inspect.describe_dir(jdir), port_inspect.describe_dir(pdir)
    assert got["config"] == want["config"]
    assert got["n_params"] == want["n_params"] == sum(
        p.numel() for p in model.state_dict().values())
    assert got["n_leaves"] == want["n_leaves"]
    assert got["dtypes"] == want["dtypes"] == {"float32": got["n_leaves"]}
    # the port's tensors are exactly the reference's names that the JAX
    # export writes, but the tied decoders
    names = {leaf[0] for leaf in got["_leaves"]}
    assert names == set(export_state_dict(params)) - TIED_DECODERS
    assert got["format"] == ["pytorch_model.bin (torch state dict)",
                             "resumable (optimizer.pt)",
                             "train_meta.json (step 3)"]
    assert want["format"] == ["params.msgpack"]
    assert got["training_args_keys"] == ["lr", "seed"]
    assert "shards" not in got

    assert port_inspect.main([pdir, "--tree"]) == 0
    out = capsys.readouterr().out
    assert "pytorch_model.bin" in out and "half_mlm.transform.dense" in out
    assert port_inspect.main([pdir, "--json", "--tree"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert len(report["leaves"]) == got["n_leaves"]
    # a JAX dir is named, not decoded
    assert port_inspect.describe_dir(jdir)["format"] == [
        "params.msgpack (JAX; not decoded)"]


def test_inspect_ckpt_reads_a_sharded_optimizer(tmp_path):
    from mvp_pytorch_tpu_torch.training.sharded_checkpoint import \
        save_sharded
    d = tmp_path / "ck"
    save_sharded(str(d / "opt_shards"),
                 {"count": np.asarray(2), "mu": {"w": np.ones((3, 2))}})
    info = port_inspect.describe_dir(str(d))
    assert info["shards"] == {"world_size": 1, "leaves": 2}
    assert info["format"] == ["sharded (opt_shards: per-rank npz + manifest)"]
    assert "n_params" not in info


# ---------------------------------------------------------------------------
# the training loop: telemetry, trace window, async checkpoints
# ---------------------------------------------------------------------------

TINY = ["--synthetic", "--tiny", "--platform", "cpu", "--do_train",
        "--max_steps", "2", "--log_period", "1", "--train_batch_size", "8",
        "--dtype", "float32"]
LOADER = WORKERS + ["1"]


def log_lines(out):
    with open(os.path.join(out, "train_logs", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def keys_of(line):
    return {k[len("train/"):] for k in line if k.startswith("train/")}


@pytest.mark.budget(240)
def test_cli_log_lines_carry_the_jax_telemetry(tmp_path):
    jout, pout = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_retrieval.main(["--output_dir", jout] + TINY)
    port_retrieval.main(["--output_dir", pout] + TINY + LOADER)
    jlines, plines = log_lines(jout), log_lines(pout)
    assert [m["step"] for m in plines] == [m["step"] for m in jlines] == [1, 2]
    for p, j in zip(plines, jlines):
        want = keys_of(j)
        assert want >= TELEMETRY | JAX_CPU_MEMORY_KEYS
        assert keys_of(p) - PORT_STEP_KEYS == want - JAX_CPU_MEMORY_KEYS
        assert p["train/examples_per_sec"] == pytest.approx(
            8 * p["train/steps_per_sec"])
    with open(os.path.join(pout, "log.txt")) as f:
        log = f.read()
    assert "PROGRESS: 50.00%" in log and "PROGRESS: 100.00%" in log


@pytest.mark.budget(120)
def test_profile_window_on_a_resumed_run(tmp_path):
    """A run resumed past --profile_start still traces --profile_steps
    steps from where it resumed, once, into one trace file."""
    out = str(tmp_path / "run")
    # the last --max_steps on a command line wins
    base = ["--output_dir", out, "--ckpt_period", "3"] + TINY + LOADER
    port_retrieval.main(base + ["--max_steps", "3"])
    prof = str(tmp_path / "prof")
    hist = port_retrieval.main(base + [
        "--max_steps", "7", "--profile_dir", prof, "--profile_start", "1",
        "--profile_steps", "2"])["train"]
    assert len(hist) == 4
    events = trace_events(prof)
    assert len([e for e in events if e.get("name") == "train_step"
                 and e.get("cat") == "user_annotation"]) == 2
    with open(os.path.join(out, "log.txt")) as f:
        assert f"profiler trace of steps 4-5 -> {prof}" in f.read()


def test_profiler_hooks_on_the_cpu(tmp_path):
    timer = profiler.StepTimer()
    timer.mark("data")
    timer.mark("compute")
    timer.mark("data")
    got = timer.pop()
    assert sorted(got) == ["compute", "data"] and timer.pop() == {}
    assert profiler.device_memory_gb("cpu") == {}
    assert profiler.step_memory_gb(lambda: 5, "cpu", 10) == (5, {})
    assert profiler.tensor_bytes([torch.zeros(3), {"a": [torch.ones(2, 2,
                                 dtype=torch.float16)]}, 7]) == 12 + 8
    prof = str(tmp_path / "prof")
    with profiler.device_trace(prof):
        with profiler.annotate("region"):
            torch.ones(4).sum()
    assert [e["cat"] for e in trace_events(prof)
            if e.get("name") == "region"] == ["user_annotation"]


class _Linear(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(4, 3)
        self.config = None

    @property
    def device(self):
        return self.lin.weight.device


def _loss(model, batch, generator):
    out = model.lin(batch["x"])
    loss = (out ** 2).mean()
    return loss, {}


def test_async_snapshot_is_not_changed_by_the_next_step(tmp_path):
    torch.manual_seed(0)
    model = _Linear()
    opt = make_optimizer(model, 0.1, schedule="constant")
    trainer = Trainer(model, _loss, opt)
    batch = {"x": torch.randn(5, 4)}
    trainer.step(batch)
    assert trainer.step_memory == {}
    ckpt = CheckpointManager(str(tmp_path))
    want = {"w": {k: v.clone() for k, v in model.state_dict().items()},
            "mu": [m.clone() for m in opt.mu]}
    snap = ckpt.snapshot(1, model, opt)
    trainer.step(batch)         # changes the weights and moments in place
    assert not torch.equal(model.lin.weight, want["w"]["lin.weight"])
    assert_tensors_equal(snap["weights"], want["w"])
    assert all(torch.equal(snap["optimizer"]["mu"][n], m)
               for n, m in zip(opt.names, want["mu"]))
    d = ckpt.write(snap)
    assert_tensors_equal(torch.load(os.path.join(d, "pytorch_model.bin"),
                                    weights_only=True), want["w"])


def test_async_saver_orders_writes_and_reraises(tmp_path):
    import threading
    import time
    saver, order = AsyncSaver(), []
    release = threading.Event()

    def write(i, wait=None):
        def fn():
            if wait is not None:
                assert wait.wait(10)
            order.append(i)
        return fn
    saver.submit(write(0, release))
    release.set()
    saver.submit(write(1))      # joins write 0 first
    assert order[0] == 0
    saver.wait()
    assert order == [0, 1]

    def fail():
        time.sleep(0.05)
        raise OSError("disk full")
    saver.submit(fail)
    with pytest.raises(OSError, match="disk full"):
        saver.submit(write(2))
    assert order == [0, 1]      # the failed write's successor never ran
    saver.submit(fail)
    with pytest.raises(OSError, match="disk full"):
        saver.wait()
    saver.wait()                # the error is raised once

    # through CheckpointManager: the writes land in order, the pointer last
    torch.manual_seed(0)
    model = _Linear()
    ckpt = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        ckpt.save(step, model, saver=saver)
    saver.wait()
    assert ckpt.latest() == (3, os.path.join(str(tmp_path),
                                             "checkpoint-0000003"))
    assert sorted(d for d in os.listdir(tmp_path)
                  if d.startswith("checkpoint-")) == ["checkpoint-0000002",
                                                      "checkpoint-0000003"]


# ---------------------------------------------------------------------------
# the load-test client
# ---------------------------------------------------------------------------

@pytest.mark.budget(120)
def test_load_test_batched_and_unbatched_on_the_cpu(capsys):
    res = load_test_serve.main(["--device", "cpu", "--requests", "48",
                                "--threads", "8", "--batch_wait_ms", "20"])
    assert json.loads(capsys.readouterr().out) == res
    for mode in ("batched", "unbatched"):
        assert res[mode]["errors"] == 0 and res[mode]["requests"] == 48
        assert all(a is not None for a in res[mode]["answers"])
    assert res["batched"]["max_batch_seen"] > 1
    assert res["unbatched"]["max_batch_seen"] == 1
    assert res["unbatched"]["batches"] == 48
    assert res["batched"]["answers"] == res["unbatched"]["answers"]


def test_load_test_runs_on_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the client would run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        load_test_serve.main(["--requests", "1"])
