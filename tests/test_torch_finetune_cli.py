"""The port's VQA, SNLI-VE and referring-expression command lines against
the JAX package's, on the CPU.

Each model's tiny weights are seeded once with the JAX package and saved
twice: as `params.msgpack` for the JAX driver, and through
`load_jax_params` and the port's `CheckpointManager` as `pytorch_model.bin`
for the port. Both drivers then run `--synthetic --tiny --platform cpu
--dtype float32` at dropouts 0 with `--do_train --do_eval` for 4 steps:
- VQA: plain (with `--test_jsonl`), `--use_single`, `--use_cls`, and
  `--loss_type kl --adjust_loss_step 2`;
- SNLI-VE: `--mask_training --freeze_steps 2`;
- RE: `--loss_mod 1 --phrase_layer 0 --det_json` (the tiny model's fusion
  encoder has 2 layers, so the mid-layer readout is at layer 0), and
  `--loss_mod 3`.
Every step's loss (and VE's `acc`) agrees within 5e-4, the eval metrics in
`eval_logs.json` are equal, and so is VQA's `{split}_results.json`.

Also: an eval-only rerun from a checkpoint restores its training settings;
each driver runs on CUDA unless asked for the CPU; the tooling flags
(`--profile_dir`, `--async_ckpt`) run. The port's loader workers start from
a fork server: this process holds JAX.
"""

import functools
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvp_pytorch_tpu.data.synthetic import make_synthetic_root
from mvp_pytorch_tpu.data.tokenization import BertTokenizer as JaxTokenizer
from mvp_pytorch_tpu.models import tasks as jax_tasks
from mvp_pytorch_tpu.tasks import re_task as jax_re
from mvp_pytorch_tpu.tasks import ve as jax_ve
from mvp_pytorch_tpu.tasks import vqa as jax_vqa
from mvp_pytorch_tpu.tasks.common import build_config as jax_build_config
from mvp_pytorch_tpu.training.checkpoint import save_pretrained
from mvp_pytorch_tpu_torch.convert import load_jax_params
from mvp_pytorch_tpu_torch.models import ModelConfig
from mvp_pytorch_tpu_torch.models import tasks as port_tasks
from mvp_pytorch_tpu_torch.tasks import re_task as port_re
from mvp_pytorch_tpu_torch.tasks import ve as port_ve
from mvp_pytorch_tpu_torch.tasks import vqa as port_vqa
from mvp_pytorch_tpu_torch.training.checkpoint import CheckpointManager
from torch_flags import (TOOLING_FLAGS, WORKERS, bounded_loader,
                         check_tooling_flag, tooling_runs)

B, STEPS = 8, 4
LOSS_TOL = 5e-4
COMMON = ["--synthetic", "--tiny", "--platform", "cpu",
          "--hidden_dropout_prob", "0", "--attention_dropout_prob", "0",
          "--do_train", "--do_eval", "--max_steps", str(STEPS),
          "--ckpt_period", str(STEPS), "--log_period", "1",
          "--train_batch_size", str(B), "--eval_batch_size", "16",
          "--dtype", "float32", "--learning_rate", "1e-3"]
LOADER = WORKERS + ["1"]
DRIVERS = {"vqa": (jax_vqa, port_vqa), "ve": (jax_ve, port_ve),
           "re_task": (jax_re, port_re)}
# weights -> (driver, model, build_config keywords)
WEIGHTS = {
    "vqa": ("vqa", "VQAModel", {}),
    "vqa_single": ("vqa", "ClassificationPlusModel", {}),
    "vqa_cls": ("vqa", "ClassificationModel", {}),
    "ve": ("ve", "ClassificationModel", dict(num_labels=3)),
    "re": ("re_task", "REModel", dict(num_labels=1)),
}
# case -> (weights, flags of both drivers, metric names in metrics.jsonl)
CASES = {
    "vqa": ("vqa", ["--test_jsonl", "TEST"], ["loss"]),
    "vqa_use_single": ("vqa_single", ["--use_single"], ["loss"]),
    "vqa_use_cls": ("vqa_cls", ["--use_cls"], ["loss"]),
    "vqa_kl_adjust_loss": ("vqa", ["--loss_type", "kl",
                                   "--adjust_loss_step", "2"], ["loss"]),
    "ve_mask_freeze": ("ve", ["--mask_training", "--freeze_steps", "2"],
                       ["loss", "acc"]),
    "re_mod1_phrase_det": ("re", ["--loss_mod", "1", "--phrase_layer", "0",
                                  "--det_json", "DETS"], ["loss"]),
    "re_mod3": ("re", ["--loss_mod", "3"], ["loss"]),
}


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    """torch single-threaded in this process: no intra-op thread pool is left
    behind for a later test in the same worker that forks."""
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _bounded_loader():
    with bounded_loader():
        yield


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """{weights: (JAX checkpoint dir, port checkpoint dir)} of seeded tiny
    task models."""
    base = tmp_path_factory.mktemp("finetune_weights")
    root = make_synthetic_root(str(base / "root"))
    tokenizer = JaxTokenizer(root["vocab"])
    with open(root["label2ans"]) as f:
        n_ans = len(json.load(f))
    la, t, r = 40, 20, 50
    z = functools.partial(jnp.zeros, dtype=jnp.int32)
    o = functools.partial(jnp.ones, dtype=jnp.int32)
    out = {}
    for name, (driver, model_name, over) in WEIGHTS.items():
        args = DRIVERS[driver][0].get_args(["--output_dir", str(base)]
                                           + COMMON)
        cfg = jax_build_config(args, tokenizer,
                               **(over or dict(num_labels=n_ans,
                                               loss_type="bce")))
        kw = (dict(labels=jnp.zeros((2, r)), mod=3)
              if model_name == "REModel" else {})
        params = jax.jit(lambda: getattr(jax_tasks, model_name)(cfg).init(
            jax.random.PRNGKey(7), z((2, la)), o((2, la)), z((2, la)),
            z((2, t)), o((2, t + r)), o((2, t)),
            jnp.zeros((2, r, cfg.img_feature_dim)), max_tag_length=t,
            **kw))()["params"]
        params = jax.tree_util.tree_map(np.asarray, params)
        jdir = str(base / name / "jax")
        save_pretrained(jdir, params, config=cfg)
        pcfg = ModelConfig.from_pretrained(jdir)
        model = getattr(port_tasks, model_name)(pcfg, device="cpu")
        load_jax_params(model, params)
        out[name] = (jdir, CheckpointManager(str(base / name / "port")).save(
            0, model, config=pcfg))
    return out


def read_metrics(out):
    with open(os.path.join(out, "train_logs", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def read_json(*path):
    with open(os.path.join(*path)) as f:
        return json.load(f)


def with_paths(flags, out):
    """TEST -> the driver's own synthetic vqa.jsonl; DETS -> any path (a
    synthetic run takes the root's detections)."""
    return [os.path.join(out, "synth", "vqa.jsonl") if a == "TEST"
            else "synthetic" if a == "DETS" else a for a in flags]


@pytest.mark.budget(240)
@pytest.mark.parametrize("case", list(CASES))
def test_cli_matches_jax_driver(weights, tmp_path, case):
    wname, extra, names = CASES[case]
    jax_main, port_main = (m.main for m in DRIVERS[WEIGHTS[wname][0]])
    jdir, pdir = weights[wname]
    jout, pout = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_main(["--output_dir", jout, "--model_name_or_path", jdir] + COMMON
             + with_paths(extra, jout))
    res = port_main(["--output_dir", pout, "--model_name_or_path", pdir]
                    + COMMON + with_paths(extra, pout) + LOADER)
    want, got = read_metrics(jout), read_metrics(pout)
    assert [m["step"] for m in got] == [m["step"] for m in want] == \
        list(range(1, STEPS + 1))
    for g, w in zip(got, want):
        for k in names:
            assert abs(g[f"train/{k}"] - w[f"train/{k}"]) <= LOSS_TOL, (
                g["step"], k, g[f"train/{k}"], w[f"train/{k}"])
    assert [m["loss"] for m in res["train"]] == [m["train/loss"] for m in got]
    peval, jeval = (read_json(d, "eval_logs.json") for d in (pout, jout))
    assert peval == jeval and len(peval) == 1
    if case.startswith("re_mod1"):
        assert set(peval[0]) == {"step", "re_accuracy", "re_accuracy_det1",
                                 "re_accuracy_det2"}
    if "--test_jsonl" in extra:
        presults = read_json(pout, "vqa_results.json")
        assert presults == read_json(jout, "vqa_results.json")
        assert len(presults) == len(res["test"]["logits"]) > 0
    ckpt = os.path.join(pout, f"checkpoint-{STEPS:07d}")
    assert sorted(os.listdir(ckpt)) == ["config.json", "optimizer.pt",
                                        "pytorch_model.bin", "train_meta.json",
                                        "training_args.json", "vocab.txt"]


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_eval_only_restores_training_settings(weights, tmp_path, driver):
    """--do_eval from a trained checkpoint restores its tensorization flags
    and evaluates to the metric the training run logged."""
    port_main = DRIVERS[driver][1].main
    wname = {"vqa": "vqa", "ve": "ve", "re_task": "re"}[driver]
    out = str(tmp_path / "train")
    port_main(["--output_dir", out, "--model_name_or_path",
               weights[wname][1], "--max_seq_length", "20"] + COMMON + LOADER)
    ckpt = os.path.join(out, f"checkpoint-{STEPS:07d}")
    shutil.copy(os.path.join(out, "synth", "vocab.txt"), ckpt)
    flags = ["--output_dir", str(tmp_path / "eval"), "--model_name_or_path",
             ckpt, "--do_eval", "--synthetic", "--platform", "cpu",
             "--dtype", "float32", "--eval_batch_size", "16"]
    res = port_main(flags)
    with open(tmp_path / "eval" / "log.txt") as f:
        assert "restored train-time max_seq_length=20" in f.read()
    logged = read_json(out, "eval_logs.json")[0]
    for k, v in logged.items():
        if k != "step":
            assert res["eval"][k] == v, k


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_runs_on_cuda_unless_asked_for_the_cpu(tmp_path, driver):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the driver would run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        DRIVERS[driver][1].main(["--output_dir", str(tmp_path), "--synthetic",
                                 "--tiny", "--do_train", "--max_steps", "1"])
    assert not os.path.exists(tmp_path / "synth")


@pytest.fixture(scope="module")
def tooling(tmp_path_factory):
    """{driver: its tooling_runs}"""
    return {d: tooling_runs(port.main, str(tmp_path_factory.mktemp(d)),
                            ["--train_batch_size", str(B)])
            for d, (_, port) in DRIVERS.items()}


@pytest.mark.parametrize("driver,flag",
                         [(d, f) for d in DRIVERS for f in TOOLING_FLAGS])
def test_tooling_flags_run(tooling, driver, flag):
    """One trace, or an async checkpoint equal to the synchronous one."""
    check_tooling_flag(tooling[driver], flag)


def test_vqa_flag_checks(tmp_path):
    """--use_single and --use_cls exclude each other; --adjust_loss_step
    needs --loss_type kl."""
    base = ["--output_dir", str(tmp_path), "--synthetic", "--tiny",
            "--platform", "cpu", "--do_train", "--max_steps", "1",
            "--num_workers", "1", "--worker_start_method", "spawn"]
    with pytest.raises(ValueError, match="mutually exclusive"):
        port_vqa.main(base + ["--use_single", "--use_cls"])
    with pytest.raises(ValueError, match="loss_type kl"):
        port_vqa.main(base + ["--adjust_loss_step", "2"])
