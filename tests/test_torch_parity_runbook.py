"""The port's parity runbook (`tools/parity_runbook.py`) against the JAX
package's (`tools_tpu/parity_runbook.py`), on the CPU.

- `flatten_metrics` and `compare_metrics` give the JAX functions' results
  (and print the same lines) on the same inputs;
- the end-to-end drill: a tiny port `RetrievalModel` saved in the
  reference's layout (`pytorch_model.bin`, `config.json`, `vocab.txt`), the
  runbook over `make_synthetic_root` data under `--platform cpu`: exit 0 and
  section-qualified metrics without `--expected`, 0 with its own metrics
  expected, 1 with one metric 30 points off. Each eval subprocess has its
  own timeout and one thread (`OMP_NUM_THREADS=1`). The runbook's forwarded
  flags are all the retrieval driver's (the JAX runbook's round-4 fault
  was a flag its driver did not take);
- across packages: one checkpoint exported from JAX params by
  `convert.export_state_dict` gives, through the port's runbook, the R@K
  that the JAX `tasks.retrieval --do_eval` gives on the same data. The R@K
  are required equal: a rank flip would be acceptable only between two
  scores that tie within the fused tolerance of 5e-4
  (`tests/test_golden_fixture.py`), and this seeded case has no such tie.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvp_pytorch_tpu.convert import export_state_dict
from mvp_pytorch_tpu.data.tokenization import BertTokenizer as JaxTokenizer
from mvp_pytorch_tpu.models import tasks as jax_tasks
from mvp_pytorch_tpu.tasks import retrieval as jax_retrieval
from mvp_pytorch_tpu.tasks.common import build_config as jax_build_config
from mvp_pytorch_tpu.training.checkpoint import save_pretrained
from mvp_pytorch_tpu_torch.data.synthetic import make_synthetic_root
from mvp_pytorch_tpu_torch.models import ModelConfig
from mvp_pytorch_tpu_torch.models.tasks import RetrievalModel
from mvp_pytorch_tpu_torch.tasks import retrieval as port_retrieval
from mvp_pytorch_tpu_torch.tools import parity_runbook as port_runbook
from tools_tpu import parity_runbook as jax_runbook

EVAL_TIMEOUT = 120          # seconds, each eval subprocess
EVAL = ["--platform", "cpu", "--dtype", "float32"]


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    """torch single-threaded in this process: no intra-op thread pool is left
    behind for a later test in the same worker that forks."""
    torch.set_num_threads(1)


RES = {"coarse": {"i2t_retrieval": {"R@1": 0.5, "R@5": 0.9, "R@10": 1.0},
                  "t2i_retrieval": {"R@1": 0.4, "R@5": 0.8, "R@10": 0.95}},
       "fine": {"i2t_retrieval": {"R@1": 0.7, "R@5": 0.95, "R@10": 1.0},
                "t2i_retrieval": {"R@1": 0.6, "R@5": 0.9, "R@10": 1.0}}}
FLATTEN_CASES = {
    "coarse_and_fine_coexist": RES,
    "scalar_leaves": {"coarse": {"i2t_retrieval": 0.3}, "n_pairs": 840,
                      "fine": {"t2i_retrieval": {"R@1": 0.2}}},
    "empty": {},
}
COMPARE_CASES = {
    "percent_scaling": ({"fine_i2t_retrieval_R@1": 0.773},
                        {"fine_i2t_retrieval_R@1": 77.3}, 0.5),
    "already_percent": ({"fine_i2t_retrieval_R@1": 77.3},
                        {"fine_i2t_retrieval_R@1": 77.3}, 0.5),
    "missing_key": ({"fine_i2t_retrieval_R@1": 0.773},
                    {"coarse_i2t_retrieval_R@1": 77.3}, 0.5),
    "tolerance_in": ({"fine_t2i_retrieval_R@5": 0.601},
                     {"fine_t2i_retrieval_R@5": 60.5}, 0.5),
    "tolerance_out": ({"fine_t2i_retrieval_R@5": 0.601},
                      {"fine_t2i_retrieval_R@5": 60.7}, 0.5),
    "mixed": (jax_runbook.flatten_metrics(RES),
              {"fine_i2t_retrieval_R@1": 70.0, "coarse_i2t_retrieval_R@1": 80.0,
               "fine_t2i_retrieval_R@10": 100.0, "nope_R@1": 1.0}, 0.5),
}


@pytest.mark.parametrize("res", list(FLATTEN_CASES))
def test_flatten_metrics_matches_jax(res):
    want = jax_runbook.flatten_metrics(FLATTEN_CASES[res])
    assert port_runbook.flatten_metrics(FLATTEN_CASES[res]) == want
    if res == "coarse_and_fine_coexist":
        assert want["coarse_i2t_retrieval_R@1"] == 0.5
        assert want["fine_i2t_retrieval_R@1"] == 0.7


@pytest.mark.parametrize("case", list(COMPARE_CASES))
def test_compare_metrics_matches_jax(case, capsys):
    flat, expected, tol = COMPARE_CASES[case]
    want = jax_runbook.compare_metrics(flat, expected, tol)
    want_out = capsys.readouterr().out
    assert port_runbook.compare_metrics(flat, expected, tol) == want
    assert capsys.readouterr().out == want_out
    assert bool(want) == (case in ("missing_key", "tolerance_out", "mixed"))


def test_forwarded_flags_are_the_drivers(tmp_path):
    """Every flag of the eval's command line parses in the retrieval
    driver's argparse."""
    args = port_runbook.get_args([
        "--reference_ckpt", "ck", "--feature_tsv", "f.tsv",
        "--captions_json", "c.json", "--id2phrase", "p.json",
        "--out", str(tmp_path),
        "--extra_eval_args", "--platform cpu --dtype float32 "
        "--max_seq_length 70"])
    cmd = port_runbook.eval_command(args)
    assert cmd[1:3] == ["-m", "mvp_pytorch_tpu_torch.tasks.retrieval"]
    parsed = port_retrieval.get_args(cmd[3:])
    assert (parsed.model_name_or_path, parsed.feature_tsv,
            parsed.captions_json, parsed.id2phrase, parsed.platform,
            parsed.dtype, parsed.max_seq_length, parsed.do_eval) == (
        "ck", "f.tsv", "c.json", "p.json", "cpu", "float32", 70, True)


def data_args(paths):
    return ["--feature_tsv", paths["features"],
            "--captions_json", paths["captions"],
            "--id2phrase", paths["id2phrase"], "--eval_batch_size", "8"]


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    """The runbook three times over one tiny port checkpoint: without
    --expected, with its own metrics, with one metric 30 points off.
    Returns [(exit code, test_eval.json)]."""
    base = tmp_path_factory.mktemp("drill")
    paths = make_synthetic_root(str(base / "synth"))
    n_words = len(open(paths["vocab"]).read().splitlines())
    cfg = ModelConfig(vocab_size=n_words + 20, only_word_size=n_words,
                      hidden_size=32, num_hidden_layers=4,
                      num_attention_heads=4, intermediate_size=37,
                      max_position_embeddings=128, img_feature_dim=2054)
    model = RetrievalModel(cfg, device="cpu", seed=3)
    ckpt = str(base / "reference_ckpt")
    cfg.save_pretrained(ckpt)
    torch.save(model.state_dict(), os.path.join(ckpt, "pytorch_model.bin"))
    with open(paths["vocab"]) as src, \
            open(os.path.join(ckpt, "vocab.txt"), "w") as dst:
        dst.write(src.read())
    argv = (["--reference_ckpt", ckpt] + data_args(paths)
            + ["--extra_eval_args", " ".join(EVAL)])
    runs = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        mp.delenv("PYTHONPATH", raising=False)
        for i in range(3):
            out = str(base / f"run{i}")
            extra = []
            if i:
                flat = port_runbook.flatten_metrics(runs[0][1])
                expected = {k: 100.0 * v for k, v in flat.items()}
                if i == 2:
                    expected["fine_t2i_retrieval_R@5"] += 30.0
                extra = ["--expected", json.dumps(expected)]
            rc = port_runbook.main(argv + ["--out", out] + extra,
                                   timeout=EVAL_TIMEOUT)
            with open(os.path.join(out, "eval", "test_eval.json")) as f:
                runs.append((rc, json.load(f)))
    return runs


def test_drill_reports_section_qualified_metrics(drill):
    rc, res = drill[0]
    assert rc == 0
    flat = port_runbook.flatten_metrics(res)
    assert sorted(flat) == sorted(
        f"{s}_{d}_retrieval_R@{k}" for s in ("coarse", "fine")
        for d in ("i2t", "t2i") for k in (1, 5, 10))
    assert all(0.0 <= v <= 1.0 for v in flat.values())


def test_drill_passes_its_own_metrics(drill):
    assert drill[1][0] == 0
    assert drill[1][1] == drill[0][1]


def test_drill_fails_a_metric_30_points_off(drill):
    assert drill[2][0] == 1


@pytest.fixture(scope="module")
def cross_package(tmp_path_factory):
    """(JAX test_eval.json, the port runbook's test_eval.json) of one
    seeded JAX model: its msgpack for the JAX driver, its
    `export_state_dict` in the reference layout for the port."""
    base = tmp_path_factory.mktemp("cross")
    paths = make_synthetic_root(str(base / "synth"))
    args = jax_retrieval.get_args(["--output_dir", str(base), "--tiny",
                                   "--synthetic"] + EVAL)
    cfg = jax_build_config(args, JaxTokenizer(paths["vocab"]), num_labels=2)
    la, t, r = 40, 20, 50
    z = functools.partial(jnp.zeros, dtype=jnp.int32)
    o = functools.partial(jnp.ones, dtype=jnp.int32)
    keys = {k: jax.random.PRNGKey(i) for i, k in
            enumerate(("params", "hardneg", "dropout", "wra"), 5)}
    params = jax.jit(lambda: jax_tasks.RetrievalModel(cfg).init(
        keys, z((2, la)), o((2, la)), z((2, la)), z((2, t)), o((2, t + r)),
        o((2, t)), jnp.zeros((2, r, cfg.img_feature_dim)),
        max_tag_length=t, deterministic=True))()["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    vocab = open(paths["vocab"]).read()
    jdir, tdir = str(base / "jax_ckpt"), str(base / "reference_ckpt")
    save_pretrained(jdir, params, config=cfg)
    save_pretrained(tdir, params, config=cfg)
    os.remove(os.path.join(tdir, "params.msgpack"))
    torch.save({k: torch.from_numpy(np.array(v))
                for k, v in export_state_dict(params).items()},
               os.path.join(tdir, "pytorch_model.bin"))
    for d in (jdir, tdir):
        with open(os.path.join(d, "vocab.txt"), "w") as f:
            f.write(vocab)
    jout = str(base / "jax_eval")
    os.makedirs(jout)       # the JAX driver's logger makes it only once
    jax_retrieval.main(["--output_dir", jout, "--model_name_or_path", jdir,
                        "--do_eval"] + data_args(paths) + EVAL)
    pout = str(base / "port_run")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        mp.delenv("PYTHONPATH", raising=False)
        rc = port_runbook.main(["--reference_ckpt", tdir, "--out", pout]
                               + data_args(paths)
                               + ["--extra_eval_args", " ".join(EVAL)],
                               timeout=EVAL_TIMEOUT)
    assert rc == 0
    with open(os.path.join(jout, "test_eval.json")) as f:
        want = json.load(f)
    with open(os.path.join(pout, "eval", "test_eval.json")) as f:
        got = json.load(f)
    return want, got


def test_exported_checkpoint_gives_the_jax_drivers_recall(cross_package):
    want, got = cross_package
    assert port_runbook.flatten_metrics(got) == \
        jax_runbook.flatten_metrics(want)
