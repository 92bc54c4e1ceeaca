"""The port's pretraining command line against the JAX package's, on the CPU.

The tiny pretraining weights are seeded once with the JAX package (with the
QA head and the QA-pair relation head) and saved for both drivers, for each
case with the heads its model has: as `params.msgpack` for the JAX driver,
and through `load_jax_params` and the port's `CheckpointManager` as
`pytorch_model.bin` for the port. Both drivers then run `--synthetic --tiny
--platform cpu --dtype float32` at dropouts 0 for 4 steps: default (with
`--mlm_debug`), `--use_qa`, `--use_qa_pairs` and `--dataset_yaml` (two
corpora and a `fk_test_id` list). The hard-negative slot permutation, the
WRA pick and the WRA negative are pinned on both sides (the two random
streams never agree). Every step's total, `vis_mlm`, `clip`, `mlm`, `itm`,
`wra` (and `qa`) agree within 5e-4; the `--mlm_debug` dumps hold the same
labels, weights and predictions.

Also: 2 steps and a rerun to 4 equal an uninterrupted 4; the tooling flags
(`--profile_dir`, `--async_ckpt`) run; without `--platform cpu` the driver
runs on CUDA and raises where there is no card. The port's loader workers
start from a fork server: this process holds JAX.
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvp_pytorch_tpu.data.synthetic import make_synthetic_root
from mvp_pytorch_tpu.data.tokenization import BertTokenizer as JaxTokenizer
from mvp_pytorch_tpu.models import pretrain as jax_models
from mvp_pytorch_tpu.tasks import pretrain as jax_pretrain
from mvp_pytorch_tpu.tasks.common import build_config as jax_build_config
from mvp_pytorch_tpu.training.checkpoint import save_pretrained
from mvp_pytorch_tpu_torch.convert import load_jax_params
from mvp_pytorch_tpu_torch.models import BiPretrainModel, ModelConfig
from mvp_pytorch_tpu_torch.tasks import pretrain as port_pretrain
from mvp_pytorch_tpu_torch.tasks.common import LATER_ITEMS
from mvp_pytorch_tpu_torch.training.checkpoint import CheckpointManager
from torch_flags import (TOOLING_FLAGS, WORKERS, bounded_loader,
                         check_tooling_flag, tooling_runs)

B, STEPS = 8, 4
LOSS_TOL = 5e-4
# a fixed slot permutation per batch size
PERMS = {n: np.random.RandomState(n).permutation(n) for n in (2, B)}
WRA_PICK, NEG_OFFSET = 0, 1
COMMON = ["--synthetic", "--tiny", "--platform", "cpu",
          "--hidden_dropout_prob", "0", "--attention_dropout_prob", "0",
          "--max_steps", str(STEPS), "--ckpt_period", str(STEPS),
          "--log_period", "1", "--train_batch_size", str(B),
          "--dtype", "float32", "--learning_rate", "1e-3"]
LOADER = WORKERS + ["2"]
# case -> (flags of both drivers, (qa_head, qa_seq_relation) in the weights)
CASES = {
    "default": (["--mlm_debug"], (False, False)),
    "use_qa": (["--use_qa"], (True, False)),
    "use_qa_pairs": (["--use_qa_pairs"], (False, True)),
    "dataset_yaml": (["--dataset_yaml", "YAML"], (False, False)),
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
    """{case: (JAX checkpoint dir, port checkpoint dir)} of one seeded tiny
    pretraining model, and the root the YAML manifest points at."""
    base = tmp_path_factory.mktemp("pretrain_weights")
    root = make_synthetic_root(str(base / "root"))
    args = jax_pretrain.get_args(["--output_dir", str(base)] + COMMON)
    cfg = jax_build_config(args, JaxTokenizer(root["vocab"]),
                           qa_answer_size=7)
    la, t, r = 40, 20, 50
    z = functools.partial(jnp.zeros, dtype=jnp.int32)
    o = functools.partial(jnp.ones, dtype=jnp.int32)
    lab = jnp.full((2, la), -1, jnp.int32)
    keys = {k: jax.random.PRNGKey(i) for i, k in
            enumerate(("params", "hardneg", "dropout", "wra"), 7)}
    params = jax.jit(lambda: jax_models.BiPretrainModel(cfg).init(
        keys, z((2, la)), o((2, la)), z((2, la)), lab, z((2, t)),
        o((2, t + r)), o((2, t)), jnp.full((2, t + r), -1, jnp.int32),
        jnp.zeros((2, r, cfg.img_feature_dim)),
        jnp.asarray([[1, 3], [1, 2]]), jnp.asarray([[la, la + r]] * 2),
        z((2,)), z((2,)), max_tag_length=t, deterministic=True))()["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    out = {}
    for case, (_, (qa_head, qa_pairs)) in CASES.items():
        tree = {k: v for k, v in params.items()
                if (k != "qa_head" or qa_head)
                and (k != "qa_seq_relation" or qa_pairs)}
        ccfg = dataclasses.replace(cfg, qa_answer_size=7 if qa_head else 0)
        jdir = str(base / case / "jax")
        save_pretrained(jdir, tree, config=ccfg)
        pcfg = ModelConfig.from_pretrained(jdir)
        model = BiPretrainModel(pcfg, qa_pairs=qa_pairs, device="cpu")
        load_jax_params(model, tree)
        pdir = CheckpointManager(str(base / case / "port")).save(
            0, model, config=pcfg)
        out[case] = (jdir, pdir)
    # two corpora (the corpus twice), the fk-test-style exclusion list
    yaml_path = str(base / "corpora.yaml")
    import yaml
    with open(yaml_path, "w") as f:
        yaml.safe_dump({
            "corpora": [{"name": n, "corpus_tsv": root["corpus"],
                         "feature_tsv": root["features"]}
                        for n in ("coco", "cc")],
            "id2phrase": root["id2phrase"], "tag2id": root["tag2id"],
            "phrase_vocab_size": cfg.vocab_size - cfg.only_word_size,
            "fk_test_id": root["exclude_ids"]}, f)
    return out, yaml_path


@pytest.fixture
def pinned(monkeypatch):
    """Both drivers take the slot permutation PERMS[batch], WRA slot
    WRA_PICK and the WRA negative NEG_OFFSET ahead."""
    def batch_size(args, kw):
        return (args[0] if args else kw["input_ids_a"]).shape[0]

    class Pinned(jax_models.BiPretrainModel):
        def __call__(self, *args, **kw):
            return super().__call__(
                *args, hn_dice=jnp.asarray(PERMS[batch_size(args, kw)]), **kw)
    monkeypatch.setattr(jax_pretrain, "BiPretrainModel", Pinned)
    monkeypatch.setattr(jax_models, "wra_sample_loss", functools.partial(
        jax_models.wra_sample_loss, pick=WRA_PICK, neg_offset=NEG_OFFSET))
    monkeypatch.setattr(jax_models, "wra_hard_loss", functools.partial(
        jax_models.wra_hard_loss, pick=WRA_PICK))
    real = BiPretrainModel.train_step

    def train_step(self, *args, **kw):
        kw.update(wra_pick=WRA_PICK, wra_neg_offset=NEG_OFFSET,
                  hn_dice=torch.from_numpy(PERMS[batch_size(args, kw)]))
        return real(self, *args, **kw)
    monkeypatch.setattr(BiPretrainModel, "train_step", train_step)


def read_metrics(out):
    with open(os.path.join(out, "train_logs", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.budget(240)
@pytest.mark.parametrize("case", list(CASES))
def test_cli_matches_jax_driver(weights, pinned, tmp_path, case):
    dirs, yaml_path = weights
    jdir, pdir = dirs[case]
    extra = [yaml_path if a == "YAML" else a for a in CASES[case][0]]
    jout, pout = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_pretrain.main(["--output_dir", jout, "--model_name_or_path", jdir]
                      + COMMON + extra)
    res = port_pretrain.main(["--output_dir", pout, "--model_name_or_path",
                              pdir] + COMMON + extra + LOADER)
    want, got = read_metrics(jout), read_metrics(pout)
    assert [m["step"] for m in got] == [m["step"] for m in want] == \
        list(range(1, STEPS + 1))
    names = ["loss", "vis_mlm", "clip", "mlm", "itm", "wra"]
    if case in ("use_qa", "use_qa_pairs"):
        names.append("qa")
    for g, w in zip(got, want):
        assert {k for k in g if k.startswith("train/")} >= {
            f"train/{k}" for k in names}
        for k in names:
            assert abs(g[f"train/{k}"] - w[f"train/{k}"]) <= LOSS_TOL, (
                g["step"], k, g[f"train/{k}"], w[f"train/{k}"])
    assert [m["loss"] for m in res["train"]] == [m["train/loss"] for m in got]
    assert os.path.exists(os.path.join(pout, "vocab.txt"))
    with open(os.path.join(pout, "log.txt")) as f:
        log = f.read()
    n = 50 * 2 if case == "dataset_yaml" else 60
    assert f"corpus: {n} examples" in log
    if case == "default":
        jdump = dict(np.load(os.path.join(jout, "mlm_res.npz")))
        pdump = dict(np.load(res["mlm_debug"]))
        assert sorted(pdump) == sorted(jdump)
        for k in jdump:
            assert pdump[k].dtype == jdump[k].dtype, k
            np.testing.assert_array_equal(pdump[k], jdump[k], err_msg=k)
        assert jdump["mlm_weights"].sum() > 0
        assert "mlm_debug sample 0 tokens_a" in log
        assert "masked-token top-1 acc" in log


def test_resume_equals_an_uninterrupted_run(weights, pinned, tmp_path):
    pdir = weights[0]["default"][1]
    flags = (["--model_name_or_path", pdir, "--scheduler", "constant",
              "--ckpt_period", "2"] + COMMON[:COMMON.index("--ckpt_period")]
             + COMMON[COMMON.index("--ckpt_period") + 2:] + LOADER)
    whole = port_pretrain.main(["--output_dir", str(tmp_path / "a")]
                               + flags)["train"]
    out = str(tmp_path / "b")
    first = port_pretrain.main(["--output_dir", out] + flags
                               + ["--max_steps", "2"])["train"]
    rest = port_pretrain.main(["--output_dir", out] + flags)["train"]
    assert len(whole) == 4 and len(first) == 2 and len(rest) == 2
    for g, w in zip(first + rest, whole):
        for k in ("loss", "vis_mlm", "clip", "mlm", "itm", "wra"):
            assert abs(g[k] - w[k]) <= 1e-6, (k, g[k], w[k])
    assert "resumed from" in open(os.path.join(out, "log.txt")).read()


@pytest.fixture(scope="module")
def tooling(tmp_path_factory):
    return tooling_runs(port_pretrain.main,
                        str(tmp_path_factory.mktemp("tooling")),
                        ["--train_batch_size", "8"])


@pytest.mark.parametrize("flag", TOOLING_FLAGS)
def test_tooling_flags_run(tooling, flag):
    """One trace, or an async checkpoint equal to the synchronous one; no
    flag is left for a later item."""
    assert not port_pretrain.LATER_ITEMS and not LATER_ITEMS
    check_tooling_flag(tooling, flag)


def test_runs_on_cuda_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the driver would run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_pretrain.main(["--output_dir", str(tmp_path), "--synthetic",
                            "--tiny", "--max_steps", "1"])
    assert not os.path.exists(tmp_path / "synth")
