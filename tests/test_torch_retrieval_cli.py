"""The port's retrieval command line against the JAX package's, on the CPU.

The weights are seeded once with the JAX package and saved twice: as
`params.msgpack` for the JAX driver, and through `load_jax_params` and the
port's `CheckpointManager` as `pytorch_model.bin` for the port. Both drivers
then run `--synthetic --tiny --platform cpu` at dropouts 0 with `--do_train
--do_eval` for 4 steps: plain, and with `--use_phrase` and
`--cross_image_eval`. The hard-negative slot permutation and the WRA pick are
pinned on both sides (the two random streams never agree). Every step's
losses agree within 5e-4, and the coarse and fine R@K are equal.

The tooling flags that once raised as later port items (`--profile_dir`,
`--async_ckpt`) run; without `--platform cpu` the driver runs on CUDA and
raises where there is no card.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvp_pytorch_tpu.models import tasks as jax_tasks
from mvp_pytorch_tpu.tasks import retrieval as jax_retrieval
from mvp_pytorch_tpu.tasks.common import build_config as jax_build_config
from mvp_pytorch_tpu.data.tokenization import BertTokenizer as JaxTokenizer
from mvp_pytorch_tpu.data.synthetic import make_synthetic_root
from mvp_pytorch_tpu.training.checkpoint import save_pretrained
from mvp_pytorch_tpu_torch.convert import load_jax_params
from mvp_pytorch_tpu_torch.models import ModelConfig
from mvp_pytorch_tpu_torch.models import tasks as port_tasks
from mvp_pytorch_tpu_torch.tasks import retrieval as port_retrieval
from mvp_pytorch_tpu_torch.training.checkpoint import CheckpointManager
from torch_flags import TOOLING_FLAGS, check_tooling_flag

B, STEPS = 8, 4
LOSS_TOL = 5e-4
# a fixed slot permutation per batch size (the init batch is 2)
PERMS = {n: np.random.RandomState(n).permutation(n) for n in (2, B)}
COMMON = ["--synthetic", "--tiny", "--platform", "cpu",
          "--hidden_dropout_prob", "0", "--attention_dropout_prob", "0",
          "--do_train", "--do_eval", "--max_steps", str(STEPS),
          "--ckpt_period", str(STEPS), "--log_period", "1",
          "--train_batch_size", str(B), "--eval_batch_size", "16",
          "--dtype", "float32", "--learning_rate", "1e-3"]


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    """torch single-threaded in this process: no intra-op thread pool is left
    behind for a later test in the same worker that forks."""
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _bounded_loader(monkeypatch):
    """The drivers' loader workers must answer within 60 s, or the test
    fails instead of waiting."""
    from mvp_pytorch_tpu_torch.data.loader import ProcessLoader
    from mvp_pytorch_tpu_torch.tasks import common
    monkeypatch.setattr(common, "ProcessLoader",
                        functools.partial(ProcessLoader, timeout=60.0))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(JAX checkpoint dir, port checkpoint dir) of the same seeded tiny
    retrieval model."""
    base = tmp_path_factory.mktemp("weights")
    root = make_synthetic_root(str(base / "root"))
    args = jax_retrieval.get_args(["--output_dir", str(base)] + COMMON)
    cfg = jax_build_config(args, JaxTokenizer(root["vocab"]), num_labels=2)
    la, t, r = 40, 20, 50
    z = functools.partial(jnp.zeros, dtype=jnp.int32)
    o = functools.partial(jnp.ones, dtype=jnp.int32)
    keys = {k: jax.random.PRNGKey(i) for i, k in
            enumerate(("params", "hardneg", "dropout", "wra"), 7)}
    params = jax.jit(lambda: jax_tasks.RetrievalModel(cfg).init(
        keys, z((2, la)), o((2, la)), z((2, la)), z((2, t)), o((2, t + r)),
        o((2, t)), jnp.zeros((2, r, cfg.img_feature_dim)),
        max_tag_length=t, deterministic=True))()["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    jdir = str(base / "jax")
    save_pretrained(jdir, params, config=cfg)
    pcfg = ModelConfig.from_pretrained(jdir)
    model = port_tasks.RetrievalModel(pcfg, device="cpu")
    load_jax_params(model, params)
    pdir = CheckpointManager(str(base / "port")).save(0, model, config=pcfg)
    return jdir, pdir


@pytest.fixture
def pinned(monkeypatch):
    """Both drivers take the slot permutation PERMS[batch] and WRA slot 0."""
    class Pinned(jax_tasks.RetrievalModel):
        def __call__(self, *args, **kw):
            return self.train_step(
                *args, hn_dice=jnp.asarray(PERMS[args[0].shape[0]]), **kw)
    monkeypatch.setattr(jax_retrieval, "RetrievalModel", Pinned)
    monkeypatch.setattr(jax_tasks, "wra_hard_loss", functools.partial(
        jax_tasks.wra_hard_loss, pick=0))
    real = port_tasks.RetrievalModel.train_step

    def train_step(self, *args, **kw):
        return real(self, *args, wra_pick=0,
                    hn_dice=torch.from_numpy(PERMS[args[0].shape[0]]), **kw)
    monkeypatch.setattr(port_tasks.RetrievalModel, "train_step", train_step)


def read_metrics(out):
    with open(os.path.join(out, "train_logs", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


# the port's loader workers are spawned: this process holds JAX
SPAWN = ["--worker_start_method", "spawn", "--num_workers"]
CASES = {
    "plain": ([], SPAWN + ["2"]),
    "use_phrase_cross_image": (["--use_phrase", "--phrase_layer", "1",
                                "--cross_image_eval"], SPAWN + ["1"]),
}


@pytest.mark.budget(240)
@pytest.mark.parametrize("case", list(CASES))
def test_cli_matches_jax_driver(weights, pinned, tmp_path, case):
    extra, port_only = CASES[case]
    jdir, pdir = weights
    jout, pout = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_retrieval.main(["--output_dir", jout, "--model_name_or_path", jdir]
                       + COMMON + extra)
    res = port_retrieval.main(["--output_dir", pout, "--model_name_or_path",
                               pdir] + COMMON + extra + port_only)
    want, got = read_metrics(jout), read_metrics(pout)
    assert [m["step"] for m in got] == [m["step"] for m in want] == \
        list(range(1, STEPS + 1))
    names = ["loss", "clip", "itm"] + (["wra"] if extra[:1] == [
        "--use_phrase"] else [])
    for g, w in zip(got, want):
        for k in names:
            assert abs(g[f"train/{k}"] - w[f"train/{k}"]) <= LOSS_TOL, (
                g["step"], k, g[f"train/{k}"], w[f"train/{k}"])
    assert [m["loss"] for m in res["train"]] == [m["train/loss"] for m in got]
    with open(os.path.join(jout, "eval_logs.json")) as f:
        jeval = json.load(f)
    with open(os.path.join(pout, "eval_logs.json")) as f:
        peval = json.load(f)
    assert peval == jeval and len(peval) == 1
    assert set(peval[0]["fine"]) == {"i2t_retrieval", "t2i_retrieval"}
    if "--cross_image_eval" in extra:
        assert res["eval"]["n_pairs"] == 12 * 60       # every pair scored
    ckpt = os.path.join(pout, f"checkpoint-{STEPS:07d}")
    assert sorted(os.listdir(ckpt)) == ["config.json", "optimizer.pt",
                                        "pytorch_model.bin", "train_meta.json",
                                        "training_args.json", "vocab.txt"]


def test_eval_only_restores_training_settings_and_caption_index(
        weights, tmp_path):
    """--do_eval from a trained checkpoint restores its tensorization flags;
    an external caption shortlist is bounds-checked and ranks i2t only."""
    pdir = weights[1]
    out = str(tmp_path / "train")
    port_retrieval.main(["--output_dir", out, "--model_name_or_path", pdir,
                         "--max_seq_length", "20"] + SPAWN + ["1"]
                        + [a for a in COMMON if a != "--do_eval"])
    ckpt = os.path.join(out, f"checkpoint-{STEPS:07d}")
    synth = os.path.join(out, "synth")
    with open(os.path.join(synth, "captions.json")) as f:
        keys = sorted(json.load(f))
    index = {k: [[keys[(i + j) % len(keys)], j % 5] for j in range(7)]
             for i, k in enumerate(keys)}
    with open(tmp_path / "index.json", "w") as f:
        json.dump(index, f)
    import shutil
    shutil.copy(os.path.join(synth, "vocab.txt"), ckpt)
    data = ["--captions_json", os.path.join(synth, "captions.json"),
            "--feature_tsv", os.path.join(synth, "features",
                                          "predictions.tsv"),
            "--platform", "cpu", "--dtype", "float32",
            "--eval_batch_size", "16"]
    res = port_retrieval.main(
        ["--output_dir", str(tmp_path / "eval"), "--model_name_or_path", ckpt,
         "--do_eval", "--eval_caption_index_json",
         str(tmp_path / "index.json")] + data)["eval"]
    assert res["n_pairs"] == len(keys) * 7
    assert set(res["fine"]) == {"i2t_retrieval"}
    with open(tmp_path / "eval" / "test_eval.json") as f:
        assert json.load(f) == {k: res[k] for k in ("coarse", "fine")}
    with open(tmp_path / "eval" / "log.txt") as f:
        assert "restored train-time max_seq_length=20" in f.read()
    index[keys[0]][0] = [keys[-1], 9]      # past the last caption: n_cap + 4
    with open(tmp_path / "index.json", "w") as f:
        json.dump(index, f)
    with pytest.raises(ValueError, match="shortlist"):
        port_retrieval.main(
            ["--output_dir", str(tmp_path / "eval2"), "--model_name_or_path",
             ckpt, "--do_eval", "--eval_caption_index_json",
             str(tmp_path / "index.json")] + data)


@pytest.mark.parametrize("flag", TOOLING_FLAGS)
def test_flags_of_later_items_raise(tmp_path, flag):
    """The flags that raised until the tooling was ported now run: one
    trace, or an async checkpoint equal to the synchronous one."""
    check_tooling_flag(port_retrieval.main, flag, str(tmp_path),
                       ["--train_batch_size", str(B)])


def test_runs_on_cuda_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the driver would run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_retrieval.main(["--output_dir", str(tmp_path), "--synthetic",
                             "--tiny", "--do_train", "--max_steps", "1"])
    assert not os.path.exists(tmp_path / "synth")
