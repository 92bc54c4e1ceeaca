"""The port's NLVR2 slice against the JAX package's, on the CPU:
`BiEncoder.forward_joint`, `NLVRModel`, `NLVRDataset`, the two-image
`TaskFetch` / `predict` and `python -m mvp_pytorch_tpu_torch.tasks.nlvr`.

Models (tiny config: hidden 32, 2+2+2 layers, dropouts 0; JAX init plus
seeded noise, loaded with `load_jax_params(strict=True)`), at two shapes:
`small` (B 4, LA 10, T 5, R 4) and `lk140` (B 4, LA 40, T 20, R 50: the
drivers' geometry, whose fused sequence is 40 + 50 + 50 = 140 keys, past the
card kernel's 128-key tile), captions and both images padded:
- fp32 logits and loss within 1e-5 of the JAX model's, `forward_joint`'s
  fused sequence and pooled output within 5e-4 (the golden fixture's fused
  tolerance), and every parameter's gradient within 1e-3 relative (plus 1e-6
  absolute) of `jax.grad`'s;
- bf16 compute over the same weights, against the JAX bf16 model: the
  logits within 4 bf16 ulps at the largest |logit| (`chip_smoke.py` phase
  9's rule), the loss within twice their largest gap (the 2-class cross
  entropy moves at most 2 max|logit change|; phase 9's relative loss bound,
  1e-4, was set for a VQA loss of 2,308 and sits below one ulp of these
  logits at a loss of 0.7);
- at `lk140` every fusion layer's attention sees 140 keys.

Data: `NLVRDataset` batches equal to the JAX dataset's, array for array;
`TaskFetch` with the NLVR names and `predict` over a padded last chunk.

The CLI: JAX-seeded tiny weights saved for both drivers; both run `--synthetic
--tiny --platform cpu --dtype float32` at dropouts 0: every step's loss and
`acc` within 5e-4 of the JAX driver's, equal `nlvr_accuracy`; step 1's loss
equal to the same batch's loss in memory, and the eval accuracy equal to the
checkpoint's forward over the eval split. Also: the driver runs on CUDA
unless asked for the CPU, and the flags of later port items raise.
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

from mvp_pytorch_tpu.data.datasets import FeatureStore as JaxFeatureStore
from mvp_pytorch_tpu.data.synthetic import make_synthetic_root
from mvp_pytorch_tpu.data.tensorize import TensorizeConfig as JaxTCfg
from mvp_pytorch_tpu.data.tokenization import BertTokenizer as JaxTokenizer
from mvp_pytorch_tpu.models import tiny_config as jax_tiny_config
from mvp_pytorch_tpu.models import tasks as jt
from mvp_pytorch_tpu.tasks import nlvr as jax_nlvr
from mvp_pytorch_tpu.tasks.common import build_config as jax_build_config
from mvp_pytorch_tpu.training.checkpoint import save_pretrained
from mvp_pytorch_tpu_torch.convert import (jax_params_to_state_dict,
                                           load_jax_params)
from mvp_pytorch_tpu_torch.data.datasets import FeatureStore
from mvp_pytorch_tpu_torch.data.loader import BatchSampler
from mvp_pytorch_tpu_torch.data.tensorize import TensorizeConfig
from mvp_pytorch_tpu_torch.data.tokenization import FastBertTokenizer
from mvp_pytorch_tpu_torch.models import ModelConfig, NLVRModel
from mvp_pytorch_tpu_torch.models import layers as port_layers
from mvp_pytorch_tpu_torch.tasks import nlvr as port_nlvr
from mvp_pytorch_tpu_torch.tasks.common import (LATER_ITEMS,
                                                NLVR_INPUT_NAMES,
                                                NLVR_MODEL_KEYS, TaskFetch,
                                                predict)
from mvp_pytorch_tpu_torch.training.checkpoint import CheckpointManager
from mvp_pytorch_tpu_torch.training.loop import batch_on

SHAPES = {"small": (4, 10, 5, 4), "lk140": (4, 40, 20, 50)}
LOGIT_TOL, LOSS_TOL, FUSED_TOL = 1e-5, 1e-5, 5e-4
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-6
BF16_LOGIT_ULPS = 4
CLI_TOL = 5e-4


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    """torch single-threaded in this process: no intra-op thread pool is left
    behind for a later test in the same worker that forks."""
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _bounded_loader(monkeypatch):
    """The driver's loader workers must answer within 60 s, or the test
    fails instead of waiting."""
    from mvp_pytorch_tpu_torch.data.loader import ProcessLoader
    from mvp_pytorch_tpu_torch.tasks import common
    monkeypatch.setattr(common, "ProcessLoader",
                        functools.partial(ProcessLoader, timeout=60.0))


def make_inputs(cfg, b, la, t, r, seed=0):
    """The eleven inputs (text, image, second image) with padded captions
    and regions on both sides, and labels."""
    rs = np.random.RandomState(seed)
    mask_a = np.ones((b, la), np.int32)
    mask_a[1::2, la - 3:] = 0

    def side():
        mask_b = np.ones((b, t + r), np.int32)
        mask_b[rs.randint(b), t + r - max(1, r // 3):] = 0
        return (rs.randint(1, cfg.only_word_size, (b, t)).astype(np.int32),
                mask_b, np.ones((b, t), np.int32),
                rs.randn(b, r, cfg.img_feature_dim).astype(np.float32))
    inputs = (rs.randint(1, cfg.vocab_size, (b, la)).astype(np.int32),
              mask_a, np.zeros((b, la), np.int32)) + side() + side()
    return inputs, np.array([0, 1, 1, 0][:b], np.int32)


def bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


@pytest.fixture(scope="module")
def results():
    """shape -> the JAX results, the params and the port's fp32 and bf16
    models loaded from them."""
    cfg = jax_tiny_config()
    model = jt.NLVRModel(cfg)
    model16 = jt.NLVRModel(dataclasses.replace(cfg, dtype="bfloat16"))
    out = {}
    for shape, (b, la, t, r) in SHAPES.items():
        inputs, labels = make_inputs(cfg, b, la, t, r)
        x = tuple(map(jnp.asarray, inputs))
        params = jax.jit(lambda: model.init(
            jax.random.PRNGKey(5), *x, max_tag_length=t))()["params"]
        rs = np.random.RandomState(12)
        params = jax.tree_util.tree_map(
            lambda v: (np.asarray(v) + 0.05 * rs.randn(*v.shape)).astype(
                np.float32), params)

        def loss(p):
            return model.apply({"params": p}, *x, labels=jnp.asarray(labels),
                               max_tag_length=t)
        (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(params)
        joint = jax.jit(lambda p: model.apply(
            {"params": p}, *x[:11], max_tag_length=t,
            method=lambda m, *a, **k: m.bert.forward_joint(*a, **k)))(params)
        jloss16, jlogits16 = jax.jit(lambda p: model16.apply(
            {"params": p}, *x, labels=jnp.asarray(labels),
            max_tag_length=t))(params)
        models = {}
        for dt in ("float32", "bfloat16"):
            pcfg = ModelConfig.from_dict(dataclasses.asdict(cfg), dtype=dt)
            models[dt] = load_jax_params(NLVRModel(pcfg, device="cpu"),
                                         params)
        out[shape] = dict(
            t=t, inputs=inputs, labels=labels, loss=float(jloss),
            logits=np.asarray(jlogits),
            grads=jax_params_to_state_dict(
                jax.tree_util.tree_map(np.asarray, jgrads)),
            joint=[np.asarray(a) for a in joint], loss16=float(jloss16),
            logits16=np.asarray(jlogits16, np.float32), models=models)
    return out


def port_forward(res, dt, labels=True):
    x = [torch.from_numpy(a) for a in res["inputs"]]
    kw = dict(max_tag_length=res["t"])
    if labels:
        kw["labels"] = torch.from_numpy(res["labels"])
    return res["models"][dt](*x, **kw)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_fp32_logits_and_loss_match_jax(results, shape):
    res = results[shape]
    with torch.no_grad():
        loss, logits = port_forward(res, "float32")
        bare = port_forward(res, "float32", labels=False)
    np.testing.assert_allclose(logits.numpy(), res["logits"], atol=LOGIT_TOL,
                               rtol=0)
    np.testing.assert_array_equal(bare.numpy(), logits.numpy())
    assert abs(loss.item() - res["loss"]) <= LOSS_TOL, (loss.item(),
                                                        res["loss"])
    assert np.abs(res["logits"]).max() > 0.05     # the head is exercised


@pytest.mark.parametrize("shape", list(SHAPES))
def test_forward_joint_matches_jax(results, shape):
    res = results[shape]
    b, la, t, r = SHAPES[shape]
    x = [torch.from_numpy(a) for a in res["inputs"]]
    with torch.no_grad():
        seq, pooled = res["models"]["float32"].bert.forward_joint(
            *x, max_tag_length=t)
    assert seq.shape == (b, la + 2 * r, 32)
    np.testing.assert_allclose(seq.numpy(), res["joint"][0], atol=FUSED_TOL,
                               rtol=0)
    np.testing.assert_allclose(pooled.numpy(), res["joint"][1],
                               atol=FUSED_TOL, rtol=0)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_fp32_gradients_match_jax_grad(results, shape):
    res = results[shape]
    model = res["models"]["float32"]
    model.zero_grad(set_to_none=True)
    loss, _ = port_forward(res, "float32")
    loss.backward()
    params = dict(model.named_parameters())
    assert set(params) == set(res["grads"])
    nonzero = 0
    for name, p in params.items():
        want = res["grads"][name].numpy()
        got = (np.zeros_like(want) if p.grad is None
               else p.grad.numpy().reshape(want.shape))
        err = np.linalg.norm(got - want)
        assert err <= GRAD_RTOL * np.linalg.norm(want) + GRAD_ATOL, (
            name, err, np.linalg.norm(want))
        nonzero += bool(np.linalg.norm(want) > 0)
    assert nonzero > len(params) // 2


@pytest.mark.parametrize("shape", list(SHAPES))
def test_bf16_logits_and_loss_hold_to_jax(results, shape):
    res = results[shape]
    with torch.no_grad():
        loss, logits = port_forward(res, "bfloat16")
    assert logits.dtype == torch.float32
    scale = np.abs(res["logits16"]).max()
    gap = np.abs(logits.numpy() - res["logits16"]).max()
    assert gap <= BF16_LOGIT_ULPS * bf16_ulp(scale), (gap, scale)
    assert abs(loss.item() - res["loss16"]) <= 2 * gap + 1e-6, (
        loss.item(), res["loss16"], gap)


def test_fusion_attention_sees_140_keys(results, monkeypatch):
    """At the drivers' geometry the fusion layers attend over 40 + 50 + 50
    keys: the CPU plain path takes the shape the card's online kernels
    take."""
    res = results["lk140"]
    seen = []
    real = port_layers.masked_attention

    def record(q, k, v, bias=None, **kw):
        seen.append(k.shape[1])
        return real(q, k, v, bias, **kw)
    monkeypatch.setattr(port_layers, "masked_attention", record)
    with torch.no_grad():
        port_forward(res, "float32", labels=False)
    half = res["models"]["float32"].config.half_layers
    assert sorted(seen) == [40] * half + [70] * (2 * half) + [140] * half


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_synthetic_root(str(tmp_path_factory.mktemp("nlvr_root")
                                   / "synth"))


def datasets(root, la=35):
    tc = dict(max_seq_length=la, max_tag_length=20, max_img_seq_length=50,
              max_phrases=5)
    jds = jax_nlvr.NLVRDataset(root["nlvr"], JaxFeatureStore(
        root["features"]), JaxTokenizer(root["vocab"]), JaxTCfg(**tc))
    pds = port_nlvr.NLVRDataset(root["nlvr"], FeatureStore(root["features"]),
                                FastBertTokenizer(root["vocab"]),
                                TensorizeConfig(**tc))
    return jds, pds


@pytest.mark.parametrize("la", [35, 10])
def test_dataset_batches_equal_jax(root, la):
    jds, pds = datasets(root, la)
    assert len(pds) == len(jds) == 24
    idx = np.array([3, 0, 17, 5, 23])
    want, got = jds.fetch(idx), pds.fetch(idx)
    assert set(got) == set(want) == set(NLVR_INPUT_NAMES) | {"label"}
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["img_feat2"].shape == (5, 50, 2054)
    assert set(got["label"].tolist()) <= {0, 1}


def test_dataset_rejects_unknown_labels(tmp_path, root):
    path = tmp_path / "bad.jsonl"
    with open(root["nlvr"]) as f:
        item = json.loads(f.readline())
    path.write_text(json.dumps(dict(item, label="maybe")) + "\n")
    _, pds = datasets(dict(root, nlvr=str(path)))
    with pytest.raises(ValueError, match="unrecognized label"):
        pds[0]


def test_task_fetch_and_predict_take_both_image_sides(root):
    """TaskFetch gives the model's eleven names and the label; predict pads
    the last chunk and runs the model over both image sides."""
    _, pds = datasets(root)
    fetch = TaskFetch(pds, NLVR_INPUT_NAMES)
    idx = np.arange(6)
    batch = fetch(idx)
    assert list(batch) == list(NLVR_MODEL_KEYS) + ["label"]
    np.testing.assert_array_equal(batch["img_feats2"],
                                  pds.fetch(idx)["img_feat2"])
    cfg = ModelConfig.from_dict(dataclasses.asdict(jax_tiny_config(
        img_feature_dim=2054, max_position_embeddings=128,
        vocab_size=pds.tokenizer.vocab_size + 20,
        only_word_size=pds.tokenizer.vocab_size)))
    model = NLVRModel(cfg, device="cpu", seed=3)
    logits, kept = predict(model, pds, 16,
                           lambda m, *x: m(*x, max_tag_length=20),
                           keep=("label",), input_names=NLVR_INPUT_NAMES)
    assert logits.shape == (24, 2)
    all_x = batch_on("cpu", fetch(np.arange(24)))
    with torch.no_grad():
        want = model(*(all_x[k] for k in NLVR_MODEL_KEYS),
                     max_tag_length=20).numpy()
    np.testing.assert_allclose(logits, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(kept["label"], all_x["label"].numpy())


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

B, STEPS = 8, 4
COMMON = ["--synthetic", "--tiny", "--platform", "cpu",
          "--hidden_dropout_prob", "0", "--attention_dropout_prob", "0",
          "--do_train", "--do_eval", "--max_steps", str(STEPS),
          "--ckpt_period", str(STEPS), "--log_period", "1",
          "--train_batch_size", str(B), "--eval_batch_size", "16",
          "--dtype", "float32", "--learning_rate", "1e-3"]
SPAWN = ["--worker_start_method", "spawn", "--num_workers", "1"]


@pytest.fixture(scope="module")
def weights(tmp_path_factory, root):
    """(JAX checkpoint dir, port checkpoint dir) of a seeded tiny
    NLVRModel at the drivers' geometry."""
    base = tmp_path_factory.mktemp("nlvr_weights")
    args = jax_nlvr.get_args(["--output_dir", str(base)] + COMMON)
    cfg = jax_build_config(args, JaxTokenizer(root["vocab"]), num_labels=2)
    la, t, r = 40, 20, 50
    z = functools.partial(jnp.zeros, dtype=jnp.int32)
    o = functools.partial(jnp.ones, dtype=jnp.int32)
    side = (z((2, t)), o((2, t + r)), o((2, t)),
            jnp.zeros((2, r, cfg.img_feature_dim)))
    params = jax.jit(lambda: jt.NLVRModel(cfg).init(
        jax.random.PRNGKey(7), z((2, la)), o((2, la)), z((2, la)), *side,
        *side, max_tag_length=t))()["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    jdir = str(base / "jax")
    save_pretrained(jdir, params, config=cfg)
    pcfg = ModelConfig.from_pretrained(jdir)
    model = load_jax_params(NLVRModel(pcfg, device="cpu"), params)
    return jdir, CheckpointManager(str(base / "port")).save(0, model,
                                                            config=pcfg)


def read_jsonl(*path):
    with open(os.path.join(*path)) as f:
        return [json.loads(line) for line in f]


def read_json(*path):
    with open(os.path.join(*path)) as f:
        return json.load(f)


@pytest.mark.budget(240)
def test_cli_matches_jax_driver_and_memory(weights, tmp_path):
    jdir, pdir = weights
    jout, pout = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_nlvr.main(["--output_dir", jout, "--model_name_or_path", jdir]
                  + COMMON)
    res = port_nlvr.main(["--output_dir", pout, "--model_name_or_path", pdir]
                         + COMMON + SPAWN)
    want = read_jsonl(jout, "train_logs", "metrics.jsonl")
    got = read_jsonl(pout, "train_logs", "metrics.jsonl")
    assert [m["step"] for m in got] == [m["step"] for m in want] == \
        list(range(1, STEPS + 1))
    for g, w in zip(got, want):
        for k in ("loss", "acc"):
            assert abs(g[f"train/{k}"] - w[f"train/{k}"]) <= CLI_TOL, (
                g["step"], k, g[f"train/{k}"], w[f"train/{k}"])
    peval = read_json(pout, "eval_logs.json")
    assert peval == read_json(jout, "eval_logs.json") and len(peval) == 1
    assert set(peval[0]) == {"step", "nlvr_accuracy"}

    # step 1 in memory: the sampler's first batch through the same loss
    args = port_nlvr.get_args(["--output_dir", pout] + COMMON)
    pds = port_nlvr.NLVRDataset(
        os.path.join(pout, "synth", "nlvr.jsonl"),
        FeatureStore(os.path.join(pout, "synth", "features",
                                  "predictions.tsv")),
        FastBertTokenizer(os.path.join(pout, "synth", "vocab.txt")),
        TensorizeConfig(max_seq_length=35, max_tag_length=20,
                        max_img_seq_length=50, max_phrases=5))
    model = NLVRModel(ModelConfig.from_pretrained(pdir), device="cpu")
    model.load_state_dict(torch.load(os.path.join(pdir, "pytorch_model.bin"),
                                     weights_only=True))
    batch = batch_on("cpu", TaskFetch(pds, NLVR_INPUT_NAMES)(
        BatchSampler(len(pds), B, seed=args.seed).batch_at(0)))
    model.train()
    with torch.no_grad():
        loss, _ = port_nlvr.nlvr_loss_fn(args)(model, batch, None)
    assert loss.item() == res["train"][0]["loss"]

    # the eval: the trained checkpoint's forward over the eval split
    ckpt = os.path.join(pout, f"checkpoint-{STEPS:07d}")
    model = NLVRModel(ModelConfig.from_pretrained(ckpt), device="cpu")
    model.load_state_dict(torch.load(os.path.join(ckpt, "pytorch_model.bin"),
                                     weights_only=True))
    model.eval()
    all_x = batch_on("cpu", TaskFetch(pds, NLVR_INPUT_NAMES)(
        np.arange(len(pds))))
    with torch.no_grad():
        logits = model(*(all_x[k] for k in NLVR_MODEL_KEYS),
                       max_tag_length=20)
    acc = int((logits.argmax(1) == all_x["label"]).sum()) / len(pds)
    assert acc == peval[0]["nlvr_accuracy"] == res["eval"]["nlvr_accuracy"]
    np.testing.assert_allclose(res["eval"]["logits"], logits.numpy(),
                               atol=1e-5, rtol=0)


def test_runs_on_cuda_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the driver would run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_nlvr.main(["--output_dir", str(tmp_path), "--synthetic",
                        "--tiny", "--do_train", "--max_steps", "1"])
    assert not os.path.exists(tmp_path / "synth")


LATER = sorted(f for f in LATER_ITEMS
               if f in vars(port_nlvr.get_args(["--output_dir", "x"])))


@pytest.mark.parametrize("flag", LATER)
def test_flags_of_later_items_raise(tmp_path, flag):
    off = LATER_ITEMS[flag][0]
    value = ([] if isinstance(off, bool) else
             ["/tmp/x" if off is None else str(int(off) + 1)])
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item"):
        port_nlvr.main(["--output_dir", str(tmp_path), "--synthetic",
                        "--tiny", "--platform", "cpu", f"--{flag}"] + value)
