"""The port's single-stream pretraining data and command line against the
JAX package's, on the CPU.

Data (exact equality, `np.array_equal` with the same dtype):
- `ImgOnlyDataset` and `TextOnlyDataset` fetched at epochs 0 and 1 (their
  string-keyed mask seeds), `GeneralDataset` and every processor;
- `CombinedDataset.fetch(indices, epoch)`, the loader's flat batch over it
  (`PretrainFetch`, spawned workers, a deadline on every wait) and the
  `--visual_learning` single-stream batch.

The command line (`--synthetic --tiny --platform cpu --dtype float32`,
dropouts 0): the port's command line and the JAX one on the same seeded
weights with `--visual_learning` (an `ImgBertForPreTraining`) and with
`--extra_mode img_only` / `text_only` (a `BiPretrainModel`, the hard-negative
slot permutation and the WRA draws pinned on both sides): every step's
losses within 5e-4; step 1's loss equal to the port's in-memory step on the
sampler's first batch. Flags that `--visual_learning` refuses raise before
anything is written. The command line's loader workers start from a fork
server: this process holds JAX.
"""

import dataclasses
import functools
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvp_pytorch_tpu.data import datasets as jds
from mvp_pytorch_tpu.data import processors as jproc
from mvp_pytorch_tpu.data.synthetic import make_synthetic_root
from mvp_pytorch_tpu.data.tokenization import BertTokenizer as JaxTokenizer
from mvp_pytorch_tpu.data.tokenization import FastBertTokenizer as JaxFast
from mvp_pytorch_tpu.models import img_bert as jax_img_bert
from mvp_pytorch_tpu.models import pretrain as jax_models
from mvp_pytorch_tpu.tasks import pretrain as jax_pretrain
from mvp_pytorch_tpu.tasks.common import build_config as jax_build_config
from mvp_pytorch_tpu.training.checkpoint import save_pretrained
from mvp_pytorch_tpu_torch.convert import load_jax_params
from mvp_pytorch_tpu_torch.data import datasets as pds
from mvp_pytorch_tpu_torch.data import processors as pproc
from mvp_pytorch_tpu_torch.data import synthetic as psyn
from mvp_pytorch_tpu_torch.data.loader import BatchSampler, ProcessLoader
from mvp_pytorch_tpu_torch.data.tensorize import TensorizeConfig
from mvp_pytorch_tpu_torch.data.tokenization import FastBertTokenizer
from mvp_pytorch_tpu_torch.models import (BiPretrainModel,
                                          ImgBertForPreTraining, ModelConfig)
from mvp_pytorch_tpu_torch.tasks import pretrain as port_pretrain
from mvp_pytorch_tpu_torch.training.checkpoint import CheckpointManager
from mvp_pytorch_tpu_torch.training.loop import batch_on
from torch_flags import LOADER_TIMEOUT, WORKERS, bounded_loader

TCFG = dict(max_seq_length=12, max_phrases=3, max_tag_length=7,
            max_img_seq_length=6)
LOSS_TOL = 5e-4
STEPS = 3
# extra_mode: the extra sub-batch B / 2 = 8 rows, one per JAX CPU device
B = {"visual_learning": 8, "img_only": 16, "text_only": 16}
PERMS = {n: np.random.RandomState(n).permutation(n) for n in (8, 16)}
WRA_PICK, NEG_OFFSET = 0, 1
COMMON = ["--synthetic", "--tiny", "--platform", "cpu",
          "--hidden_dropout_prob", "0", "--attention_dropout_prob", "0",
          "--max_steps", str(STEPS), "--ckpt_period", str(STEPS),
          "--log_period", "1", "--dtype", "float32", "--learning_rate",
          "1e-3"]
CASES = {
    "visual_learning": ["--visual_learning"],
    "img_only": ["--extra_mode", "img_only", "--extra_batch_divisor", "2"],
    "text_only": ["--extra_mode", "text_only", "--extra_batch_divisor", "2",
                  "--extra_loss_weight", "0.3"],
}
METRICS = {"visual_learning": ("loss", "mlm", "itm", "mrc", "mrf"),
           "img_only": ("loss", "vis_mlm", "clip", "mlm", "itm", "wra",
                        "extra"),
           "text_only": ("loss", "vis_mlm", "clip", "mlm", "itm", "wra",
                         "extra")}


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    """torch single-threaded in this process: no intra-op thread pool is left
    behind for a later test in the same worker that forks."""
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The port's synthetic root and a GeneralDataset json over it."""
    base = tmp_path_factory.mktemp("single_stream_root")
    paths = dict(psyn.make_synthetic_root(str(base / "root"), seed=5))
    with open(paths["captions"]) as f:
        caps = json.load(f)
    records = [{"image_id": k, "text": c["text"], "phrases": c["phrases"],
                "label": i % 3}
               for i, (k, v) in enumerate(sorted(caps.items()))
               for c in v[:1]]
    paths["general"] = str(base / "general.json")
    with open(paths["general"], "w") as f:
        json.dump(records, f)
    return paths


def assert_arrays_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        assert g.dtype == want[k].dtype, k
        np.testing.assert_array_equal(g, want[k], err_msg=k)


def datasets(kind, paths):
    """(JAX dataset, port dataset) of `kind`."""
    jtc = jds.TensorizeConfig(**TCFG)
    ptc = TensorizeConfig(**TCFG)
    jt, pt = JaxFast(paths["vocab"]), FastBertTokenizer(paths["vocab"])
    if kind == "img_only":
        return (jds.ImgOnlyDataset(jds.FeatureStore(paths["features"]), jt,
                                   cfg=jtc, seed=3, mask_prob=0.4),
                pds.ImgOnlyDataset(pds.FeatureStore(paths["features"]), pt,
                                   cfg=ptc, seed=3, mask_prob=0.4))
    return (jds.TextOnlyDataset(paths["corpus"], jt, cfg=jtc, seed=3,
                                mask_prob=0.4),
            pds.TextOnlyDataset(paths["corpus"], pt, cfg=ptc, seed=3,
                                mask_prob=0.4))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["img_only", "text_only"])
def test_uni_modal_datasets_match_jax(root, kind):
    jd, pd_ = datasets(kind, root)
    assert len(pd_) == len(jd)
    idx = np.array([0, 3, 5, 1, len(jd) - 1])
    fetched = {}
    for epoch in (None, 0, 1):
        want = jd.fetch(idx, epoch)
        got = pd_.fetch(idx, epoch)
        assert_arrays_equal(got, want)
        fetched[epoch] = got
    labels = "lm_label_ids_b" if kind == "img_only" else "lm_label_ids_a"
    assert_arrays_equal(fetched[None], fetched[0])
    assert not np.array_equal(fetched[0][labels], fetched[1][labels])
    assert (fetched[0][labels] >= 0).any()
    if kind == "text_only":      # one zero dummy region
        assert (np.diff(fetched[0]["image_index"], axis=1) == 1).all()
        assert not fetched[0]["img_feat"].any()


def test_general_dataset_matches_jax(root):
    sg2id = pds.load_phrase_vocab(root["id2phrase"])
    jt, pt = JaxFast(root["vocab"]), FastBertTokenizer(root["vocab"])
    jd = jds.GeneralDataset(root["general"], jds.FeatureStore(
        root["features"]), jt, sg2id=jds.load_phrase_vocab(root["id2phrase"]),
        cfg=jds.TensorizeConfig(**TCFG))
    pd_ = pds.GeneralDataset(root["general"], pds.FeatureStore(
        root["features"]), pt, sg2id=sg2id, cfg=TensorizeConfig(**TCFG))
    assert len(pd_) == len(jd) == 12
    idx = np.arange(len(jd))[::-1]
    got = pd_.fetch(idx)
    assert_arrays_equal(got, jd.fetch(idx))
    assert sorted(set(got["label"].tolist())) == [0, 1, 2]


def write_processor_files(d):
    vqa = [{"question_id": 5, "image_id": "img_1", "question": "what?",
            "labels": [2], "scores": [1.0], "od_labels": "dog ball",
            "phrases": [["dog", "runs"]]},
           {"question_id": 6, "image_id": 7, "question": "how many?",
            "labels": [0], "scores": [0.6]}]
    gqa = [{"question": "where?", "image_id": "g1", "label": 3,
            "od_labels": "sky"}]
    nlvr = [{"sentence": "two dogs", "label": "True", "img0": "a",
             "img1": "b"},
            {"sentence": "no cat", "label": "false", "img0": "c",
             "img1": "d", "phrases": [["cat", "sits"]]},
            {"sentence": "unlabeled", "img0": "e", "img1": "f"}]
    vcr = [{"question": "why?", "img_id": "i1",
            "answer_choices": ["a", "b", "c", "d"], "answer_label": 1,
            "rationale_choices": ["r1", "r2", "r3"], "rationale_label": 2},
           {"question": "who?", "image_id": "i2",
            "answer_choices": ["x", "y"], "rationale_choices": ["s", "t"]}]
    files = {"train": vqa, "val": vqa[::-1], "test2015": vqa[:1]}
    for split, recs in files.items():
        with open(os.path.join(d, "vqa", f"{split}.jsonl"), "w") as f:
            f.write("\n".join(json.dumps(r) for r in recs) + "\n")
    with open(os.path.join(d, "vqa", "val_sg_tuples.json"), "w") as f:
        json.dump({"6": [["two", "apples"]]}, f)
    for sub, recs, splits in (("gqa", gqa, ("train", "val")),
                              ("nlvr", nlvr, ("train", "dev")),
                              ("vcr", vcr, ("train", "val"))):
        for split in splits:
            with open(os.path.join(d, sub, f"{split}.jsonl"), "w") as f:
                f.write("\n".join(json.dumps(r) for r in recs) + "\n\n")
    with open(os.path.join(d, "ans2label.json"), "w") as f:
        json.dump({"yes": 0, "no": 1}, f)


def test_processors_match_jax(tmp_path):
    d = str(tmp_path)
    for sub in ("vqa", "gqa", "nlvr", "vcr"):
        os.makedirs(os.path.join(d, sub))
    write_processor_files(d)
    assert sorted(pproc.PROCESSORS) == sorted(jproc.PROCESSORS)
    label_file = os.path.join(d, "ans2label.json")
    for name in pproc.PROCESSORS:
        modes = ("qa", "qar", "q_ar") if name == "vcr" else (None,)
        sub = {"vqa_text": "vqa", "vqa_text_a": "vqa"}.get(name, name)
        for mode in modes:
            args = () if mode is None else (mode,)
            jp, pp = jproc.PROCESSORS[name](*args), pproc.PROCESSORS[name](
                *args)
            assert pp.name == jp.name
            calls = [("get_train_examples", (os.path.join(d, sub),)),
                     ("get_dev_examples", (os.path.join(d, sub),)),
                     ("get_labels", (label_file,))]
            if name.startswith("vqa"):
                calls.append(("get_test_examples", (os.path.join(d, sub),)))
            for method, a in calls:
                want = getattr(jp, method)(*a)
                got = getattr(pp, method)(*a)
                if method == "get_labels":
                    assert got == want, (name, mode)
                    continue
                assert [dataclasses.asdict(e) for e in got] == [
                    dataclasses.asdict(e) for e in want], (name, mode, method)
    with pytest.raises(AssertionError):
        pproc.VCRProcessor("bad")
    with pytest.raises(NotImplementedError):
        pproc.DataProcessor().get_train_examples(d)


@pytest.mark.parametrize("kind", ["img_only", "text_only"])
def test_combined_fetch_and_loader_match_jax(root, kind):
    """The JAX task's CombinedDataset and the port's give the same two
    sub-batches for an epoch; the loader's flat batch over `PretrainFetch`
    holds them under their names and the extra stream's under
    `EXTRA_PREFIX`, for the sampler's steps across an epoch boundary."""
    jtc, ptc = jds.TensorizeConfig(**TCFG), TensorizeConfig(**TCFG)
    jt, pt = JaxFast(root["vocab"]), FastBertTokenizer(root["vocab"])
    jmain = jds.PretrainDataset(root["corpus"], jds.FeatureStore(
        root["features"]), jt, cfg=jtc, seed=3)
    pmain = pds.PretrainDataset(root["corpus"], pds.FeatureStore(
        root["features"]), pt, cfg=ptc, seed=3)
    jextra, pextra = datasets(kind, root)
    jc = jax_pretrain.CombinedDataset(jmain, jextra, 3)
    pc = port_pretrain.CombinedDataset(pmain, pextra, 3)
    assert len(pc) == len(jc) == 60
    idx = np.array([4, 17, 58, 2, 33, 9, 41])
    for epoch in (None, 1):
        want, got = jc.fetch(idx, epoch), pc.fetch(idx, epoch)
        assert sorted(got) == ["extra", "main"]
        assert got["extra"]["input_ids_a"].shape[0] == len(idx) // 3
        for part in ("main", "extra"):
            assert_arrays_equal(got[part], want[part])

    fetch = port_pretrain.PretrainFetch(pc)
    sampler = BatchSampler(len(pc), 16, seed=2)
    start = sampler.epoch_len // 16            # the first step of epoch 1
    loader = ProcessLoader(fetch, sampler, start_step=start - 1,
                           num_workers=1, device="cpu",
                           multiprocessing_context="spawn",
                           timeout=LOADER_TIMEOUT)
    try:
        for n, (step, batch) in enumerate(loader):
            raw = jc.fetch(sampler.batch_at(step), sampler.epoch_at(step))
            names = port_pretrain.PORT_NAMES
            want = {names[k]: raw["main"][k] for k in names
                    if names[k] not in ("qa_ans", "qa_is_next")}
            want.update({port_pretrain.EXTRA_PREFIX + names[k]:
                         raw["extra"][k] for k in names
                         if names[k] not in port_pretrain.EXTRA_DROPS})
            assert_arrays_equal(batch, want)
            if n == 1:
                break
    finally:
        loader.close()
    assert sampler.epoch_at(step) == 1


def test_visual_learning_batch_is_the_fused_stream(root):
    """`PretrainFetch(visual_learning=True)` over the port's dataset gives
    the JAX task's `vl_kwargs` of the JAX dataset's batch."""
    with open(root["tag2id"]) as f:
        tag2id = json.load(f)
    jtc, ptc = jds.TensorizeConfig(**TCFG), TensorizeConfig(**TCFG)
    jd = jds.PretrainDataset(
        root["corpus"], jds.FeatureStore(root["features"]),
        JaxFast(root["vocab"]), cfg=jtc, tag2id=tag2id, seed=3,
        mask_prob=0.4, visual_learning=True)
    pd_ = pds.PretrainDataset(
        root["corpus"], pds.FeatureStore(root["features"]),
        FastBertTokenizer(root["vocab"]), cfg=ptc, tag2id=tag2id, seed=3,
        mask_prob=0.4, visual_learning=True)
    idx = np.array([3, 0, 44, 12])
    raw = jd.fetch(idx, 1)
    mt = TCFG["max_tag_length"]

    def cat(a, b):
        return np.concatenate([raw[a], raw[b]], 1)
    want = dict(
        input_ids=cat("input_ids_a", "input_ids_b"),
        attention_mask=cat("input_mask_a", "input_mask_b"),
        token_type_ids=cat("segment_ids_a", "segment_ids_b"),
        img_feats=raw["img_feat"],
        masked_lm_labels=np.concatenate(
            [raw["lm_label_ids_a"], raw["lm_label_ids_b"][:, :mt]], 1),
        next_sentence_label=raw["is_next"],
        masked_region_labels=raw["visual_labels"],
        masked_region_targets=raw["target_img_feat"],
        masked_region_flags=raw["mask_region_id"])
    got = port_pretrain.PretrainFetch(pd_, visual_learning=True,
                                      max_tag_length=mt)(idx, 1)
    assert_arrays_equal(got, want)
    assert tuple(got) == port_pretrain.SINGLE_STREAM_KEYS
    flags = got["masked_region_flags"] > 0
    assert flags.any()
    assert not got["img_feats"][flags][:, :-6].any()    # geometry kept
    np.testing.assert_array_equal((got["masked_region_labels"] >= 0),
                                  flags & (got["masked_region_labels"] >= 0))


def test_trainer_splits_each_sub_batch_by_its_own_rows():
    """With gradient accumulation, each micro batch takes its share of the
    main batch's rows and of the extra sub-batch's (the loader's flat batch
    under `--extra_mode` holds both); the step's loss is their mean."""
    from mvp_pytorch_tpu_torch.training.optim import make_optimizer
    from mvp_pytorch_tpu_torch.training.trainer import Trainer
    model = torch.nn.Linear(3, 1)
    seen, losses = [], []

    def loss_fn(model, batch, generator):
        main, extra = port_pretrain.split_extra(batch)
        seen.append((main["x"].shape[0], extra["x"].shape[0]))
        loss = model(main["x"]).mean() + model(extra["x"]).mean()
        losses.append(loss.item())
        return loss, {}
    batch = {"x": torch.randn(8, 3),
             port_pretrain.EXTRA_PREFIX + "x": torch.randn(4, 3)}
    got = Trainer(model, loss_fn, make_optimizer(model, 1e-3),
                  grad_accum=2).step(batch)
    assert seen == [(4, 2), (4, 2)]
    assert abs(got["loss"] - sum(losses) / 2) <= 1e-6
    with pytest.raises(ValueError, match="not divisible"):
        Trainer(model, loss_fn, make_optimizer(model, 1e-3),
                grad_accum=3).step(batch)


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True)
def _bounded_loader():
    with bounded_loader():
        yield


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """{case: (JAX checkpoint dir, port checkpoint dir)}: a seeded tiny
    `ImgBertForPreTraining` with an MRC head over the synthetic tag2id's
    classes, and a seeded tiny `BiPretrainModel` (no QA heads)."""
    base = tmp_path_factory.mktemp("single_stream_weights")
    root = make_synthetic_root(str(base / "root"))
    with open(root["tag2id"]) as f:
        n_tags = len(json.load(f))
    args = jax_pretrain.get_args(["--output_dir", str(base)] + COMMON)
    cfg = jax_build_config(args, JaxTokenizer(root["vocab"]),
                           qa_answer_size=0)
    la, t, r = 40, 20, 50
    z = functools.partial(jnp.zeros, dtype=jnp.int32)
    o = functools.partial(jnp.ones, dtype=jnp.int32)
    feats = jnp.zeros((2, r, cfg.img_feature_dim))
    vl = jax_img_bert.ImgBertForPreTraining(cfg, use_mrfr=True,
                                            od_tag_size=n_tags)
    vl_params = jax.jit(lambda: vl.init(
        jax.random.PRNGKey(3), z((2, la + t)), o((2, la + t + r)),
        z((2, la + t)), feats, jnp.full((2, la + t), -1, jnp.int32), z((2,)),
        jnp.full((2, r), -1, jnp.int32), feats, z((2, r)), max_pred=30,
        deterministic=True))()["params"]
    keys = {k: jax.random.PRNGKey(i) for i, k in
            enumerate(("params", "hardneg", "dropout", "wra"), 7)}
    bi_params = jax.jit(lambda: jax_models.BiPretrainModel(cfg).init(
        keys, z((2, la)), o((2, la)), z((2, la)),
        jnp.full((2, la), -1, jnp.int32), z((2, t)), o((2, t + r)), o((2, t)),
        jnp.full((2, t + r), -1, jnp.int32), feats,
        jnp.asarray([[1, 3], [1, 2]]), jnp.asarray([[la, la + r]] * 2),
        max_tag_length=t, deterministic=True))()["params"]
    out = {}
    for name, params in (("visual_learning", vl_params),
                         ("bi", bi_params)):
        tree = jax.tree_util.tree_map(np.asarray, params)
        jdir = str(base / name / "jax")
        save_pretrained(jdir, tree, config=cfg)
        pcfg = ModelConfig.from_pretrained(jdir)
        model = (ImgBertForPreTraining(pcfg, use_mrfr=True,
                                       od_tag_size=n_tags, device="cpu")
                 if name == "visual_learning"
                 else BiPretrainModel(pcfg, device="cpu"))
        load_jax_params(model, tree)
        pdir = CheckpointManager(str(base / name / "port")).save(
            0, model, config=pcfg)
        out[name] = (jdir, pdir)
    return out


@pytest.fixture
def pinned(monkeypatch):
    """Both command lines take the slot permutation PERMS[batch], WRA slot
    WRA_PICK and the WRA negative NEG_OFFSET ahead, in the main and the
    extra forward."""
    def batch_size(args, kw):
        return (args[0] if args else kw["input_ids_a"]).shape[0]

    class Pinned(jax_models.BiPretrainModel):
        def __call__(self, *args, **kw):
            return super().__call__(
                *args, hn_dice=jnp.asarray(PERMS[batch_size(args, kw)]), **kw)
    monkeypatch.setattr(jax_pretrain, "BiPretrainModel", Pinned)
    monkeypatch.setattr(jax_models, "wra_sample_loss", functools.partial(
        jax_models.wra_sample_loss, pick=WRA_PICK, neg_offset=NEG_OFFSET))
    real = BiPretrainModel.train_step

    def train_step(self, *args, **kw):
        kw.update(wra_pick=WRA_PICK, wra_neg_offset=NEG_OFFSET,
                  hn_dice=torch.from_numpy(PERMS[batch_size(args, kw)]))
        return real(self, *args, **kw)
    monkeypatch.setattr(BiPretrainModel, "train_step", train_step)


def read_metrics(out):
    with open(os.path.join(out, "train_logs", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def in_memory_first_loss(argv):
    """The port's loss on the sampler's first batch, set up as the command
    line sets it up, without the loader."""
    args = port_pretrain.get_args(argv)
    tokenizer = FastBertTokenizer(port_pretrain.resolve_data(args))
    run = port_pretrain.prepare(args, tokenizer, torch.device("cpu"),
                                logging.getLogger("in_memory"))
    sampler = BatchSampler(len(run.dataset), args.train_batch_size,
                           seed=args.seed)
    batch = batch_on(torch.device("cpu"),
                     run.fetch(sampler.batch_at(0), sampler.epoch_at(0)))
    run.model.train()
    with torch.no_grad():
        loss, _ = run.loss_fn(run.model, batch, torch.Generator())
    return loss.item()


@pytest.mark.budget(240)
@pytest.mark.parametrize("case", list(CASES))
def test_cli_matches_jax_driver(weights, pinned, tmp_path, case):
    jdir, pdir = weights["visual_learning" if case == "visual_learning"
                         else "bi"]
    flags = COMMON + CASES[case] + ["--train_batch_size", str(B[case])]
    jout, pout = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_pretrain.main(["--output_dir", jout, "--model_name_or_path", jdir]
                      + flags)
    argv = ["--output_dir", pout, "--model_name_or_path", pdir] + flags
    res = port_pretrain.main(argv + WORKERS + ["2"])
    want, got = read_metrics(jout), read_metrics(pout)
    assert [m["step"] for m in got] == [m["step"] for m in want] == \
        list(range(1, STEPS + 1))
    for g, w in zip(got, want):
        assert {k for k in g if k.startswith("train/")} >= {
            f"train/{k}" for k in METRICS[case]}
        for k in METRICS[case]:
            assert abs(g[f"train/{k}"] - w[f"train/{k}"]) <= LOSS_TOL, (
                g["step"], k, g[f"train/{k}"], w[f"train/{k}"])
    losses = [m["loss"] for m in res["train"]]
    assert losses == [m["train/loss"] for m in got]
    assert all(np.isfinite(losses))
    first = in_memory_first_loss(argv)
    assert abs(losses[0] - first) <= 1e-6, (losses[0], first)
    with open(os.path.join(pout, "log.txt")) as f:
        log = f.read()
    assert "corpus: 60 examples" in log
    if case != "visual_learning":
        n = 12 if case == "img_only" else 60
        assert f"extra stream ({case}): {n} examples" in log


@pytest.mark.parametrize("flag", ["no_tag2id"]
                         + list(port_pretrain.VISUAL_LEARNING_REFUSES))
def test_visual_learning_refuses_incompatible_flags(tmp_path, flag):
    out = tmp_path / "out"
    data = ["--synthetic"]
    extra = {"no_tag2id": [], "extra_mode": ["--extra_mode", "img_only"],
             "moe_experts": ["--moe_experts", "2"]}.get(flag, [f"--{flag}"])
    if flag == "no_tag2id":
        data = ["--corpus_tsv", "c.tsv", "--feature_tsv", "f.tsv"]
    with pytest.raises(ValueError, match="--visual_learning"):
        port_pretrain.main(["--output_dir", str(out), "--tiny", "--platform",
                            "cpu", "--visual_learning"] + data + extra)
    assert not out.exists()
