"""The port's pretraining data plane against the JAX package's, on the CPU:
every check is an exact equality (`np.array_equal` with the same dtype on
every array).

- `random_word`, `random_phrases` and `random_visual` over several seeds and
  mask probabilities: the same outputs and the same random stream consumed;
- `convert_example_to_features` and `convert_qa_example_to_features` past
  `max_seq_length` and `max_tag_length`, with and without region masking and
  the `visual_learning` extras;
- `PretrainDataset.fetch(indices, epoch)` on the synthetic root: plain,
  `qa_pairs`, `only_qa`, `only_cap`, `exclude_ids`, `gt_labels_json`; the
  masks of epoch 0 and epoch 1 differ;
- `MultiCorpusPretrainDataset.from_yaml` with two corpora, one of them over a
  chunked feature list, and `fk_test_id`;
- the port's `ProcessLoader` over `PretrainFetch` across an epoch boundary
  yields JAX `dataset.fetch(sampler.batch_at(s), sampler.epoch_at(s))`
  (spawned workers: this process holds JAX; a deadline on every wait).
"""

import json
import os
import random

import numpy as np
import pytest
import torch

from mvp_pytorch_tpu.data import datasets as jds
from mvp_pytorch_tpu.data import loader as jloader
from mvp_pytorch_tpu.data import masking as jmask
from mvp_pytorch_tpu.data import tensorize as jtz
from mvp_pytorch_tpu.data import tokenization as jtok
from mvp_pytorch_tpu_torch.data import datasets as pds
from mvp_pytorch_tpu_torch.data import loader as ploader
from mvp_pytorch_tpu_torch.data import masking as pmask
from mvp_pytorch_tpu_torch.data import synthetic as psyn
from mvp_pytorch_tpu_torch.data import tensorize as ptz
from mvp_pytorch_tpu_torch.data import tokenization as ptok
from mvp_pytorch_tpu_torch.data.tsv import TSVFile, tsv_writer
from mvp_pytorch_tpu_torch.tasks.pretrain import PORT_NAMES, PretrainFetch

LOADER_TIMEOUT = 60.0
TCFG = dict(max_seq_length=12, max_phrases=3, max_tag_length=7,
            max_img_seq_length=6)
PHRASE_VOCAB = 20


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    """torch single-threaded in this process: no intra-op thread pool is left
    behind for a later test in the same worker that forks."""
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The port's synthetic root, a ground-truth tag map for half of its
    images, and its features split into two chunks."""
    base = tmp_path_factory.mktemp("pretrain_root")
    paths = dict(psyn.make_synthetic_root(str(base / "root"), seed=5))
    store = TSVFile(paths["features"])
    rows = [store.seek(i) for i in range(len(store))]
    paths["chunks"] = []
    for c, part in enumerate((rows[:5], rows[5:])):
        path = base / f"chunk{c}" / "predictions.tsv"
        os.makedirs(path.parent)
        tsv_writer(part, str(path))
        with open(path.parent / "imageid2idx.json", "w") as f:
            json.dump({r[0]: i for i, r in enumerate(part)}, f)
        paths["chunks"].append(str(path))
    paths["gt_labels"] = str(base / "gt_labels.json")
    with open(paths["gt_labels"], "w") as f:
        json.dump({r[0]: ["dog", "ball", "dog", "sky"] for r in rows[::2]}, f)
    return paths


def assert_arrays_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        assert g.dtype == want[k].dtype, k
        np.testing.assert_array_equal(g, want[k], err_msg=k)


def tokenizers(paths):
    return (jtok.FastBertTokenizer(paths["vocab"]),
            ptok.FastBertTokenizer(paths["vocab"]))


# ---------------------------------------------------------------------------
# masking and tensorization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mask_prob", [0.15, 0.5, 1.0])
def test_masking_matches_jax_draw_for_draw(root, mask_prob):
    jt, pt = tokenizers(root)
    words = list(jt.vocab)[5:]
    for seed in range(4):
        toks = [words[(seed * 7 + i * 3) % len(words)] for i in range(40)]
        phrases = [len(jt.vocab) + (seed + i) % PHRASE_VOCAB for i in range(9)]
        pmap = {i: [i % 9, (i + 4) % 9] for i in range(0, 40, 5)}
        regions = np.random.RandomState(seed).randn(13, 22).astype(np.float32)
        tags = ["dog", "ball", "nosuch", "sky"] * 3       # 12 tags, 13 regions
        tag2id = {"dog": 3, "ball": 8, "sky": 11}
        outs = []
        for mod, tok in ((jmask, jt), (pmask, pt)):
            rng = random.Random(f"m:{seed}")
            w, wl = mod.random_word(list(toks), tok.vocab, rng,
                                    mask_prob=mask_prob)
            ph, pl = mod.random_phrases(list(phrases), wl, pmap, tok.vocab,
                                        len(tok.vocab), PHRASE_VOCAB, rng,
                                        mask_prob=mask_prob)
            reg, rl, rf = mod.random_visual(regions.copy(), tags, tag2id, rng,
                                            mask_prob=mask_prob)
            outs.append((w, wl, ph, pl, rl, rf, reg, rng.random()))
        want, got = outs
        assert got[:6] == want[:6]
        assert got[6].dtype == want[6].dtype
        np.testing.assert_array_equal(got[6], want[6])
        assert got[7] == want[7]              # the same stream consumed
        if mask_prob == 1.0:
            assert set(got[0]) <= set(pt.vocab) and -1 not in got[1]
            assert got[5] == [1] * 13
            np.testing.assert_array_equal(got[6][:, :-6], 0)
            np.testing.assert_array_equal(got[6][:, -6:], regions[:, -6:])


def example(mod, tok, seed, qa):
    """A pretraining example whose caption, tags and answer run past the
    small TensorizeConfig's budgets."""
    rs = np.random.RandomState(seed)
    words = list(tok.vocab)[5:]
    pick = lambda n: [words[i] for i in rs.randint(0, len(words), n)]  # noqa
    return mod.PretrainExample(
        tokens_a=pick(15 + seed), tokens_b=pick(9 + seed),
        img_feat=rs.randn(5 + 2 * seed, 22).astype(np.float32),
        od_tags=["dog", "ball", "sky", "car"][: 1 + seed],
        phrase_nodes=[len(tok.vocab) + i for i in rs.randint(0, 20, 4)],
        phrase_mask_map={1: [0, 2], 3: [1]}, qa_ans=seed - 1,
        qa_answer_tokens=pick(4 + seed) if qa else None,
        qa_is_next=seed % 2 if qa else -1, guid=seed)


@pytest.mark.parametrize("converter,mask_visual,visual_learning", [
    ("convert_example_to_features", True, False),
    ("convert_example_to_features", False, False),
    ("convert_example_to_features", True, True),
    ("convert_qa_example_to_features", True, False),
    ("convert_qa_example_to_features", False, False),
])
def test_pretraining_converters_match_jax(root, converter, mask_visual,
                                          visual_learning):
    jt, pt = tokenizers(root)
    qa = converter.startswith("convert_qa")
    extra = dict(visual_learning=True) if visual_learning else {}
    tag2id = {"dog": 5, "ball": 7, "sky": 9}
    for seed in range(4):
        jex, pex = [], []
        for mod, tok, out in ((jtz, jt, jex), (ptz, pt, pex)):
            ex = example(mod, tok, seed, qa)
            out.append(getattr(mod, converter)(
                ex, tok, cfg=mod.TensorizeConfig(**TCFG), tag2id=tag2id,
                phrase_vocab_size=PHRASE_VOCAB,
                rng=random.Random(f"c:{seed}"), mask_prob=0.4,
                mask_visual=mask_visual, **extra))
        assert_arrays_equal(pex[0], jex[0])
        if visual_learning:
            assert {"target_img_feat", "visual_labels",
                    "mask_region_id"} <= set(pex[0])
        assert pex[0]["input_ids_a"].shape == (TCFG["max_seq_length"]
                                               + TCFG["max_phrases"],)


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------

DATASET_CASES = {
    "plain": {},
    "qa_pairs": dict(qa_pairs=True),
    "only_qa": dict(only_qa=True, qa_pairs=True),
    "only_cap": dict(only_cap=True),
    "exclude_ids": dict(exclude_ids={"img_0001", "img_0004"}),
    "gt_labels_json": dict(gt_labels_json="gt"),
}


def pretrain_datasets(paths, **kw):
    """The JAX and port PretrainDatasets over the same root."""
    if kw.get("gt_labels_json"):
        kw["gt_labels_json"] = paths["gt_labels"]
    out = []
    for mod, tok_mod in ((jds, jtok), (pds, ptok)):
        tok = tok_mod.FastBertTokenizer(paths["vocab"])
        with open(paths["tag2id"]) as f:
            wp_tag2id = {t: tok.vocab.get(t, tok.vocab["[UNK]"])
                         for t in json.load(f)}
        out.append(mod.PretrainDataset(
            paths["corpus"], mod.FeatureStore(paths["features"]), tok,
            sg2id=mod.load_phrase_vocab(paths["id2phrase"]),
            cfg=mod.TensorizeConfig(**TCFG), tag2id=wp_tag2id,
            phrase_vocab_size=PHRASE_VOCAB, seed=3, **kw))
    return out


@pytest.mark.parametrize("case", list(DATASET_CASES))
def test_pretrain_dataset_matches_jax(root, case):
    jd, pd = pretrain_datasets(root, **DATASET_CASES[case])
    assert len(pd) == len(jd)
    # two QA rows of every image's five (synthetic.py)
    n = {"only_qa": 24, "only_cap": 36, "exclude_ids": 50}.get(case, 60)
    assert len(pd) == n
    idx = np.array([0, 5, n - 1, 3, 3, 11, 2])
    fetched = []
    for epoch in (None, 0, 1, 2):
        want = jd.fetch(idx, epoch)
        got = pd.fetch(idx, epoch)
        assert_arrays_equal(got, want)
        fetched.append(got)
    assert_arrays_equal(fetched[0], fetched[1])       # epoch None is 0
    assert not np.array_equal(fetched[1]["lm_label_ids_a"],
                              fetched[2]["lm_label_ids_a"])
    if case in ("qa_pairs", "only_qa"):
        assert set(np.unique(fetched[1]["qa_is_next"])) <= {-1, 0, 1}
        assert (fetched[1]["qa_is_next"] >= 0).any()
    if case == "only_qa":
        assert (fetched[1]["qa_is_next"] >= 0).all()


def test_multi_corpus_from_yaml_matches_jax(root, tmp_path):
    """Two corpora, the second over a chunked feature list, with fk_test_id
    and an extra exclude set."""
    corpus_rows = [TSVFile(root["corpus"]).seek(i) for i in range(60)]
    second = str(tmp_path / "second.tsv")
    tsv_writer(corpus_rows[10:40], second)
    spec = {"corpora": [
        {"name": "coco", "corpus_tsv": root["corpus"],
         "feature_tsv": root["features"]},
        {"name": "cc", "corpus_tsv": second, "feature_tsv": root["chunks"]}],
        "id2phrase": root["id2phrase"], "tag2id": root["tag2id"],
        "phrase_vocab_size": PHRASE_VOCAB, "fk_test_id": root["exclude_ids"]}
    path = str(tmp_path / "corpora.yaml")
    import yaml
    with open(path, "w") as f:
        yaml.safe_dump(spec, f)
    jt, pt = tokenizers(root)
    kw = dict(cfg=None, seed=4, mask_prob=0.3, qa_pairs=True,
              exclude_ids={"img_0007"})
    jd = jds.MultiCorpusPretrainDataset.from_yaml(path, jt, **kw)
    pd = pds.MultiCorpusPretrainDataset.from_yaml(path, pt, **kw)
    assert [len(d) for d in pd.datasets] == [len(d) for d in jd.datasets]
    assert len(pd.datasets) == 3 and len(pd) == len(jd)
    # fk_test_id (img_0000, img_0001) and img_0007 leave 9 of 12 images in
    # the first corpus and img_0002-img_0006 in the second, split 3 / 2
    # between its chunks
    assert [len(d) for d in pd.datasets] == [45, 15, 10]
    for epoch in (0, 1):
        for idx in (np.arange(len(pd)), np.array([69, 0, 44, 45, 60, 60])):
            assert_arrays_equal(pd.fetch(idx, epoch), jd.fetch(idx, epoch))


def test_load_from_yaml_is_lazy_and_names_the_flag(tmp_path, monkeypatch):
    from mvp_pytorch_tpu_torch.utils import misc
    import sys
    path = tmp_path / "x.yaml"
    path.write_text("a: [1, 2]\n")
    assert misc.load_from_yaml_file(str(path)) == {"a": [1, 2]}
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="--dataset_yaml"):
        misc.load_from_yaml_file(str(path))


# ---------------------------------------------------------------------------
# the loader passes the epoch
# ---------------------------------------------------------------------------

class _Recorder:
    def __init__(self):
        self.epochs = []

    def fetch(self, indices, epoch=None):
        self.epochs.append(epoch)
        return {k: np.zeros(1) for k in PORT_NAMES}


def test_epoch_aware_calls_match_the_fetch_signature():
    calls = []
    aware = ploader._epoch_aware(lambda idx, epoch=None: calls.append(epoch))
    plain = ploader._epoch_aware(lambda idx: calls.append("plain"))
    aware(np.arange(2), 3)
    plain(np.arange(2), 3)
    aware(np.arange(2), 0)
    assert calls == [3, "plain", 0]
    rec = _Recorder()
    got = ploader._epoch_aware(PretrainFetch(rec, use_qa=True))(
        np.arange(2), 4)
    assert rec.epochs == [4]
    assert "qa_ans" in got and "qa_is_next" not in got
    assert not {"is_next", "is_img_match", "input_mask_a", "img_feat"} & set(
        got)


def test_loader_fetches_each_step_with_its_epoch(root):
    """60 examples in batches of 7: 8 steps an epoch; steps 5-12 cross from
    epoch 0 into epoch 1."""
    jd, pd = pretrain_datasets(root, qa_pairs=True)
    sampler = ploader.BatchSampler(len(pd), 7, seed=2)
    want_sampler = jloader.BatchSampler(len(jd), 7, seed=2)
    fetch = PretrainFetch(pd, use_qa=True, use_qa_pairs=True)
    loader = ploader.ProcessLoader(
        fetch, sampler, start_step=5, num_workers=2,
        multiprocessing_context="spawn", timeout=LOADER_TIMEOUT)
    seen = []
    for step, batch in loader:
        idx = want_sampler.batch_at(step)
        epoch = want_sampler.epoch_at(step)
        raw = jd.fetch(idx, epoch)
        assert_arrays_equal(batch, {PORT_NAMES[k]: raw[k]
                                    for k in fetch.keys})
        if epoch > 0:
            stale = jd.fetch(idx, 0)["lm_label_ids_a"]
            assert not np.array_equal(batch["lm_label_ids_a"].numpy(), stale)
        seen.append((step, epoch))
        if len(seen) == 8:
            break
    assert seen == [(s, s // 8) for s in range(5, 13)]
    assert not loader._procs
    assert not [f for f in os.listdir("/dev/shm") if loader._tag in f]
