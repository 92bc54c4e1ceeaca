"""The port's VQA, SNLI-VE and referring-expression datasets and scores
against the JAX package's, on the CPU: every array check is an exact
equality (values and dtype).

- `VQADataset.fetch` with soft and with int labels, and `--use_b_text`;
- `VEDataset.fetch` with `mask_training` at epochs 0 and 1 (the masks differ
  between epochs and equal JAX's in each), and an eval split unmasked;
- `REDataset.fetch` with detections (one image's entry missing, so it scores
  as a miss), capped at `max_det`, and with `use_phrases`;
- `TaskFetch`: the model's names plus `label`, no `question_id`,
  `det_label` or `iou_mat`, and the epoch passed to a masking dataset;
- `vqa_accuracy`, `re_score`, `re_score_det1` and `re_score_det2` on random
  arrays.
"""

import json

import numpy as np
import pytest
import torch

from mvp_pytorch_tpu.data import datasets as jds
from mvp_pytorch_tpu.data import synthetic as jsyn
from mvp_pytorch_tpu.data import tensorize as jtz
from mvp_pytorch_tpu.data import tokenization as jtok
from mvp_pytorch_tpu.tasks import vqa as jvqa
from mvp_pytorch_tpu_torch.data import datasets as pds
from mvp_pytorch_tpu_torch.data import tensorize as ptz
from mvp_pytorch_tpu_torch.data import tokenization as ptok
from mvp_pytorch_tpu_torch.tasks import vqa as pvqa
from mvp_pytorch_tpu_torch.tasks.common import MODEL_KEYS, TaskFetch

IDX = np.array([0, 3, 5, 7, 2, 11])


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    """torch single-threaded in this process: no intra-op thread pool is left
    behind for a later test in the same worker that forks."""
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return jsyn.make_synthetic_root(str(tmp_path_factory.mktemp("root")),
                                    seed=5)


@pytest.fixture(scope="module")
def build(root):
    """build(name, path, **kw) -> (JAX dataset, port dataset) over the same
    files, each with its own tokenizer and feature store."""
    tcfg = dict(max_seq_length=12, max_tag_length=8, max_img_seq_length=6,
                max_phrases=3)
    sides = {}
    for mod, tok, tz in ((jds, jtok, jtz), (pds, ptok, ptz)):
        sides[mod] = (tok.FastBertTokenizer(root["vocab"]),
                      mod.FeatureStore(root["features"]),
                      mod.load_phrase_vocab(root["id2phrase"]),
                      tz.TensorizeConfig(**tcfg))

    def make(name, path, *args, **kw):
        out = []
        for mod in (jds, pds):
            tok, feats, sg2id, cfg = sides[mod]
            out.append(getattr(mod, name)(path, feats, tok, *args,
                                          sg2id=sg2id, cfg=cfg, **kw))
        return out
    return make


def assert_same(want, got):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("mode", ["soft", "int", "soft_use_b_text"])
def test_vqa_dataset_matches_jax(build, root, mode):
    kw = dict(label_mode=mode[:4].rstrip("_"))
    if mode.endswith("use_b_text"):
        kw.update(use_b_text=True, b_as_list=True)
    with open(root["label2ans"]) as f:
        n_ans = len(json.load(f))
    jd, pd = build("VQADataset", root["vqa"], n_ans, **kw)
    assert len(pd) == len(jd)
    got, want = pd.fetch(IDX), jd.fetch(IDX)
    assert_same(want, got)
    assert got["label"].shape == ((len(IDX), n_ans) if kw["label_mode"]
                                  == "soft" else (len(IDX),))


def test_ve_dataset_masks_by_epoch_like_jax(build, root):
    jd, pd = build("VEDataset", root["ve"], mask_training=True, seed=4)
    idx = np.arange(len(pd))
    masks = []
    for epoch in (0, 1):
        got, want = pd.fetch(idx, epoch), jd.fetch(idx, epoch)
        assert_same(want, got)
        masks.append(got["input_ids_a"])
    mask_id = pd.tokenizer.vocab["[MASK]"]
    assert (masks[0] == mask_id).any() and (masks[1] == mask_id).any()
    assert not np.array_equal(masks[0], masks[1])
    # the loader's fetch passes the epoch through
    fetch = TaskFetch(pd)
    for epoch in (0, 1):
        batch = fetch(idx[:6], epoch)
        assert sorted(batch) == sorted(MODEL_KEYS + ("label",))
        assert np.array_equal(batch["input_ids_a"], masks[epoch][:6])


def test_ve_eval_split_is_unmasked(build, root):
    jd, pd = build("VEDataset", root["ve"])
    got, want = pd.fetch(IDX), jd.fetch(IDX)
    assert_same(want, got)
    assert not (got["input_ids_a"] == pd.tokenizer.vocab["[MASK]"]).any()
    assert set(np.unique(got["label"])) <= {0, 1, 2}


@pytest.fixture(scope="module")
def dets_missing_one(root, tmp_path_factory):
    """The synthetic detections without the first image's entry and with one
    image holding more boxes than max_det."""
    with open(root["re_dets"]) as f:
        dets = json.load(f)
    with open(root["re"]) as f:
        first = str(json.load(f)[0]["image_id"])
    del dets[first]
    key = sorted(dets)[0]
    dets[key] = dets[key] * 3                          # 12 boxes
    path = str(tmp_path_factory.mktemp("dets") / "dets.json")
    with open(path, "w") as f:
        json.dump(dets, f)
    return path


@pytest.mark.parametrize("case", ["plain", "dets", "use_phrases"])
def test_re_dataset_matches_jax(build, root, dets_missing_one, case):
    kw = {"dets": dict(det_json=dets_missing_one, max_det=5),
          "use_phrases": dict(use_phrases=True)}.get(case, {})
    jd, pd = build("REDataset", root["re"], **kw)
    idx = np.arange(len(pd))
    got, want = pd.fetch(idx), jd.fetch(idx)
    assert_same(want, got)
    if case == "dets":
        assert got["det_label"].shape == (len(idx), 5)
        assert got["iou_mat"].shape == (len(idx), 6, 5)
        assert (got["det_label"][0] == -1).all()      # the missing entry
        train = TaskFetch(pd)(idx[:4])
        assert sorted(train) == sorted(MODEL_KEYS + ("label",))
    if case == "use_phrases":
        plain = build("REDataset", root["re"])[1].fetch(idx)
        assert not np.array_equal(plain["input_ids_a"], got["input_ids_a"])


def test_vqa_fetch_keeps_question_id_out(build, root):
    with open(root["label2ans"]) as f:
        pd = build("VQADataset", root["vqa"], len(json.load(f)))[1]
    batch = TaskFetch(pd)(IDX)
    assert sorted(batch) == sorted(MODEL_KEYS + ("label",))
    # a fetch without an epoch takes the loader's epoch and ignores it
    later = TaskFetch(pd)(IDX, 1)
    assert all(np.array_equal(batch[k], later[k]) for k in batch)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scores_match_jax(seed):
    r = np.random.RandomState(seed)
    b, n, reg, det = 16, 9, 6, 4
    logits = r.randn(b, n).astype(np.float32)
    targets = (r.rand(b, n) * (r.rand(b, n) < 0.3)).astype(np.float32)
    assert pvqa.vqa_accuracy(logits, targets) == jvqa.vqa_accuracy(logits,
                                                                   targets)
    region = r.randn(b, reg).astype(np.float32)
    labels = r.rand(b, reg).astype(np.float32)
    labels[::3, -2:] = -1.0
    det_labels = r.rand(b, det).astype(np.float32)
    det_labels[1::4, 1:] = -1.0
    iou = r.rand(b, reg, det).astype(np.float32)
    for name in ("re_score", "re_score_det1", "re_score_det2"):
        args = ((region, labels) if name == "re_score"
                else (region, labels, det_labels, iou))
        got = getattr(pds, name)(*args)
        assert got == getattr(jds, name)(*args), name
        assert 0.0 <= got <= 1.0
