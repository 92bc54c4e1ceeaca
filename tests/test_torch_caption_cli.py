"""The port's captioning command line (`tasks/captioning.py`) and its caption
metrics (`utils/`) on the CPU.

- `CaptionDataset` array for array against the JAX class on the synthetic
  root (its string-keyed masking, the one-position rule, the contexts, the
  references);
- `CiderScorer`, `evaluate_captions`, `rouge_l`, `meteor` and
  `porter_stem` equal to the JAX package's on fixed token lists, and SPICE
  left out without its jar;
- `python -m mvp_pytorch_tpu_torch.tasks.captioning --synthetic --tiny
  --platform cpu --do_train --do_eval` through spawned loader workers (a
  60 s deadline on every wait): step 1's loss equal to the same batch's
  step in memory, the scores logged, and a standalone `--do_eval` of the
  checkpoint writes `test_eval.json` with the captions the training run
  decoded, in both decode modes, restoring `max_gen_length`;
- `--scst` (finite SCST losses, the eval after it) and `--use_cbs` (the
  constrained captions and hits in cbs_captions.json) on a seeded model and
  after training; a pipeline-staged checkpoint raises, naming item 6,
  before anything is written; without `--platform cpu` the driver asks for
  CUDA.
"""

import functools
import json
import math
import os
import shutil

import numpy as np
import pytest
import torch

from mvp_pytorch_tpu.data.datasets import FeatureStore as JaxFeatureStore
from mvp_pytorch_tpu.data.synthetic import make_synthetic_root
from mvp_pytorch_tpu.data.tokenization import FastBertTokenizer as JaxTok
from mvp_pytorch_tpu.tasks.captioning import CaptionDataset as JaxCaptions
from mvp_pytorch_tpu.utils import caption_eval as jeval
from mvp_pytorch_tpu.utils import cider as jcider
from mvp_pytorch_tpu.utils import meteor_rouge as jmr
from mvp_pytorch_tpu_torch.data.datasets import FeatureStore
from mvp_pytorch_tpu_torch.data.loader import BatchSampler, ProcessLoader
from mvp_pytorch_tpu_torch.data.tokenization import FastBertTokenizer
from mvp_pytorch_tpu_torch.tasks import captioning as cap
from mvp_pytorch_tpu_torch.tasks import common
from mvp_pytorch_tpu_torch.training.loop import train_on_batches
from mvp_pytorch_tpu_torch.utils import caption_eval as peval
from mvp_pytorch_tpu_torch.utils import cider as pcider
from mvp_pytorch_tpu_torch.utils import meteor_rouge as pmr
from mvp_pytorch_tpu_torch.utils import spice as pspice

B, STEPS = 8, 4
LOSS_TOL = 1e-5
TRAIN = ["--synthetic", "--tiny", "--platform", "cpu", "--do_train",
         "--do_eval", "--max_steps", str(STEPS), "--ckpt_period", str(STEPS),
         "--log_period", "1", "--train_batch_size", str(B),
         "--eval_batch_size", "5", "--dtype", "float32",
         "--learning_rate", "1e-3", "--max_gen_length", "12",
         "--drop_worst_ratio", "0.2", "--drop_worst_after", "2",
         "--worker_start_method", "spawn", "--num_workers", "1"]


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    """torch single-threaded in this process: no intra-op thread pool is left
    behind for a later test in the same worker that forks."""
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_synthetic_root(str(tmp_path_factory.mktemp("caption_root")))


# ---------------------------------------------------------------------------
# the dataset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mask_prob", [0.15, 0.0])
def test_caption_dataset_matches_jax(root, mask_prob):
    """Every example and the references against the JAX class; with
    mask_prob 0 each caption has exactly one masked position."""
    kw = dict(max_cap=12, max_tag=6, max_img=4, mask_prob=mask_prob, seed=3)
    jds = JaxCaptions(root["captions"], JaxFeatureStore(root["features"]),
                      JaxTok(root["vocab"]), **kw)
    pds = cap.CaptionDataset(root["captions"], FeatureStore(root["features"]),
                             FastBertTokenizer(root["vocab"]), **kw)
    assert len(pds) == len(jds) and pds.items == jds.items
    idx = np.arange(len(pds))
    want, got = jds.fetch(idx), pds.fetch(idx)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if mask_prob == 0:
        assert (got["masked_pos"].sum(1) == 1).all()
    assert pds.references() == jds.references()
    assert pds.images() == sorted({img for img, _ in jds.items})


# ---------------------------------------------------------------------------
# the metrics
# ---------------------------------------------------------------------------

CANDS = [["a", "man", "riding", "a", "horse"],
         ["two", "dogs", "playing", "in", "the", "snow"],
         ["a", "plate", "of", "food"],
         []]
REFS = [[["a", "man", "rides", "a", "brown", "horse"],
         ["a", "person", "riding", "a", "horse", "on", "grass"]],
        [["two", "dogs", "play", "in", "snow"], ["dogs", "running"]],
        [["a", "plate", "with", "food", "on", "it"],
         ["food", "on", "a", "white", "plate"]],
        [["an", "empty", "room"]]]


def test_cider_matches_jax():
    for cider_d in (True, False):
        want = jcider.CiderScorer(cider_d=cider_d).compute(CANDS, REFS)
        got = pcider.CiderScorer(cider_d=cider_d).compute(CANDS, REFS)
        assert got[0] == want[0]
        np.testing.assert_array_equal(np.asarray(got[1]),
                                      np.asarray(want[1]))


def test_evaluate_captions_matches_jax():
    preds = {str(i): c for i, c in enumerate(CANDS)}
    refs = {str(i): r for i, r in enumerate(REFS)}
    want = jeval.evaluate_captions(preds, refs, spice=False)
    got = peval.evaluate_captions(preds, refs, spice=False)
    assert got == want
    assert set(got) == {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR",
                        "ROUGE_L", "CIDEr"}
    assert all(math.isfinite(v) for v in got.values())


def test_rouge_meteor_stem_match_jax():
    assert pmr.rouge_l(CANDS, REFS) == jmr.rouge_l(CANDS, REFS)
    assert pmr.meteor(CANDS, REFS) == jmr.meteor(CANDS, REFS)
    syn = {"rides": frozenset({"riding"}), "riding": frozenset({"rides"})}
    assert (pmr.meteor(CANDS, REFS, synonyms=syn)
            == jmr.meteor(CANDS, REFS, synonyms=syn))
    for w in ("caresses", "ponies", "relational", "conditional", "running",
              "hopeful", "generalization", "plates", "agreed", "sky"):
        assert pmr.porter_stem(w) == jmr.porter_stem(w), w


def test_spice_is_left_out_without_its_jar(monkeypatch, tmp_path):
    """No jar found: the metric is unavailable, computes nothing, and
    `evaluate_captions` leaves the key out."""
    monkeypatch.setenv("SPICE_JAR", str(tmp_path / "absent.jar"))
    monkeypatch.setenv("HOME", str(tmp_path))
    if pspice.find_spice_jar() is not None:
        pytest.skip("a spice jar is installed in the repository")
    metric = pspice.SpiceMetric()
    assert not metric.available and metric.compute(CANDS, REFS) is None
    assert "absent" in metric.status()
    preds = {str(i): c for i, c in enumerate(CANDS)}
    refs = {str(i): r for i, r in enumerate(REFS)}
    assert "SPICE" not in peval.evaluate_captions(preds, refs)


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One `--do_train --do_eval` run through spawned workers, which must
    answer within 60 s or the run fails instead of waiting, and the same
    first batch's step in memory."""
    out = str(tmp_path_factory.mktemp("caption_cli"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(common, "ProcessLoader",
                   functools.partial(ProcessLoader, timeout=60.0))
        res = cap.main(["--output_dir", out] + TRAIN)
    args = cap.get_args(["--output_dir", out] + TRAIN)
    paths = json.load(open(os.path.join(out, "synth", "paths.json")))
    args.captions_json, args.feature_tsv = paths["captions"], paths["features"]
    ds, model = cap.prepare(args, FastBertTokenizer(paths["vocab"]), "cpu")
    assert model.drop_worst_after == 2 and model.drop_worst_ratio == 0.2
    first = ds.fetch(BatchSampler(len(ds), B, seed=args.seed).batch_at(0))
    mem = train_on_batches(model, cap.caption_loss_fn, [first], 1,
                           learning_rate=args.learning_rate,
                           weight_decay=args.weight_decay, seed=args.seed)
    return out, res, mem


def test_cli_trains_and_scores(trained):
    out, res, mem = trained
    losses = [m["loss"] for m in res["train"]]
    assert len(losses) == STEPS and all(map(math.isfinite, losses))
    assert abs(losses[0] - mem[0]["loss"]) <= LOSS_TOL
    scores = res["eval"]
    assert {"Bleu_4", "METEOR", "ROUGE_L", "cider_d"} <= set(scores)
    assert "CIDEr" not in scores
    assert all(math.isfinite(v) for v in scores.values())
    logs = json.load(open(os.path.join(out, "eval_logs.json")))
    assert logs[-1]["step"] == STEPS and logs[-1]["cider_d"] == scores[
        "cider_d"]
    log = open(os.path.join(out, "log.txt")).read()
    assert f"step {STEPS}: CIDEr-D = " in log
    assert len(res["captions"]) == 12          # every synthetic image
    ckpt = os.path.join(out, f"checkpoint-{STEPS:07d}")
    saved = json.load(open(os.path.join(ckpt, "training_args.json")))
    assert saved["max_gen_length"] == 12


@pytest.mark.parametrize("mode", ["cached", "recompute"])
def test_standalone_eval_writes_test_eval(trained, tmp_path, mode):
    """`--do_eval` alone on the checkpoint: `max_gen_length` restored from
    its training_args.json, greedy captions equal to the training run's
    final eval (decoded cached), in both decode modes; `test_eval.json`
    holds the scores."""
    out, res, _ = trained
    ckpt = os.path.join(out, f"checkpoint-{STEPS:07d}")
    ev = str(tmp_path / "eval")
    got = cap.main(["--output_dir", ev, "--model_name_or_path", ckpt,
                    "--synthetic", "--tiny", "--platform", "cpu",
                    "--do_eval", "--dtype", "float32", "--eval_batch_size",
                    "7", "--decode_mode", mode])
    assert got["captions"] == res["captions"]
    with open(os.path.join(ev, "test_eval.json")) as f:
        scores = json.load(f)
    assert scores == pytest.approx(res["eval"], abs=1e-12)
    log = open(os.path.join(ev, "log.txt")).read()
    assert "restored train-time max_gen_length=12" in log


def test_beam_eval_runs(trained, tmp_path):
    out, _, _ = trained
    ckpt = os.path.join(out, f"checkpoint-{STEPS:07d}")
    res = {}
    for mode in ("cached", "recompute"):
        res[mode] = cap.main(["--output_dir", str(tmp_path / mode),
                              "--model_name_or_path", ckpt, "--synthetic",
                              "--tiny", "--platform", "cpu", "--do_eval",
                              "--dtype", "float32", "--num_beams", "3",
                              "--decode_mode", mode])
    assert res["cached"]["captions"] == res["recompute"]["captions"]
    assert math.isfinite(res["cached"]["eval"]["cider_d"])


@pytest.mark.parametrize("flag", ["--scst", "--use_cbs"])
def test_later_items_raise(tmp_path, flag):
    """`--scst` and `--use_cbs` (which raised until their port) run on a
    seeded tiny model: SCST's losses finite, two steps, and the eval after
    them; the constrained captions and their hits in cbs_captions.json."""
    out = tmp_path / "out"
    extra = ["--scst", "--scst_steps", "2", "--scst_batch", "4",
             "--max_steps", "5"] if flag == "--scst" else ["--use_cbs"]
    res = cap.main(["--output_dir", str(out), "--synthetic", "--tiny",
                    "--platform", "cpu", "--do_eval", "--dtype", "float32",
                    "--max_gen_length", "10"] + extra)
    log = open(out / "log.txt").read()
    if flag == "--scst":
        assert [sorted(h) for h in res["scst"]] == [["loss", "mean_adv"]] * 2
        assert all(math.isfinite(h["loss"]) for h in res["scst"])
        # the standalone eval, then the eval at max_steps + scst_steps
        assert "scst step 2/2" in log and "step 7: CIDEr-D" in log
    else:
        with open(out / "cbs_captions.json") as f:
            cbs = json.load(f)
        assert cbs == res["cbs"] and cbs["n_images"] == cap.CBS_IMAGES
        assert f"cbs: {cbs['n_hits']}/{cbs['n_images']}" in log
        assert cbs["captions"]
        for c in cbs["captions"].values():
            if c["satisfied"]:
                assert c["hit"]


def test_scst_and_cbs_after_training(tmp_path):
    """The whole command: train, SCST (finite losses, the parameters
    moved), the eval after SCST, and constrained decoding that puts each
    image's tag into its caption."""
    out = tmp_path / "out"
    res = cap.main(["--output_dir", str(out), "--synthetic", "--tiny",
                    "--platform", "cpu", "--do_train", "--do_eval",
                    "--max_steps", "2", "--ckpt_period", "2",
                    "--train_batch_size", "8", "--num_workers", "0",
                    "--dtype", "float32", "--max_gen_length", "10", "--scst",
                    "--scst_steps", "2", "--scst_lr", "1e-3", "--use_cbs",
                    "--cbs_beams", "2"])
    assert len(res["train"]) == 2 and len(res["scst"]) == 2
    assert all(math.isfinite(h["loss"]) for h in res["scst"])
    log = open(out / "log.txt").read()
    assert "step 4: CIDEr-D" in log            # max_steps + scst_steps
    cbs = res["cbs"]
    assert cbs["n_hits"] == sum(c["hit"] for c in cbs["captions"].values())
    assert cbs["n_hits"] >= 1


def test_pipeline_staged_checkpoint_decodes_like_unstaged(trained, tmp_path):
    """A checkpoint whose config has pipeline stages decodes as a per-layer
    model (the JAX driver's unstacked copy), to the captions of the same
    weights without stages."""
    out, res, _ = trained
    ckpt = tmp_path / "ckpt"
    shutil.copytree(os.path.join(out, f"checkpoint-{STEPS:07d}"), ckpt)
    cfg = json.loads((ckpt / "config.json").read_text())
    cfg["pipeline_stages"] = 2
    (ckpt / "config.json").write_text(json.dumps(cfg))
    got = cap.main(["--output_dir", str(tmp_path / "out"),
                    "--model_name_or_path", str(ckpt), "--synthetic",
                    "--tiny", "--platform", "cpu", "--do_eval", "--dtype",
                    "float32", "--decode_mode", "cached"])
    assert got["captions"] == res["captions"]


def test_runs_on_cuda_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cap.main(["--output_dir", str(tmp_path / "out"), "--synthetic",
                  "--tiny", "--do_eval"])
