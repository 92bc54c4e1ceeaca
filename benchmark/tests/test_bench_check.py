"""The check against the plain reference, driven through the harness on the
program's CPU path at a tiny size: the reference agrees with a sound
program, and each fault a cell can have turns `correct` false under the
cell's own limits."""

import contextlib

import pytest
import torch

from benchmark.tests import tiny


@pytest.mark.parametrize("name", tiny.CELLS)
def test_reference_agrees_with_program(name):
    r = tiny.run(tiny.cell(name))
    assert r["correct"] is True
    for key, c in r["checks"].items():
        assert c["value"] < 1e-4, (key, c)


@contextlib.contextmanager
def patched(owner, attr, fn):
    orig = getattr(owner, attr)
    setattr(owner, attr, fn(orig))
    try:
        yield
    finally:
        setattr(owner, attr, orig)


def _still_step(orig):
    def step(self, grads=None):     # the state comes back unchanged
        self.count += 1
    return step


def _half_batch(orig):
    def step(self, batch):
        return orig(self, {k: v[:v.shape[0] // 2] for k, v in batch.items()})
    return step


TRAIN = ("mvptr-base.pretrain-b96", "oscar-base.pretrain-b96")


@pytest.mark.parametrize("name", TRAIN)
def test_unchanged_state_fails(name):
    from mvp_pytorch_tpu_torch.training.optim import AdamW
    with patched(AdamW, "step", _still_step):
        r = tiny.run(tiny.cell(name))
    assert r["correct"] is False
    assert r["checks"]["update_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", TRAIN)
def test_half_batch_fails(name):
    from mvp_pytorch_tpu_torch.training.trainer import Trainer
    with patched(Trainer, "_step", _half_batch):
        r = tiny.run(tiny.cell(name))
    assert r["correct"] is False


def _flip_scores(orig):
    def score(self, *args):         # one pair's answer altered
        logits = orig(self, *args).clone()
        logits[0] = logits[0].flip(0) * 3
        return logits
    return score


def _swap_candidate(orig):
    def topk(x, k, dim=-1, **kw):   # a shortlist altered where it is made
        out = orig(x, k, dim=dim, **kw)
        if x.dim() == 2 and x.dtype == torch.float32 and k > 1:
            idx = out.indices.clone()
            idx[:, 0] = torch.topk(-x, 1, dim=dim).indices[:, 0]
            return type(out)((out.values, idx))
        return out
    return topk


def test_altered_score_fails():
    from mvp_pytorch_tpu_torch.models.tasks import RetrievalModel
    c = tiny.cell("mvptr-base.score-flickr1k")
    c.traffic = {**c.traffic, "check_pairs": 10 ** 6}   # every pair
    with patched(RetrievalModel, "score_cached", _flip_scores):
        r = tiny.run(c)
    assert r["correct"] is False
    assert r["checks"]["score_gap"]["value"] > \
        r["checks"]["score_gap"]["limit"]


def test_altered_shortlist_fails():
    from mvp_pytorch_tpu_torch.tasks import retrieval
    c = tiny.cell("mvptr-base.score-flickr1k")
    with patched(retrieval.torch, "topk", _swap_candidate):
        r = tiny.run(c)
    assert r["correct"] is False
    assert r["checks"]["cand_gap"]["value"] > \
        r["checks"]["cand_gap"]["limit"]
