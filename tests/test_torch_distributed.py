"""The port's data parallelism on 2 gloo ranks against one rank and the JAX
package, in fp32 on the CPU.

- Two Trainer steps of the tiny retrieval model (the golden fixture's
  weights) under plain DDP, DDP with ZeRO-2 (the AdamW moments sharded) and
  FSDP (the parameters sharded too), each rank on its half of the global
  batch with `hn_dice` pinned, equal the one-rank steps on the whole batch:
  losses within 1e-5, the global gradient norm within 1e-5 relative, every
  parameter after the steps within 1e-5 relative (atol 1e-6: the key
  biases, whose gradient is zero up to rounding, move by Adam's noise);
- the same global batch's loss and averaged gradients equal the JAX
  package's single-device `train_step` (loss 2e-4; gradients atol 2e-4,
  rtol 1e-3, as tests/test_torch_train.py holds the one-rank step): the
  contrastive matrix and the hard negatives span both ranks' rows;
- two steps of the tiny pretraining model (WRA 'hard' and 'sample', QA
  pairs, MLM labels that count differently on each rank) equal the
  one-rank steps: the masked means divide by the global count and WRA's
  negative spans come from the global batch (`GlobalBatch`);
- two data ranks draw different dropout masks;
- the eval shards and their gather equal the JAX package's
  `sequential_shards` / `unpad_concat`; `EvalSharder` splits a batch's rows
  over the data ranks and gathers the outputs in rank order; `BatchSampler`'s rank shard equals
  `shard_batch`'s rows;
- the loader needs a device.

The ranks start through the port's launcher (`tests/torch_ranks.py`), with a
60 s deadline.
"""

import json
import os

import numpy as np
import pytest
import torch

from mvp_pytorch_tpu.parallel import collectives as jax_coll
from mvp_pytorch_tpu_torch.convert import jax_params_to_state_dict
from mvp_pytorch_tpu_torch.data.loader import BatchSampler, ProcessLoader
from mvp_pytorch_tpu_torch.models import ModelConfig
from mvp_pytorch_tpu_torch.parallel.collectives import (sequential_shards,
                                                        unpad_concat)
from mvp_pytorch_tpu_torch.parallel.mesh import shard_batch

import torch_ranks as tr
from test_torch_models import FIX, retrieval_params, unflatten
from test_torch_train import GRAD, LOSS_TOL, jax_train_step
from test_torch_train import make_batch as train_batch

TOL = 1e-5
MODES = ("ddp", "zero2", "fsdp")


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    params = unflatten(dict(np.load(os.path.join(FIX, "params.npz"))))
    with open(os.path.join(FIX, "config.json")) as f:
        cfg_kw = json.load(f)
    mt = cfg_kw.pop("max_tag_length")
    full = retrieval_params(params)
    d = str(tmp_path_factory.mktemp("dp"))
    setup = dict(cfg=cfg_kw, weights=jax_params_to_state_dict(full), mt=mt,
                 seed=3, dice=tr.DICE, dir=d)
    torch.save(setup, os.path.join(d, "setup.pt"))
    return setup, full


@pytest.fixture(scope="module")
def ranks(setup):
    return tr.launch(["dp", "grads", "dropout", "eval", "pretrain"],
                     setup[0]["dir"])


@pytest.fixture(scope="module")
def one_rank(setup):
    return tr.one_rank_step(setup[0], tr.make_batch(setup[0]["mt"], 3),
                            steps=2)


@pytest.mark.parametrize("mode", MODES)
def test_two_rank_step_equals_one_rank(ranks, one_rank, mode):
    hist, state = one_rank
    for out in ranks["dp"]:
        rhist, rstate = out[mode]["hist"], out[mode]["state"]
        assert len(rhist) == 2
        for a, b in zip(rhist, hist):
            for k in ("loss", "clip", "itm"):
                assert abs(a[k] - b[k]) <= TOL, (k, a[k], b[k])
        assert set(rstate) == set(state)
        for k, v in state.items():
            np.testing.assert_allclose(rstate[k].numpy(), v.numpy(),
                                       rtol=TOL, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("mode", MODES)
def test_global_grad_norm_is_equal(ranks, one_rank, mode):
    hist, _ = one_rank
    for out in ranks["dp"]:
        for a, b in zip(out[mode]["hist"], hist):
            assert abs(a["grad_norm"] - b["grad_norm"]) <= TOL * b["grad_norm"]


@pytest.mark.parametrize("phrase_mod", ["hard", "sample"])
def test_two_rank_pretrain_step_equals_one_rank(ranks, phrase_mod):
    """The masked means (MLM, tag MLM, QA pairs) divide by the global
    count and WRA reads its negatives' spans from the global batch: every
    term of the 2-rank pretraining step equals the 1-rank step's."""
    hist, state = tr.pretrain_step(tr.pretrain_batch(), phrase_mod)
    for out in ranks["pretrain"]:
        rhist, rstate = out[phrase_mod]
        for a, b in zip(rhist, hist):
            for k in ("loss", "mlm", "vis_mlm", "clip", "itm", "wra", "qa"):
                assert abs(a[k] - b[k]) <= TOL, (k, a[k], b[k])
        for k, v in state.items():
            np.testing.assert_allclose(rstate[k].numpy(), v.numpy(),
                                       rtol=TOL, atol=1e-6, err_msg=k)


def test_zero2_shards_the_moments_and_fsdp_the_parameters(ranks, setup):
    state = setup[0]["weights"]
    moments = ranks["dp"][0]["zero2"]["moments"]
    at_rest = ranks["dp"][0]["fsdp"]["at_rest"]
    for k, shape in moments.items():
        divisible = any(d % 2 == 0 for d in state[k].shape)
        # every leaf with an even dimension is halved; the rest stay whole
        want = state[k].numel() // (2 if divisible else 1)
        assert int(np.prod(shape)) == want, k
        assert at_rest[k] == (0 if divisible else state[k].numel()), k


def test_batches_agree_with_the_jax_tests(setup):
    mt = setup[0]["mt"]
    a, b = tr.make_batch(mt, 3), train_batch(mt, 3)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_two_rank_step_equals_jax(ranks, setup, monkeypatch):
    s, full = setup
    cfg = {**s["cfg"]}
    from mvp_pytorch_tpu.models import ModelConfig as JaxConfig
    jout, jgrads = jax_train_step(JaxConfig(**cfg), full,
                                  tr.make_batch(s["mt"], 3), s["mt"], {},
                                  monkeypatch)
    for out in ranks["grads"]:
        assert abs(out["loss"] - float(jout.total_loss)) <= LOSS_TOL
        assert set(out["grads"]) == set(jgrads)
        for name, g in out["grads"].items():
            np.testing.assert_allclose(g.numpy(), jgrads[name].numpy(),
                                       **GRAD, err_msg=name)


def test_data_ranks_draw_different_dropout_masks(ranks):
    a, b = (r["mask"] for r in ranks["dropout"])
    assert ranks["dropout"][0]["seed"] != ranks["dropout"][1]["seed"]
    assert not torch.equal(a, b)
    # data rank 0 keeps the one-process stream
    assert ranks["dropout"][0]["seed"] == tr.Trainer.seed_of(
        type("T", (), {"seed": 0, "mesh": None})(), 0, 0)


@pytest.mark.parametrize("total,world", [(7, 2), (8, 2), (5, 3), (1, 2)])
def test_sequential_shards_match_jax(total, world):
    got, n = sequential_shards(total, world)
    want, wn = jax_coll.sequential_shards(total, world)
    np.testing.assert_array_equal(got, want)
    assert n == wn
    np.testing.assert_array_equal(unpad_concat(got, n),
                                  jax_coll.unpad_concat(want, wn))


def test_eval_gather_matches_jax(ranks):
    shards, _ = jax_coll.sequential_shards(7, 2)
    for rank, out in enumerate(ranks["eval"]):
        np.testing.assert_array_equal(out["idx"], shards[rank])
        ids, halves = out["gathered"]
        np.testing.assert_array_equal(ids, np.arange(7) * 10)
        np.testing.assert_array_equal(halves, np.arange(7)[:, None] * 1.5)


def test_eval_sharder_splits_and_gathers_rows(ranks):
    for rank, out in enumerate(ranks["eval"]):
        active, rows, gathered = out["sharder"]
        assert active
        np.testing.assert_array_equal(
            rows.numpy(), np.arange(8).reshape(4, 2)[2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(gathered.numpy(),
                                      np.arange(8).reshape(4, 2) * 2)


def test_sampler_shard_equals_shard_batch():
    """Each data rank's loader rows are its `shard_batch` rows of the
    global batch."""
    class M:
        data_rank, data_size = 1, 2
    glob = BatchSampler(50, 8, seed=3)
    mine = BatchSampler(50, 8, seed=3, rank=1, world_size=2)
    for step in (0, 5, 7):
        rows = shard_batch(M, {"i": glob.batch_at(step)})["i"]
        np.testing.assert_array_equal(mine.batch_at(step), rows)


def test_loader_needs_a_device():
    with pytest.raises(TypeError, match="device"):
        ProcessLoader(lambda idx: {}, BatchSampler(8, 4), num_workers=1)
