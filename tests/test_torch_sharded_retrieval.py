"""The port's corpus-scale coarse retrieval (`parallel/sharded_retrieval.py`)
against the JAX package's and the dense coarse stage, on the CPU.

- `streaming_topk` equals the JAX `streaming_topk` on the same inputs, ids
  exactly and scores within 1e-6, with ties at the k boundary (duplicate
  gallery rows) going to the lowest gallery index, at several blocks;
- `streaming_rank` equals the JAX `streaming_rank` on tie-free inputs;
- `sharded_coarse_eval` over 2 gloo ranks (query rows split) equals the
  dense `coarse_candidates` / `coarse_ranks` on tie-free inputs;
- `two_stage_scoring(coarse_block=...)` on the tiny retrieval model equals
  the dense path's candidates, coarse and fine R@K.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvp_pytorch_tpu.parallel import sharded_retrieval as jax_sr
from mvp_pytorch_tpu_torch.parallel.sharded_retrieval import (
    sharded_coarse_eval, streaming_rank, streaming_topk)
from mvp_pytorch_tpu_torch.tasks.retrieval import two_stage_scoring
from mvp_pytorch_tpu_torch.tasks.retrieval_eval import (coarse_candidates,
                                                        coarse_ranks)

import torch_ranks as tr
from test_torch_models import models, golden, synthetic_set  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    torch.set_num_threads(1)


def tied_inputs(seed=1, nq=9, ng=23, d=6):
    """Gallery rows 4..7 repeat rows 0..3, so scores tie across blocks and
    at the k boundary."""
    rs = np.random.RandomState(seed)
    g = rs.randn(ng, d).astype(np.float32)
    g[4:8] = g[0:4]
    g[15] = g[2]
    q = rs.randn(nq, d).astype(np.float32)
    return q, g


@pytest.mark.parametrize("k,block", [(3, 5), (6, 4), (8, 23), (5, 1)])
def test_streaming_topk_matches_jax(k, block):
    q, g = tied_inputs()
    wv, wi = jax_sr.streaming_topk(jnp.asarray(q), jnp.asarray(g), k=k,
                                   block=block)
    v, i = streaming_topk(torch.from_numpy(q), torch.from_numpy(g), k, block)
    np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
    np.testing.assert_allclose(v.numpy(), np.asarray(wv), atol=1e-6)


def test_ties_at_the_boundary_take_the_lowest_index():
    q = np.ones((1, 2), np.float32)
    g = np.ones((7, 2), np.float32)          # every score ties
    _, i = streaming_topk(torch.from_numpy(q), torch.from_numpy(g), 3, 2)
    np.testing.assert_array_equal(i.numpy(), [[0, 1, 2]])


@pytest.mark.parametrize("block", [4, 23])
def test_streaming_rank_matches_jax(block):
    # tie-free: a duplicate row's score can differ in the last bit between
    # two matmul shapes, and the rank counts strictly greater scores
    rs = np.random.RandomState(2)
    q = rs.randn(9, 6).astype(np.float32)
    g = rs.randn(23, 6).astype(np.float32)
    own = np.stack([np.arange(9), (np.arange(9) + 11) % 23], 1)
    want = jax_sr.streaming_rank(jnp.asarray(q), jnp.asarray(g),
                                 jnp.asarray(own, jnp.int32), block=block)
    got = streaming_rank(torch.from_numpy(q), torch.from_numpy(g),
                         torch.from_numpy(own), block)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("coarse"))
    torch.save({}, os.path.join(d, "setup.pt"))
    return tr.launch(["coarse"], d)["coarse"]


def test_two_rank_sharded_coarse_eval_equals_dense(ranks):
    img, txt, cpi = tr.coarse_inputs()
    sims = (img @ txt.T).numpy()
    i2t, t2i = coarse_candidates(sims, 5, 4)
    ri, rt = coarse_ranks(sims, cpi)
    for out in ranks:
        gi2t, gt2i, gri, grt = out["res"]
        np.testing.assert_array_equal(gi2t, i2t)
        np.testing.assert_array_equal(gt2i, t2i)
        np.testing.assert_array_equal(gri, ri)
        np.testing.assert_array_equal(grt, rt)


def test_one_rank_sharded_coarse_eval_equals_dense():
    img, txt, cpi = tr.coarse_inputs(seed=4)
    got = sharded_coarse_eval(img, txt, cpi, 4, 3, block=5)
    sims = (img @ txt.T).numpy()
    want = coarse_candidates(sims, 4, 3) + coarse_ranks(sims, cpi)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_two_stage_scoring_with_coarse_block_equals_dense(models):
    caps, imgs = synthetic_set()
    cpi = 3
    port, _, _, mt = models
    kw = dict(max_tag_length=mt)
    dense = two_stage_scoring(port, caps, imgs, cpi, 5, 3, 4, 7, **kw)
    block = two_stage_scoring(port, caps, imgs, cpi, 5, 3, 4, 7,
                              coarse_block=5, **kw)
    np.testing.assert_array_equal(block["i2t_cands"], dense["i2t_cands"])
    np.testing.assert_array_equal(block["t2i_cands"], dense["t2i_cands"])
    assert block["coarse"] == dense["coarse"]
    assert block["fine"] == dense["fine"]
