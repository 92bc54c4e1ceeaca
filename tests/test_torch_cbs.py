"""The port's constrained beam search (`models/cbs.py`) and the captioning
driver's `cbs_decode_demo` against the JAX package's, on the CPU.

- `build_fsm`: the arrays equal, the KMP chain-restart arcs of
  `tests/test_cbs.py` included;
- `top_k_lower_index`: `lax.top_k`'s values and indices on rows full of
  ties;
- `constrained_beam_search` over a fixed random logit table (a bigram
  table per batch row, as `tests/test_cbs.py` scripts its logits), one and
  two constraints, one- and multi-token: live-slot log-probs within 1e-5
  and live-slot sequences equal (a dead slot, at a multiple of NEG_INF, may
  hold any token);
- `select_best_beam_with_constraints` (dead beams, the per-item fallback,
  random cases), `ConstraintFilter` and `constraints_from_features`: equal
  outputs;
- `cbs_decode_demo` on a tiny fp32 `CaptioningModel` with the JAX model's
  weights: the same hits and best sequences as the JAX driver's (its best
  sequences captured from its `select_best_beam_with_constraints`).
"""

import dataclasses
import json
import logging
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvp_pytorch_tpu.data.datasets import FeatureStore as JaxFeatureStore
from mvp_pytorch_tpu.data.synthetic import make_synthetic_root
from mvp_pytorch_tpu.data.tokenization import FastBertTokenizer as JaxTok
from mvp_pytorch_tpu.models import cbs as jcbs
from mvp_pytorch_tpu.models import img_bert as jib
from mvp_pytorch_tpu.models import tiny_config as jax_tiny_config
from mvp_pytorch_tpu.tasks import captioning as jcap
from mvp_pytorch_tpu_torch.convert import load_jax_params
from mvp_pytorch_tpu_torch.data.datasets import FeatureStore
from mvp_pytorch_tpu_torch.data.tokenization import FastBertTokenizer
from mvp_pytorch_tpu_torch.models import ModelConfig
from mvp_pytorch_tpu_torch.models import cbs as pcbs
from mvp_pytorch_tpu_torch.models.img_bert import CaptioningModel
from mvp_pytorch_tpu_torch.tasks import captioning as pcap

V, L = 12, 7
BOS, EOS, PAD, MASK = 2, 3, 0, 4
TOL = 1e-5
GEN_LEN = 8
CONSTRAINTS = {"one": [[7]], "two": [[7], [8]], "chain": [[7, 9]],
               "chain_and_one": [[7, 9], [8]], "repeat": [[7, 7, 9]]}


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    """torch single-threaded in this process: no intra-op thread pool is left
    behind for a later test in the same worker that forks."""
    torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# the FSM and the top-k
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CONSTRAINTS))
def test_build_fsm_matches_jax(case):
    cons = CONSTRAINTS[case]
    s = 12
    want = jcbs.build_fsm(cons, V, max_states=s)
    got = pcbs.build_fsm(cons, V, max_states=s)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_fsm_chain_restart_arcs():
    """'new new york' satisfies [new, york]: failing a chain on its own
    start token re-enters the chain; an unrelated token falls back."""
    fsm, nsat = pcbs.build_fsm([[5, 6]], vocab_size=10, max_states=3)
    s = 0
    for tok in [5, 5, 6]:
        s = int(np.argmax(fsm[s, :, tok]))
    assert nsat[s] == 1
    s = int(np.argmax(fsm[0, :, 5]))
    assert int(np.argmax(fsm[s, :, 7])) == 0
    with pytest.raises(ValueError, match="max_states"):
        pcbs.build_fsm([[5, 6], [7, 8]], 10, max_states=4)


@pytest.mark.parametrize("k", [1, 3, 8])
def test_top_k_lower_index_matches_lax(k):
    rs = np.random.RandomState(k)
    x = rs.randint(-3, 3, (5, 40)).astype(np.float32)
    x[1] = -1e9                                # every value tied
    x[2, :10] = 2.0                            # ties at the top
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
    got_v, got_i = pcbs.top_k_lower_index(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------

def logit_table(b, seed=0):
    """[b, L, V, V]: row n of batch item i at position t takes
    table[i, t, its token at t - 1]."""
    rs = np.random.RandomState(seed)
    w = rs.randn(b, L, V, V).astype(np.float32) * 1.5
    w[..., BOS] -= 6.0
    w[..., MASK] -= 6.0
    w[..., EOS] -= 1.0
    return w


def run_both(cons_per_item, beams, seed=0):
    b = len(cons_per_item)
    s = max(len(c) for c in cons_per_item)
    s = max(2 ** s + 4, 4)
    fsms = np.stack([jcbs.build_fsm(c, V, max_states=s)[0]
                     for c in cons_per_item])
    table = logit_table(b, seed)
    rows = s * beams

    def jax_logits(tokens):
        n = tokens.shape[0]
        item = jnp.arange(n) // rows
        prev = jnp.concatenate([tokens[:, :1], tokens[:, :-1]], axis=1)
        return jnp.asarray(table)[item[:, None], jnp.arange(L)[None], prev]

    def port_logits(tokens, t):
        item = torch.arange(tokens.shape[0]) // rows
        return torch.from_numpy(table)[item, t, tokens[:, t - 1]]

    jseq, jlp = jcbs.constrained_beam_search(
        jax_logits, jnp.asarray(fsms), BOS, EOS, PAD, MASK, L, beams)
    pseq, plp = pcbs.constrained_beam_search(
        port_logits, fsms, BOS, EOS, PAD, MASK, L, beams, device="cpu")
    return (np.asarray(jseq), np.asarray(jlp), pseq.numpy(), plp.numpy(),
            fsms)


@pytest.mark.parametrize("case,beams", [("one", 2), ("two", 3),
                                        ("chain", 2), ("chain_and_one", 2),
                                        ("repeat", 3)])
def test_constrained_beam_search_matches_jax(case, beams):
    cons = CONSTRAINTS[case]
    jseq, jlp, pseq, plp, _ = run_both([cons, cons], beams, seed=len(case))
    live = jlp > pcbs.NEG_INF / 2
    np.testing.assert_array_equal(plp > pcbs.NEG_INF / 2, live)
    assert live.sum() > 2 * beams               # more than state 0 lives
    np.testing.assert_allclose(plp[live], jlp[live], atol=TOL, rtol=0)
    np.testing.assert_array_equal(pseq[live], jseq[live])


def test_constrained_beam_search_items_keep_their_fsms():
    """Two items with different constraints in one batch; the selection
    equal to JAX's, every satisfied state's best beam holding its
    constraints' tokens."""
    jseq, jlp, pseq, plp, fsms = run_both(
        [CONSTRAINTS["two"], CONSTRAINTS["chain"]], 2, seed=5)
    live = jlp > pcbs.NEG_INF / 2
    np.testing.assert_allclose(plp[live], jlp[live], atol=TOL, rtol=0)
    np.testing.assert_array_equal(pseq[live], jseq[live])
    for item, cons in enumerate((CONSTRAINTS["two"], CONSTRAINTS["chain"])):
        nsat = jcbs.build_fsm(cons, V, max_states=fsms.shape[1])[1]
        want = jcbs.select_best_beam_with_constraints(
            jseq[item:item + 1], jlp[item:item + 1], nsat, len(cons),
            (EOS,), PAD)
        got = pcbs.select_best_beam_with_constraints(
            pseq[item:item + 1], plp[item:item + 1], nsat, len(cons),
            (EOS,), PAD)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], atol=TOL)
        for words in cons:
            assert all(w in got[0][0] for w in words), (got[0], cons)


def test_finished_beam_keeps_its_score():
    """A beam that emits EOS keeps its score and state through the PAD
    self-loop: its log-prob stops changing and PAD fills its tail."""
    table = np.full((1, L, V, V), -4.0, np.float32)
    table[0, 1, :, 7] = 6.0
    table[0, 2, :, EOS] = 6.0
    table[0, 3:, :, 5] = -1.0

    def port_logits(tokens, t):
        return torch.from_numpy(table)[0, t, tokens[:, t - 1]]
    fsm, nsat = pcbs.build_fsm([[7]], V, max_states=2)
    seqs, lp = pcbs.constrained_beam_search(
        port_logits, fsm[None], BOS, EOS, PAD, MASK, L, 2, device="cpu")
    best, score = pcbs.select_best_beam_with_constraints(
        seqs.numpy(), lp.numpy(), nsat, 1, (EOS,), PAD)
    np.testing.assert_array_equal(best[0][:3], [BOS, 7, EOS])
    assert (best[0][3:] == PAD).all()
    logp = torch.log_softmax(torch.from_numpy(table[0, 1:3, 0]), -1)
    expect = (logp[0, 7] + logp[1, EOS]).item() / 2
    np.testing.assert_allclose(score[0], expect, atol=TOL)


# ---------------------------------------------------------------------------
# the host helpers
# ---------------------------------------------------------------------------

def test_select_best_dead_beams_and_per_item_fallback():
    seqs = np.arange(2 * 2 * 2 * 3).reshape(2, 2, 2, 3)
    logp = np.full((2, 2, 2), -1e9)
    nsat = np.array([0, 1])
    logp[0, 1, 0] = -1.0
    logp[0, 0, 0] = -0.5
    logp[1, 0, 0] = -0.3
    got = pcbs.select_best_beam_with_constraints(seqs, logp, nsat, 1)
    want = jcbs.select_best_beam_with_constraints(seqs, logp, nsat, 1)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0][0], seqs[0, 1, 0])
    np.testing.assert_array_equal(got[0][1], seqs[1, 0, 0])
    np.testing.assert_allclose(got[1], [-1.0 / 3, -0.3 / 3])


@pytest.mark.parametrize("seed", range(4))
def test_select_best_matches_jax_on_random_beams(seed):
    rs = np.random.RandomState(seed)
    b, s, k, l = 3, 4, 2, 6
    seqs = rs.randint(0, V, (b, s, k, l))
    logp = rs.randn(b, s, k) * 3 - 5
    logp[rs.rand(b, s, k) < 0.4] = -1e9
    nsat = np.array([0, 1, 1, 2])
    for mc in (0, 1, 2):
        got = pcbs.select_best_beam_with_constraints(seqs, logp, nsat, mc,
                                                     (EOS,), PAD)
        want = jcbs.select_best_beam_with_constraints(seqs, logp, nsat, mc,
                                                      (EOS,), PAD)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_synthetic_root(str(tmp_path_factory.mktemp("cbs_root")))


def test_constraint_filter_matches_jax(root):
    ptok, jtok = FastBertTokenizer(root["vocab"]), JaxTok(root["vocab"])
    names = ["Man", "dog", "tree", "ball", "Kitchen & Dining Room Table",
             "sky holds red", "person", "dog", "grass"]
    scores = [0.9, 0.8, 0.7, 0.0, 0.95, 0.6, 0.99, 0.5, 0.3]
    for kw in ({}, {"scores": scores}, {"max_constraints": 1},
               {"max_constraints": 5, "scores": scores}):
        for words in (3, 1):
            got = pcbs.ConstraintFilter(ptok, words)(names, **kw)
            want = jcbs.ConstraintFilter(jtok, words)(names, **kw)
            assert got == want, (kw, words)
        assert (pcbs.ConstraintFilter(ptok).filter_names(names, **kw)
                == jcbs.ConstraintFilter(jtok).filter_names(names, **kw))
    pstore, jstore = FeatureStore(root["features"]), JaxFeatureStore(
        root["features"])
    for img in ("img_0000", "img_0003"):
        assert (pcbs.constraints_from_features(
            pstore, img, ptok, pcbs.ConstraintFilter(ptok))
            == jcbs.constraints_from_features(
                jstore, img, jtok, jcbs.ConstraintFilter(jtok)))


# ---------------------------------------------------------------------------
# the captioning driver's demo
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def demo(root, tmp_path_factory):
    """The JAX driver's `cbs_decode_demo` on a tiny fp32 model, with its
    hits (from the log) and best sequences (captured); the port's model
    with the same weights and the port's dataset."""
    jtok = JaxTok(root["vocab"])
    jcfg = jax_tiny_config(vocab_size=len(jtok.vocab) + 20,
                           only_word_size=len(jtok.vocab),
                           img_feature_dim=2054)
    kw = dict(max_cap=12, max_tag=6, max_img=4)
    jds = jcap.CaptionDataset(root["captions"],
                              JaxFeatureStore(root["features"]), jtok, **kw)
    model = jib.CaptioningModel(jcfg)
    ids_b, ctx_mask, feats = (jnp.asarray(x[None]) for x in
                              jds.context("img_0000"))
    params = jax.jit(lambda: model.init(
        jax.random.PRNGKey(4), jnp.zeros((1, GEN_LEN), jnp.int32), ids_b,
        ctx_mask, jnp.zeros((1, GEN_LEN), jnp.int32),
        jnp.ones_like(ids_b), feats, deterministic=True))()["params"]
    best = []
    real_select = jcbs.select_best_beam_with_constraints

    def capture(*a, **k):
        out = real_select(*a, **k)
        best.append(out[0][0].tolist())
        return out
    records = []

    class Grab(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())
    log = logging.getLogger("test_torch_cbs.jax_demo")
    log.addHandler(Grab())
    log.setLevel(logging.INFO)
    args = types.SimpleNamespace(cbs_beams=2)
    jcbs.select_best_beam_with_constraints = capture
    try:
        jcap.cbs_decode_demo(args, model, params, jds, jtok, GEN_LEN, log)
    finally:
        jcbs.select_best_beam_with_constraints = real_select
    hits = [m for m in records if m.startswith("cbs:")]
    pmodel = CaptioningModel(
        ModelConfig.from_dict(dataclasses.asdict(jcfg)), device="cpu")
    load_jax_params(pmodel, jax.tree_util.tree_map(np.asarray, params))
    pds = pcap.CaptionDataset(root["captions"], FeatureStore(root["features"]),
                              FastBertTokenizer(root["vocab"]), **kw)
    return dict(hits=hits, best=best, pmodel=pmodel, pds=pds,
                out=str(tmp_path_factory.mktemp("cbs_demo")))


def test_cbs_decode_demo_matches_jax(demo):
    args = types.SimpleNamespace(cbs_beams=2, max_gen_length=GEN_LEN,
                                 output_dir=demo["out"])
    got = pcap.cbs_decode_demo(args, demo["pmodel"], demo["pds"],
                               demo["pds"].tok, logging.getLogger("cbs"))
    assert len(demo["hits"]) == 1
    assert demo["hits"][0] == (f"cbs: {got['n_hits']}/{got['n_images']} "
                               f"captions contain the constraint tag")
    seqs = [c["sequence"] for c in got["captions"].values()]
    assert seqs == demo["best"]
    assert len(seqs) >= 2
    with open(f"{demo['out']}/cbs_captions.json") as f:
        assert json.load(f) == got
    for c in got["captions"].values():
        assert c["hit"] == (demo["pds"].tok.vocab[c["constraint"]]
                            in c["sequence"])
