"""The port's pretraining model (`BiPretrainModel`), its heads, its converter
paths and its task against the JAX package and the golden fixture, in fp32
on the CPU.

- `BiPretrainModel.train_step`: all seven loss outputs (total, tag MLM,
  CLIP, text MLM, ITM, QA, WRA) within 2e-4 and every parameter's gradient
  (the word table's three contributions, the gather and both tied heads,
  included) within atol 2e-4, rtol 1e-3 of `jax.value_and_grad` of the JAX
  model, as tests/test_torch_train.py holds the retrieval step; WRA in its
  'sample' mode at the output and its 'hard' mode at fusion layer 2, with
  `qa_ans` and `qa_is_next` holding -1 rows, and `hn_dice`, the WRA pick and
  the WRA negative pinned on both sides;
- the LM heads against the golden oracle of the torch reference
  (`mlm_scores`, `half_scores`; atol 2e-4, rtol 1e-3; numpy only);
- the strict load of JAX trees with and without `qa_head` and
  `qa_seq_relation`, and of a reference-style state dict with the tied
  decoder copies;
- 3 `Trainer` steps of `pretrain_loss_fn` against the JAX task's
  `forward` + `loss_fn` under the JAX `Trainer`: losses and metrics within
  5e-4 at every step, the gradient norm within 1e-3 relative;
- one step at the config's dropouts 0.1 / 0.1: finite, and the same again
  from the same generator seed (JAX's dropout masks come from another
  random stream and are never compared).

Parameters: the golden fixture's tree (the torch reference's tiny
pretraining model), with a third and fourth layer per encoder and the
`qa_seq_relation` head made from a numpy seed. The JAX results are computed
once per module under `jax.jit`.
"""

import copy
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvp_pytorch_tpu.convert import export_state_dict
from mvp_pytorch_tpu.models import ModelConfig as JaxConfig
from mvp_pytorch_tpu.models import pretrain as jax_pretrain
from mvp_pytorch_tpu.training import optim as jax_optim
from mvp_pytorch_tpu_torch.convert import (jax_params_to_state_dict,
                                           load_jax_params)
from mvp_pytorch_tpu_torch.models import BiPretrainModel, ModelConfig
from mvp_pytorch_tpu_torch.models.heads import LMPredictionHead
from mvp_pytorch_tpu_torch.tasks.pretrain import (PRETRAIN_KEYS,
                                                  pretrain_loss_fn,
                                                  train_pretrain)
from mvp_pytorch_tpu_torch.training.optim import make_optimizer
from mvp_pytorch_tpu_torch.training.trainer import Trainer

from test_torch_models import FIX, unflatten

LOSS_TOL = 2e-4
GRAD = dict(atol=2e-4, rtol=1e-3)
B, LA, R = 6, 9, 5
LAYERS = 4                 # per encoder: fusion layer 2 is a middle layer
DICE = np.array([3, 0, 5, 1, 4, 2])
WRA_PICK, NEG_OFFSET = 1, 2
STEP_KW = dict(max_pred_a=4, max_pred_b=2, wra_phrase_width=4)
LOSSES = ("total_loss", "vis_mlm_loss", "retrieval_loss", "masked_lm_loss",
          "itm_loss", "qa_loss", "wra_loss")


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    """torch single-threaded in this process: no intra-op thread pool is left
    behind for a later test in the same worker that forks."""
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def golden():
    params = unflatten(dict(np.load(os.path.join(FIX, "params.npz"))))
    expected = dict(np.load(os.path.join(FIX, "expected.npz")))
    with open(os.path.join(FIX, "config.json")) as f:
        cfg_kw = json.load(f)
    mt = cfg_kw.pop("max_tag_length")
    return params, cfg_kw, mt, expected


def pretrain_tree(golden_params, *, qa_head=True, qa_pairs=False):
    """The golden pretraining tree with LAYERS layers per encoder (the
    extra ones are the first ones plus seeded noise), and optionally
    without `qa_head` or with a seeded `qa_seq_relation`."""
    tree = copy.deepcopy(golden_params)
    r = np.random.RandomState(17)
    for enc in ("txt_encoder", "vis_encoder", "mul_encoder"):
        layers = tree["bert"][enc]
        for i in range(2, LAYERS):
            layers[f"layer_{i}"] = jax.tree_util.tree_map(
                lambda v: (v + 0.05 * r.randn(*v.shape)).astype(np.float32),
                layers[f"layer_{i - 2}"])
    if not qa_head:
        del tree["qa_head"]
    if qa_pairs:
        h = tree["bert"]["pooler"]["dense"]["kernel"].shape[0]
        tree["qa_seq_relation"] = {
            "kernel": (0.3 * r.randn(h, 2)).astype(np.float32),
            "bias": (0.1 * r.randn(2)).astype(np.float32)}
    return tree


def config_kw(cfg_kw, **over):
    return {**cfg_kw, "num_hidden_layers": 2 * LAYERS, **over}


def make_batch(mt, seed, b=B, qa=True):
    """Continuous, padded inputs (no argmax ties in the hard mining), MLM
    labels on a few text and tag positions, phrase spans with one empty, and
    QA labels with -1 rows."""
    rs = np.random.RandomState(seed)
    ma = np.ones((b, LA), np.int64)
    ma[1::2, LA - 2:] = 0
    mb = np.ones((b, mt + R), np.int64)
    mb[1, mt + R - 2:] = 0
    la_lab = np.full((b, LA), -1, np.int64)
    la_lab[:, 1:4] = rs.randint(0, 99, (b, 3))
    la_lab[2, 1] = -1
    lb_lab = np.full((b, mt + R), -1, np.int64)
    lb_lab[:, 1:3] = rs.randint(0, 99, (b, 2))
    start = rs.randint(1, 4, b)
    phrase = np.stack([start, start + rs.randint(1, 4, b)], 1)
    phrase[2] = [3, 3]                                # an empty phrase span
    batch = dict(
        input_ids_a=rs.randint(1, 99, (b, LA)), attention_mask_a=ma,
        token_type_ids_a=np.zeros((b, LA), np.int64), lm_label_ids_a=la_lab,
        input_ids_b=rs.randint(1, 99, (b, mt)), attention_mask_b=mb,
        token_type_ids_b=np.ones((b, mt), np.int64), lm_label_ids_b=lb_lab,
        img_feats=rs.randn(b, R, 22).astype(np.float32),
        phrase_index=phrase,
        image_index=np.stack([np.full(b, LA), np.full(b, LA + R)], 1))
    if qa:
        batch["qa_ans"] = rs.randint(0, 7, b)
        batch["qa_ans"][1] = -1
        batch["qa_is_next"] = rs.randint(0, 2, b)
        batch["qa_is_next"][[0, 3]] = -1
    return batch


def pin_jax_wra(monkeypatch):
    """The JAX model's WRA pick and negative pinned as the port's are."""
    monkeypatch.setattr(jax_pretrain, "wra_sample_loss", functools.partial(
        jax_pretrain.wra_sample_loss, pick=WRA_PICK, neg_offset=NEG_OFFSET))
    monkeypatch.setattr(jax_pretrain, "wra_hard_loss", functools.partial(
        jax_pretrain.wra_hard_loss, pick=WRA_PICK))


def torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# case -> train_step kwargs
CASES = {
    "sample_out": dict(phrase_mod="sample", phrase_layer=None),
    "hard_mid": dict(phrase_mod="hard", phrase_layer=2),
}


@pytest.fixture(scope="module")
def step_results(golden):
    """Each case's outputs and gradients on both sides, computed once."""
    params, cfg_kw, mt, _ = golden
    tree = pretrain_tree(params, qa_pairs=True)
    batch = make_batch(mt, seed=3)
    res = {}
    with pytest.MonkeyPatch.context() as mp:
        pin_jax_wra(mp)
        for case, kw in CASES.items():
            jm = jax_pretrain.BiPretrainModel(JaxConfig(**config_kw(cfg_kw)))

            def loss(p, kw=kw):
                out = jm.apply({"params": p},
                               *(jnp.asarray(batch[k]) for k in PRETRAIN_KEYS),
                               max_tag_length=mt, hn_mod="hard",
                               hn_dice=jnp.asarray(DICE), deterministic=True,
                               rngs={"wra": jax.random.PRNGKey(0)},
                               **STEP_KW, **kw)
                return out.total_loss, out
            (_, jout), jgrads = jax.jit(jax.value_and_grad(
                loss, has_aux=True))(jax.tree_util.tree_map(jnp.asarray, tree))
            jgrads = jax_params_to_state_dict(
                jax.tree_util.tree_map(np.array, jgrads))

            port = BiPretrainModel(ModelConfig(**config_kw(cfg_kw)),
                                   qa_pairs=True, device="cpu")
            load_jax_params(port, tree)
            port.train()
            tb = torch_batch(batch)
            pout = port(*(tb[k] for k in PRETRAIN_KEYS), max_tag_length=mt,
                        hn_dice=torch.from_numpy(DICE), wra_pick=WRA_PICK,
                        wra_neg_offset=NEG_OFFSET, **STEP_KW, **kw)
            pout.total_loss.backward()
            pgrads = {n: torch.zeros_like(p) if p.grad is None
                      else p.grad.clone() for n, p in port.named_parameters()}
            res[case] = (jout, pout, jgrads, pgrads)
    return res


@pytest.mark.parametrize("case", list(CASES))
def test_pretrain_losses_match_jax(step_results, case):
    jout, pout, _, _ = step_results[case]
    for name in LOSSES:
        got, want = getattr(pout, name), getattr(jout, name)
        assert got is not None and want is not None, name
        assert abs(got.item() - float(want)) <= LOSS_TOL, (
            name, got.item(), float(want))
    np.testing.assert_allclose(pout.sim_mat.detach().numpy(),
                               np.asarray(jout.sim_mat), atol=LOSS_TOL)
    # the parts add up to the total
    parts = sum(getattr(pout, n).item() for n in LOSSES[1:])
    assert abs(parts - pout.total_loss.item()) <= 1e-5


@pytest.mark.parametrize("case", list(CASES))
def test_pretrain_grads_match_jax(step_results, case):
    _, _, jgrads, pgrads = step_results[case]
    assert set(pgrads) == set(jgrads)
    for name, g in pgrads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[name].numpy(), **GRAD,
                                   err_msg=name)
    for name in ("bert.embeddings.word_embeddings.weight",
                 "cls.predictions.transform.dense.weight",
                 "half_mlm.transform.dense.weight", "half_mlm.bias",
                 "cls.seq_relationship.weight", "qa_head.weight",
                 "qa_seq_relation.weight", "logit_scale",
                 "bert.mul_encoder.layer.0.attention.self.query.weight"):
        assert float(pgrads[name].abs().max()) > 0, name
    # the heads read only the first only_word_size rows, and the batch has
    # no phrase ids: the phrase rows get no gradient
    table = pgrads["bert.embeddings.word_embeddings.weight"]
    assert float(table[:99].abs().max()) > 0
    assert float(table[99:].abs().max()) == 0


def test_lm_heads_match_golden_oracle(golden):
    """The port's tied LM heads on the reference model's params and hidden
    states give the torch reference's logits (numpy and torch only)."""
    params, cfg_kw, _, exp = golden
    cfg = ModelConfig(**cfg_kw)
    table = torch.from_numpy(
        params["bert"]["embeddings"]["word_embeddings"]["embedding"])
    hidden = torch.from_numpy(exp["mlm_hidden"])
    for head_name, key in (("cls_predictions", "mlm_scores"),
                           ("half_mlm", "half_scores")):
        head = LMPredictionHead(cfg)
        sub = jax_params_to_state_dict({"cls_predictions":
                                        params[head_name]})
        head.load_state_dict({k[len("cls.predictions."):]: v
                              for k, v in sub.items()}, strict=True)
        with torch.no_grad():
            got = head(hidden, table)
        assert got.dtype == torch.float32 and got.shape[-1] == 99
        np.testing.assert_allclose(got.numpy(), exp[key], atol=2e-4,
                                   rtol=1e-3, err_msg=key)


@pytest.mark.parametrize("qa_head,qa_pairs", [(True, False), (True, True),
                                              (False, False), (False, True)])
def test_jax_trees_load_strictly(golden, qa_head, qa_pairs):
    """Trees with and without the lazily created QA heads load into the
    model built to match, and into no other."""
    params, cfg_kw, _, _ = golden
    tree = pretrain_tree(params, qa_head=qa_head, qa_pairs=qa_pairs)
    kw = config_kw(cfg_kw, qa_answer_size=7 if qa_head else 0)
    model = load_jax_params(
        BiPretrainModel(ModelConfig(**kw), qa_pairs=qa_pairs, device="cpu"),
        tree)
    sd = model.state_dict()
    assert ("qa_head.weight" in sd) == qa_head
    assert ("qa_seq_relation.weight" in sd) == qa_pairs
    np.testing.assert_array_equal(
        sd["cls.predictions.transform.dense.weight"].numpy(),
        tree["cls_predictions"]["transform"]["dense"]["kernel"].T)
    np.testing.assert_array_equal(sd["half_mlm.bias"].numpy(),
                                  tree["half_mlm"]["bias"])
    np.testing.assert_array_equal(
        sd["cls.seq_relationship.weight"].numpy(),
        tree["cls_seq_relationship"]["seq_relationship"]["kernel"].T)
    if qa_pairs:
        np.testing.assert_array_equal(sd["qa_seq_relation.bias"].numpy(),
                                      tree["qa_seq_relation"]["bias"])
    assert len(jax_params_to_state_dict(tree)) == len(sd)
    wrong = BiPretrainModel(ModelConfig(**kw), qa_pairs=not qa_pairs,
                            device="cpu")
    with pytest.raises(RuntimeError):
        load_jax_params(wrong, tree)


def test_reference_state_dict_with_tied_decoders_loads_strictly(golden):
    """The JAX package's export (the reference's keys, with the tied
    decoders materialised as copies of the table's first rows) loads
    strictly; a decoder that is not that copy raises."""
    params, cfg_kw, _, _ = golden
    tree = pretrain_tree(params, qa_pairs=True)
    ref = {k: torch.from_numpy(np.asarray(v))
           for k, v in export_state_dict(tree).items()}
    assert set(BiPretrainModel.TIED_DECODERS) <= set(ref)
    model = BiPretrainModel(ModelConfig(**config_kw(cfg_kw)), qa_pairs=True,
                            device="cpu")
    model.load_state_dict(ref, strict=True)
    mine = jax_params_to_state_dict(tree)
    assert set(mine) == set(ref) - set(BiPretrainModel.TIED_DECODERS)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, mine[k], rtol=0, atol=0)
    bad = dict(ref)
    bad["half_mlm.decoder.weight"] = bad["half_mlm.decoder.weight"] + 1e-3
    with pytest.raises(ValueError, match="half_mlm.decoder.weight"):
        model.load_state_dict(bad, strict=True)


# ---------------------------------------------------------------------------
# the task: pretrain_loss_fn under the Trainer against the JAX task
# ---------------------------------------------------------------------------

TRAJ_STEPS = 3
TRAJ_KW = dict(hn_mod="hard", phrase_mod="sample", phrase_layer=None,
               **STEP_KW)
METRICS = ("loss", "vis_mlm", "clip", "mlm", "itm", "wra", "qa")


@pytest.fixture(scope="module")
def jax_trajectory(golden):
    """The JAX pretraining task's `forward` + `loss_fn`
    (tasks/pretrain.py:303-358, with --use_qa, no extra corpus, no MoE)
    under the JAX Trainer, the hard pairs and the WRA draws pinned."""
    from mvp_pytorch_tpu.parallel.mesh import make_mesh
    from mvp_pytorch_tpu.training.trainer import Trainer as JaxTrainer
    params, cfg_kw, mt, _ = golden
    model = jax_pretrain.BiPretrainModel(JaxConfig(**config_kw(cfg_kw)))

    def forward(p, batch, rng):
        k1, k2, k3 = jax.random.split(rng, 3)
        return model.apply({"params": p}, **batch, max_tag_length=mt,
                           hn_dice=jnp.asarray(DICE), deterministic=False,
                           rngs={"hardneg": k1, "wra": k2, "dropout": k3},
                           **TRAJ_KW)

    def loss_fn(p, batch, rng):
        out = forward(p, batch, rng)
        metrics = {"vis_mlm": out.vis_mlm_loss, "clip": out.retrieval_loss,
                   "mlm": out.masked_lm_loss, "itm": out.itm_loss,
                   "wra": out.wra_loss}
        if out.qa_loss is not None:
            metrics["qa"] = out.qa_loss
        return out.total_loss, metrics
    tx = jax_optim.make_optimizer(1e-3, warmup_steps=1,
                                  total_steps=TRAJ_STEPS)
    losses = []
    with pytest.MonkeyPatch.context() as mp:
        pin_jax_wra(mp)
        trainer = JaxTrainer(loss_fn, tx, make_mesh(jax.devices()[:1]))
        state = trainer.init_state(
            jax.tree_util.tree_map(jnp.asarray, pretrain_tree(params)),
            jax.random.PRNGKey(0))
        for step in range(TRAJ_STEPS):
            batch = make_batch(mt, seed=10 + step)
            del batch["qa_is_next"]
            state, metrics = trainer.step(
                state, {k: jnp.asarray(v) for k, v in batch.items()})
            losses.append({k: float(v) for k, v in metrics.items()})
    return losses


def port_model(golden, **over):
    params, cfg_kw, _, _ = golden
    model = BiPretrainModel(ModelConfig(**config_kw(cfg_kw, **over)),
                            device="cpu")
    tree = pretrain_tree(params, qa_head=model.config.qa_answer_size > 0)
    return load_jax_params(model, tree)


def test_trainer_trajectory_matches_jax_task(golden, jax_trajectory):
    mt = golden[2]
    model = port_model(golden)
    loss_fn = pretrain_loss_fn(max_tag_length=mt,
                               hn_dice=torch.from_numpy(DICE),
                               wra_pick=WRA_PICK, wra_neg_offset=NEG_OFFSET,
                               **TRAJ_KW)
    trainer = Trainer(model, loss_fn, make_optimizer(
        model, 1e-3, warmup_steps=1, total_steps=TRAJ_STEPS))
    for step in range(TRAJ_STEPS):
        batch = make_batch(mt, seed=10 + step)
        del batch["qa_is_next"]
        got = trainer.step(torch_batch(batch))
        want = jax_trajectory[step]
        assert set(got) == set(METRICS) | {"grad_norm"}
        for k in METRICS:
            assert abs(got[k] - want[k]) <= 5e-4, (step, k, got, want)
        assert abs(got["grad_norm"] - want["grad_norm"]) <= 1e-3 * max(
            1.0, want["grad_norm"]), (step, got, want)


def test_train_pretrain_checkpoints_and_resumes(golden, tmp_path):
    """2 steps with checkpoints, then a fresh model resumes for the 3rd: the
    losses of 3 steps in one run."""
    mt = golden[2]
    batches = [make_batch(mt, seed=30 + i, qa=False) for i in range(3)]
    kw = dict(learning_rate=1e-3, warmup_steps=1, schedule="constant",
              max_tag_length=mt, seed=4, **TRAJ_KW)
    straight = train_pretrain(port_model(golden), batches, 3, **kw)
    assert set(straight[0]) == {"loss", "vis_mlm", "clip", "mlm", "itm",
                                "wra", "grad_norm"}
    out = str(tmp_path / "run")
    first = train_pretrain(port_model(golden), batches, 2, output_dir=out,
                           ckpt_period=1, keep=1, **kw)
    resumed = train_pretrain(port_model(golden), batches, 3, output_dir=out,
                             **kw)
    assert len(first) == 2 and len(resumed) == 1
    for got, want in zip(first + resumed, straight):
        for k in ("loss", "mlm", "wra"):
            assert abs(got[k] - want[k]) <= 1e-6, (k, got, want)


def test_dropout_step_is_finite_and_repeatable(golden):
    """At the config's dropouts 0.1 / 0.1 (hidden and attention-prob), one
    step from the same generator seed gives the same losses and gradients;
    the dropout does act."""
    mt = golden[2]
    batch = torch_batch(make_batch(mt, seed=50))

    def step(p, seed):
        model = port_model(golden, hidden_dropout_prob=p,
                           attention_probs_dropout_prob=p)
        model.train()
        out = model(*(batch.get(k) for k in PRETRAIN_KEYS[:-1]),
                    max_tag_length=mt, generator=torch.Generator()
                    .manual_seed(seed), **TRAJ_KW)
        out.total_loss.backward()
        return out, {n: p.grad for n, p in model.named_parameters()}
    a, ga = step(0.1, 7)
    b, gb = step(0.1, 7)
    c, _ = step(0.1, 8)
    z, _ = step(0.0, 7)
    for name in LOSSES:
        x = getattr(a, name)
        assert torch.isfinite(x), name
        assert torch.equal(x, getattr(b, name)), name
    for n, g in ga.items():
        assert torch.equal(g, gb[n]), n
    assert a.total_loss.item() != c.total_loss.item()
    assert a.total_loss.item() != z.total_loss.item()


def test_pretrain_rejects_what_it_cannot_compute(golden):
    mt = golden[2]
    batch = torch_batch(make_batch(mt, seed=60))
    args = [batch[k] for k in PRETRAIN_KEYS[:11]]
    no_qa = port_model(golden, qa_answer_size=0)
    with pytest.raises(ValueError, match="qa_answer_size"):
        no_qa(*args, batch["qa_ans"], max_tag_length=mt, **STEP_KW)
    with pytest.raises(ValueError, match="qa_pairs"):
        port_model(golden)(*args, None, batch["qa_is_next"],
                           max_tag_length=mt, **STEP_KW)
    with pytest.raises(NotImplementedError):
        port_model(golden)(*args, max_tag_length=mt, phrase_mod="easy",
                           **STEP_KW)
