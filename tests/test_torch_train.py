"""The port's retrieval training step, optimizer, trainer and checkpoints
against the JAX package, in fp32 on the CPU.

- `RetrievalModel.train_step`: the total, CLIP, ITM and WRA losses within
  2e-4 and every parameter's gradient within atol 2e-4, rtol 1e-3 of
  `jax.value_and_grad` of the JAX `train_step`, with the hard-negative slot
  permutation (`hn_dice`) and the WRA top-3 pick pinned on both sides;
- `AdamW` against optax's `make_optimizer` over 6 steps, parameters within
  1e-6;
- 3 `Trainer` steps against the JAX `Trainer`, losses within 5e-4 at every
  step; gradient accumulation 2 against one full batch;
- a checkpoint round trip, and the saved `pytorch_model.bin` through the JAX
  package's own loader.

Parameters come from the golden fixture's `bert` subtree plus a numpy-seeded
classifier (tests/test_torch_models.py); JAX results are computed once per
module under `jax.jit`.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mvp_pytorch_tpu.models import ModelConfig as JaxConfig
from mvp_pytorch_tpu.models import tasks as jax_tasks
from mvp_pytorch_tpu.models.tasks import RetrievalModel as JaxRetrieval
from mvp_pytorch_tpu.training import optim as jax_optim
from mvp_pytorch_tpu_torch.convert import (jax_params_to_state_dict,
                                           load_jax_params)
from mvp_pytorch_tpu_torch.models import ModelConfig, RetrievalModel
from mvp_pytorch_tpu_torch.tasks.retrieval import (retrieval_loss_fn,
                                                   train_retrieval)
from mvp_pytorch_tpu_torch.training.checkpoint import CheckpointManager
from mvp_pytorch_tpu_torch.training.optim import (AdamW, SCHEDULES,
                                                  make_optimizer, no_decay)
from mvp_pytorch_tpu_torch.training.trainer import Trainer

from test_torch_models import FIX, retrieval_params, unflatten

LOSS_TOL = 2e-4
GRAD = dict(atol=2e-4, rtol=1e-3)
B, LA, R = 6, 9, 5
DICE = np.array([3, 0, 5, 1, 4, 2])
KEYS = ("input_ids_a", "attention_mask_a", "token_type_ids_a", "input_ids_b",
        "attention_mask_b", "token_type_ids_b", "img_feats")


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    """torch single-threaded in this process: no intra-op thread pool is left
    behind for a later test in the same worker that forks."""
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    params = unflatten(dict(np.load(os.path.join(FIX, "params.npz"))))
    with open(os.path.join(FIX, "config.json")) as f:
        cfg_kw = json.load(f)
    mt = cfg_kw.pop("max_tag_length")
    return retrieval_params(params), cfg_kw, mt


def make_batch(mt, seed, b=B, phrases=False):
    """Continuous, padded inputs (no argmax ties in the hard mining)."""
    rs = np.random.RandomState(seed)
    ma = np.ones((b, LA), np.int64)
    ma[1::2, LA - 2:] = 0
    mb = np.ones((b, mt + R), np.int64)
    mb[1, mt + R - 2:] = 0
    batch = dict(input_ids_a=rs.randint(1, 99, (b, LA)), attention_mask_a=ma,
                 token_type_ids_a=np.zeros((b, LA), np.int64),
                 input_ids_b=rs.randint(1, 99, (b, mt)), attention_mask_b=mb,
                 token_type_ids_b=np.ones((b, mt), np.int64),
                 img_feats=rs.randn(b, R, 22).astype(np.float32))
    if phrases:
        start = rs.randint(1, 4, b)
        batch["phrase_index"] = np.stack([start, start + rs.randint(1, 4, b)],
                                         1)
        batch["phrase_index"][2] = [3, 3]            # an empty phrase span
        batch["image_index"] = np.stack([np.full(b, LA), np.full(b, LA + R)],
                                        1)
    return batch


# case -> (config overrides, train_step kwargs, phrases in the batch)
CASES = {
    "hard": ({}, {}, False),
    "hard_fused": ({"fused_hn_pass": True}, {}, False),
    "no_itm": ({}, {"no_itm": True}, False),
    "no_itm_fused": ({"fused_hn_pass": True}, {"no_itm": True}, False),
    "phrase_mid": ({}, {"phrase_layer": 0, "wra_phrase_width": 4}, True),
}
WRA_PICK = 1


def jax_train_step(cfg, full, batch, mt, kw, monkeypatch):
    """(losses, grads as a torch state dict) of the JAX train_step."""
    monkeypatch.setattr(jax_tasks, "wra_hard_loss", functools.partial(
        jax_tasks.wra_hard_loss, pick=WRA_PICK))
    model = JaxRetrieval(cfg)
    args = [jnp.asarray(batch[k]) for k in KEYS]
    extra = [jnp.asarray(batch[k]) for k in ("phrase_index", "image_index")
             if k in batch]

    def loss(p):
        out = model.apply({"params": p}, *args, *extra, max_tag_length=mt,
                          hn_mod="hard", hn_dice=jnp.asarray(DICE),
                          deterministic=True,
                          rngs={"wra": jax.random.PRNGKey(0)},
                          method=JaxRetrieval.train_step, **kw)
        return out.total_loss, out
    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, full))
    return out, jax_params_to_state_dict(
        jax.tree_util.tree_map(np.array, grads))


@pytest.fixture(scope="module")
def step_results(setup):
    """Each case's losses and gradients on both sides, computed once."""
    full, cfg_kw, mt = setup
    res = {}
    with pytest.MonkeyPatch.context() as mp:
        for case, (over, kw, phrases) in CASES.items():
            batch = make_batch(mt, seed=3, phrases=phrases)
            jout, jgrads = jax_train_step(JaxConfig(**cfg_kw, **over), full,
                                          batch, mt, kw, mp)
            port = RetrievalModel(ModelConfig(**cfg_kw, **over), device="cpu")
            load_jax_params(port, full)
            port.train()
            pout = port(*(torch.from_numpy(np.asarray(batch[k]))
                          for k in KEYS),
                        *(torch.from_numpy(batch[k])
                          for k in ("phrase_index", "image_index")
                          if k in batch),
                        max_tag_length=mt, hn_dice=torch.from_numpy(DICE),
                        wra_pick=WRA_PICK, **kw)
            pout.total_loss.backward()
            # a parameter off the loss's path (the fusion encoder and the
            # classifier under no_itm) has no grad here and zeros in JAX
            pgrads = {n: torch.zeros_like(p) if p.grad is None
                      else p.grad.clone() for n, p in port.named_parameters()}
            res[case] = (jout, pout, jgrads, pgrads)
    return res


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_losses_match_jax(step_results, case):
    jout, pout, _, _ = step_results[case]
    names = ["total_loss", "retrieval_loss", "itm_loss"]
    if CASES[case][2]:
        names.append("wra_loss")
    for name in names:
        got = getattr(pout, name).item()
        assert abs(got - float(getattr(jout, name))) <= LOSS_TOL, name
    np.testing.assert_allclose(pout.itm_logits.detach().numpy(),
                               np.asarray(jout.itm_logits), atol=LOSS_TOL)
    np.testing.assert_array_equal(pout.itm_labels.numpy(),
                                  np.asarray(jout.itm_labels))
    if CASES[case][1].get("no_itm"):
        assert tuple(pout.itm_logits.shape) == (2 * B, 2)
        assert float(pout.itm_loss) == 0.0


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_grads_match_jax(step_results, case):
    _, _, jgrads, pgrads = step_results[case]
    assert set(pgrads) == set(jgrads)
    for name, g in pgrads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[name].numpy(), **GRAD,
                                   err_msg=name)
    # every encoder's attention weights on the loss's path get a gradient
    # (nothing detached)
    encoders = ("txt", "vis") if CASES[case][1].get("no_itm") else (
        "txt", "vis", "mul")
    for enc in encoders:
        key = f"bert.{enc}_encoder.layer.0.attention.self.query.weight"
        assert float(pgrads[key].abs().max()) > 0, key


def test_hard_mining_matches_jax(setup):
    """The mined hard pairs, with and without a pinned permutation."""
    full, cfg_kw, mt = setup
    batch = make_batch(mt, seed=5)
    port = RetrievalModel(ModelConfig(**cfg_kw), device="cpu")
    load_jax_params(port, full)
    args = [torch.from_numpy(np.asarray(batch[k])) for k in KEYS]
    with torch.no_grad():
        out = port.bert(*args, max_tag_length=mt, encode_hn=True,
                        hn_dice=torch.from_numpy(DICE))
        drawn = port.bert(*args, max_tag_length=mt, encode_hn=True,
                          generator=torch.Generator().manual_seed(0))
    jm = JaxRetrieval(JaxConfig(**cfg_kw))
    jout = jax.jit(lambda p, *a: jm.apply(
        {"params": p}, *a, max_tag_length=mt, encode_hn=True,
        hn_dice=jnp.asarray(DICE), method=lambda m, *x, **k: m.bert(*x, **k)))(
        jax.tree_util.tree_map(jnp.asarray, full),
        *(jnp.asarray(batch[k]) for k in KEYS))
    np.testing.assert_array_equal(out.hard_txt_index.numpy(),
                                  np.asarray(jout.hard_txt_index))
    np.testing.assert_array_equal(out.hard_img_index.numpy(),
                                  np.asarray(jout.hard_img_index))
    np.testing.assert_allclose(out.hard_pooled_output.numpy(),
                               np.asarray(jout.hard_pooled_output),
                               atol=5e-4, rtol=1e-3)
    # a drawn permutation: hard-image slots keep their text, hard-text
    # slots their image, and no slot pairs an example with itself
    n = B // 2
    assert sorted(drawn.hard_txt_index[:n].tolist()
                  + drawn.hard_img_index[n:].tolist()) == list(range(B))
    assert (drawn.hard_txt_index != drawn.hard_img_index).all()


def test_sampled_negatives_never_pick_the_pair_itself(setup):
    _, cfg_kw, _ = setup
    from mvp_pytorch_tpu_torch.models import BiEncoder
    enc = BiEncoder(ModelConfig(**cfg_kw))
    sim = torch.from_numpy(np.random.RandomState(0).rand(8, 8)
                           .astype(np.float32))
    gen = torch.Generator().manual_seed(1)
    for _ in range(20):
        txt, img = enc.mine_hard_negatives(sim, hn_mod="sample", logit=14.3,
                                           generator=gen)
        assert (txt != img).all()
    with pytest.raises(NotImplementedError):
        enc.mine_hard_negatives(sim, hn_mod="easy")


# ---------------------------------------------------------------------------
# optimizer against optax
# ---------------------------------------------------------------------------

OPT_STEPS = 6


def random_grads(flax_params, seed):
    """Per-step numpy gradients on the flax tree; the first steps' global
    norms exceed 1 (clipping active), the later ones do not."""
    r = np.random.RandomState(seed)
    out = []
    for step in range(OPT_STEPS):
        scale = 0.5 if step < 3 else 0.002
        out.append(jax.tree_util.tree_map(
            lambda v: np.asarray(r.randn(*np.shape(v)) * scale, np.float32),
            flax_params))
    return out


OPT_CASES = {
    "linear": dict(schedule="linear", warmup_steps=2),
    "constant": dict(schedule="constant", warmup_steps=2),
    "cosine": dict(schedule="cosine", warmup_steps=2),
    "cosine_no_warmup_no_clip": dict(schedule="cosine", warmup_steps=0,
                                     max_grad_norm=None),
    "freeze_bert_3": dict(schedule="linear", warmup_steps=1,
                          freeze_steps=3),
}


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_adamw_matches_optax(setup, case):
    full = setup[0]
    kw = dict(OPT_CASES[case])
    freeze_steps = kw.pop("freeze_steps", 0)
    max_norm = kw.pop("max_grad_norm", 1.0)
    lr = 3e-3
    tx = jax_optim.make_optimizer(lr, total_steps=OPT_STEPS,
                                  weight_decay=0.05, max_grad_norm=max_norm,
                                  **kw)
    if freeze_steps:
        tx = jax_optim.freeze_prefix_until(tx, "bert", freeze_steps)
    jparams = jax.tree_util.tree_map(jnp.asarray, full)
    state = tx.init(jparams)
    update = jax.jit(tx.update)

    sd = jax_params_to_state_dict(full)
    tparams = {k: torch.nn.Parameter(v.clone()) for k, v in sd.items()}
    opt = AdamW(tparams.items(),
                SCHEDULES[kw["schedule"]](lr, kw["warmup_steps"], OPT_STEPS),
                weight_decay=0.05, max_grad_norm=max_norm,
                freeze_prefix="bert" if freeze_steps else None,
                freeze_steps=freeze_steps)
    for step, grads in enumerate(random_grads(full, seed=2)):
        updates, state = update(jax.tree_util.tree_map(jnp.asarray, grads),
                                state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tgrads = jax_params_to_state_dict(grads)
        for k, p in tparams.items():
            p.grad = tgrads[k]
        opt.step()
        want = jax_params_to_state_dict(
            jax.tree_util.tree_map(np.asarray, jparams))
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                       atol=1e-6, rtol=0,
                                       err_msg=f"step {step} {k}")
        if freeze_steps and step < freeze_steps:
            np.testing.assert_array_equal(
                tparams["bert.pooler.dense.weight"].detach().numpy(),
                sd["bert.pooler.dense.weight"].numpy())


def test_schedules_match_optax():
    for name in ("linear", "constant", "cosine"):
        for warmup in (0, 3):
            ours = SCHEDULES[name](1e-3, warmup, 10)
            theirs = jax_optim.SCHEDULES[name](1e-3, warmup, 10)
            for c in range(14):
                assert abs(ours(c) - float(theirs(c))) <= 1e-9, (name, c)


def test_decay_mask_matches_jax(setup):
    full = setup[0]
    mask = jax_optim.decay_mask(full)
    flat_mask = jax_params_to_state_dict(
        jax.tree_util.tree_map(lambda m: np.asarray(m, np.float32), mask))
    for k, v in flat_mask.items():
        assert (not no_decay(k)) == bool(v.reshape(-1)[0]), k
    assert not no_decay("logit_scale")
    assert not no_decay("bert.txt_proj")
    assert no_decay("bert.embeddings.LayerNorm.weight")


# ---------------------------------------------------------------------------
# trainer against the JAX Trainer
# ---------------------------------------------------------------------------

TRAJ_STEPS = 3


@pytest.fixture(scope="module")
def jax_trajectory(setup):
    from mvp_pytorch_tpu.parallel.mesh import make_mesh
    from mvp_pytorch_tpu.training.trainer import Trainer as JaxTrainer
    full, cfg_kw, mt = setup
    model = JaxRetrieval(JaxConfig(**cfg_kw))

    def loss_fn(p, batch, rng):
        out = model.apply({"params": p}, *(batch[k] for k in KEYS),
                          max_tag_length=mt, hn_mod="hard",
                          hn_dice=jnp.asarray(DICE), deterministic=True,
                          method=JaxRetrieval.train_step)
        return out.total_loss, {"clip": out.retrieval_loss,
                                "itm": out.itm_loss}
    tx = jax_optim.make_optimizer(1e-3, warmup_steps=1,
                                  total_steps=TRAJ_STEPS)
    trainer = JaxTrainer(loss_fn, tx, make_mesh(jax.devices()[:1]))
    state = trainer.init_state(jax.tree_util.tree_map(jnp.asarray, full),
                               jax.random.PRNGKey(0))
    losses = []
    for step in range(TRAJ_STEPS):
        batch = {k: jnp.asarray(v)
                 for k, v in make_batch(mt, seed=10 + step).items()}
        state, metrics = trainer.step(state, batch)
        losses.append({k: float(v) for k, v in metrics.items()})
    return losses


def port_model(setup, **over):
    full, cfg_kw, _ = setup
    model = RetrievalModel(ModelConfig(**cfg_kw, **over), device="cpu")
    return load_jax_params(model, full)


def port_trainer(setup, model, grad_accum=1):
    mt = setup[2]

    def loss_fn(m, batch, generator):
        out = m.train_step(*(batch[k] for k in KEYS), max_tag_length=mt,
                           hn_dice=torch.from_numpy(DICE),
                           generator=generator)
        return out.total_loss, {"clip": out.retrieval_loss,
                                "itm": out.itm_loss}
    opt = make_optimizer(model, 1e-3, warmup_steps=1, total_steps=TRAJ_STEPS)
    return Trainer(model, loss_fn, opt, grad_accum=grad_accum)


def test_trainer_trajectory_matches_jax(setup, jax_trajectory):
    trainer = port_trainer(setup, port_model(setup))
    for step in range(TRAJ_STEPS):
        batch = {k: torch.from_numpy(np.asarray(v))
                 for k, v in make_batch(setup[2], seed=10 + step).items()}
        got = trainer.step(batch)
        want = jax_trajectory[step]
        for k in ("loss", "clip", "itm"):
            assert abs(got[k] - want[k]) <= 5e-4, (step, k, got, want)
        assert abs(got["grad_norm"] - want["grad_norm"]) <= 1e-3 * max(
            1.0, want["grad_norm"]), (step, got, want)
    assert trainer.step_count == TRAJ_STEPS


def test_grad_accumulation_equals_full_batch(setup):
    """With a loss that is a mean over independent examples (the ITM loss of
    true pairs through `score`), two micro batches of 4 give the step of one
    batch of 8."""
    mt = setup[2]
    batch = {k: torch.from_numpy(np.asarray(v))
             for k, v in make_batch(mt, seed=21, b=8).items()}

    def loss_fn(m, b, generator):
        logits = m.score(*(b[k] for k in KEYS), max_tag_length=mt)
        loss = torch.nn.functional.cross_entropy(
            logits, torch.ones(logits.shape[0], dtype=torch.int64))
        return loss, {"itm": loss}
    results = []
    for accum in (1, 2):
        model = port_model(setup)
        opt = make_optimizer(model, 1e-3, total_steps=2)
        metrics = Trainer(model, loss_fn, opt, grad_accum=accum).step(batch)
        results.append((metrics, {k: v.detach().clone()
                                  for k, v in model.state_dict().items()}))
    (m1, sd1), (m2, sd2) = results
    assert abs(m1["loss"] - m2["loss"]) <= 1e-6
    assert abs(m1["grad_norm"] - m2["grad_norm"]) <= 1e-5
    for k in sd1:
        torch.testing.assert_close(sd2[k], sd1[k], atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="divisible"):
        Trainer(port_model(setup), loss_fn, opt, grad_accum=3).step(batch)


def test_trainer_generators_are_seeded_per_step(setup):
    trainer = port_trainer(setup, port_model(setup))
    a = torch.rand(4, generator=trainer.generator(5))
    b = torch.rand(4, generator=trainer.generator(5))
    c = torch.rand(4, generator=trainer.generator(6))
    d = torch.rand(4, generator=trainer.generator(5, micro=1))
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, d)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_round_trip_continues_the_run(setup, tmp_path):
    """Train 2 steps with checkpoints, resume a fresh model and optimizer
    from the newest one for the 3rd step: the same losses as 3 steps in one
    run. The weights file loads through the JAX package's converter."""
    from mvp_pytorch_tpu.convert import (convert_state_dict,
                                         load_torch_state_dict)
    mt = setup[2]
    batches = [make_batch(mt, seed=30 + i) for i in range(3)]
    # a constant schedule: the 2-step run's schedule is the 3-step run's
    kw = dict(learning_rate=1e-3, warmup_steps=1, schedule="constant",
              max_tag_length=mt, seed=4)
    straight = train_retrieval(port_model(setup), batches, 3, **kw)
    out = str(tmp_path / "run")
    first = train_retrieval(port_model(setup), batches, 2, output_dir=out,
                            ckpt_period=1, keep=1, **kw)
    ckpt = CheckpointManager(out)
    assert ckpt.latest() == (2, os.path.join(out, "checkpoint-0000002"))
    assert sorted(os.listdir(out)) == ["checkpoint-0000002",
                                       "last_checkpoint", "metrics.jsonl"]
    d = ckpt.latest()[1]
    assert sorted(os.listdir(d)) == ["config.json", "optimizer.pt",
                                     "pytorch_model.bin", "train_meta.json"]
    resumed = train_retrieval(port_model(setup), batches, 3, output_dir=out,
                              ckpt_period=1, **kw)
    assert len(first) == 2 and len(resumed) == 1
    for got, want in zip(first + resumed, straight):
        for k in ("loss", "clip", "itm"):
            assert abs(got[k] - want[k]) <= 1e-6, (k, got, want)
    with open(os.path.join(out, "metrics.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [1, 2, 3]

    # the JAX package's own loader reads the weights file
    model = port_model(setup)
    meta = CheckpointManager(out).restore(
        os.path.join(out, "checkpoint-0000003"), model)
    assert meta == {"step": 3}
    params, skipped = convert_state_dict(load_torch_state_dict(
        os.path.join(out, "checkpoint-0000003")))
    assert not skipped
    back = jax_params_to_state_dict(params)
    sd = model.state_dict()
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)
    cfg = json.load(open(os.path.join(out, "checkpoint-0000003",
                                      "config.json")))
    assert JaxConfig.from_dict(cfg) == JaxConfig(**setup[1])


def test_retrieval_loss_fn_reports_wra_with_phrases(setup):
    mt = setup[2]
    batch = {k: torch.from_numpy(np.asarray(v))
             for k, v in make_batch(mt, seed=40, phrases=True).items()}
    model = port_model(setup)
    loss, metrics = retrieval_loss_fn(max_tag_length=mt, phrase_layer=1)(
        model, batch, torch.Generator().manual_seed(0))
    assert set(metrics) == {"clip", "itm", "wra"}
    assert torch.isfinite(loss)
    assert abs(loss.item() - sum(m.item() for m in metrics.values())) <= 1e-5
