"""The port's SCST (`training/scst.py`, the captioning driver's
`scst_copy_loss` and `scst_optimizer`) against the JAX package's, on the
CPU.

- `ScstReward.rewards` within 1e-9 of the JAX class's, greedy and sample
  baselines at `seq_per_img` 1 and 3; `scst_loss` within 1e-6;
- `sample_mask` equal to the JAX driver's mask (the forced-EOS slot of an
  unfinished row excluded) on a sampled `GenerateOutput`;
- the loss and every parameter's gradient of a tiny fp32 `CaptioningModel`
  on fixed sampled sequences, mask, advantages and context, against the JAX
  driver's closure rebuilt from `model.apply` and `scst_loss` (the L masked
  copies and the diagonal of their logits): the loss within 1e-5, each
  gradient within 1e-4 of the JAX one's norm (of 1e-6 of the largest
  gradient's norm where the gradient is zero in exact arithmetic);
- one and two updates of `scst_optimizer` against `optax.adamw(lr)`
  (weight decay on every parameter, no clipping) within 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mvp_pytorch_tpu.models import img_bert as jib
from mvp_pytorch_tpu.models import tiny_config as jax_tiny_config
from mvp_pytorch_tpu.training import scst as jscst
from mvp_pytorch_tpu_torch.convert import (jax_params_to_state_dict,
                                           load_jax_params)
from mvp_pytorch_tpu_torch.models import ModelConfig
from mvp_pytorch_tpu_torch.models import generation as pgen
from mvp_pytorch_tpu_torch.models.img_bert import CaptioningModel
from mvp_pytorch_tpu_torch.tasks import captioning as pcap
from mvp_pytorch_tpu_torch.training import scst as pscst

N, L, T, R = 3, 6, 4, 3
PAD, BOS, EOS, MASK = 0, 2, 3, 4
WORDS = ["a", "big", "red", "cat", "dog", "sits", "on", "the", "mat",
         "runs", "fast", "blue", "sky", "."]


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    """torch single-threaded in this process: no intra-op thread pool is left
    behind for a later test in the same worker that forks."""
    torch.set_num_threads(1)


def captions(rs, n, lo=2, hi=9):
    return [[WORDS[w] for w in rs.randint(0, len(WORDS), rs.randint(lo, hi))]
            for _ in range(n)]


@pytest.mark.parametrize("baseline,spi", [("greedy", 1), ("greedy", 3),
                                          ("sample", 1), ("sample", 3)])
def test_rewards_match_jax(baseline, spi):
    rs = np.random.RandomState(spi)
    n_img = 4
    sampled = captions(rs, n_img * spi)
    greedy = captions(rs, n_img)
    refs = [captions(rs, 3, 3, 8) for _ in range(n_img)]
    refs = [r for r in refs for _ in range(spi)]
    want = jscst.ScstReward(baseline_type=baseline).rewards(
        sampled, greedy, refs, seq_per_img=spi)
    got = pscst.ScstReward(baseline_type=baseline).rewards(
        sampled, greedy, refs, seq_per_img=spi)
    assert got.shape == (n_img * spi,)
    np.testing.assert_allclose(got, want, atol=1e-9, rtol=0)
    assert np.abs(got).max() > 0
    assert pscst._wrap_sentence(["a", "cat."]) == ["a", "cat", "<eos>"]
    with pytest.raises(ValueError, match="baseline_type"):
        pscst.ScstReward(baseline_type="mean")


def test_scst_loss_matches_jax():
    rs = np.random.RandomState(0)
    lp = -rs.rand(5, 7).astype(np.float32) * 4
    mask = (rs.rand(5, 7) < 0.7).astype(np.float32)
    adv = rs.randn(5)
    want = float(jscst.scst_loss(jnp.asarray(lp), jnp.asarray(mask), adv))
    got = pscst.scst_loss(torch.from_numpy(lp), torch.from_numpy(mask), adv)
    np.testing.assert_allclose(got.item(), want, atol=1e-6, rtol=0)


def test_sample_mask_drops_the_forced_eos_slot():
    """A sampled decode where row 0 never emits EOS (its last slot a forced
    EOS) and the others finish: the JAX driver's mask from lengths and
    `finished`."""
    v, max_len = 9, 7
    w = torch.randn(v, v, generator=torch.Generator().manual_seed(0))
    w[:, BOS] -= 9.0
    w[:, MASK] -= 9.0
    w[:, EOS] += 1.0

    def logits_fn(tokens, t):
        out = w[tokens[:, t - 1]].clone()
        out[0, EOS] = -1e4                    # row 0 never finishes
        return out
    out = pgen.generate(logits_fn, BOS, EOS, PAD, MASK, 6, max_len,
                        do_sample=True,
                        generator=torch.Generator().manual_seed(3),
                        device="cpu")
    fin = out.finished.numpy()
    assert not fin[0] and fin[1:].any()
    got = pscst.sample_mask(out.lengths, out.finished, max_len).numpy()
    steps = np.arange(max_len)[None, :]
    lens = out.lengths.numpy()[:, None]
    want = ((steps >= 1) & (steps < lens)).astype(np.float32)
    want *= ~((steps == max_len - 1) & ~fin[:, None])
    np.testing.assert_array_equal(got, want)
    assert got[0, max_len - 1] == 0 and got[0, max_len - 2] == 1
    assert out.sequences[0, -1] == EOS


# ---------------------------------------------------------------------------
# the loss and gradients through the model
# ---------------------------------------------------------------------------

def scst_inputs(jcfg, seed=0):
    r = np.random.RandomState(seed)
    sampled = r.randint(5, jcfg.only_word_size, (N, L)).astype(np.int32)
    sampled[:, 0] = BOS
    sampled[0, 3], sampled[0, 4:] = EOS, PAD
    mask = np.ones((N, L), np.float32)
    mask[:, 0] = 0
    mask[0, 4:] = 0
    mask[2, L - 1] = 0                       # a forced EOS slot
    ctx_mask = np.ones((N, T + R), np.int32)
    ctx_mask[1, T - 1:T] = 0
    ctx_mask[2, T + R - 1:] = 0
    return dict(
        sampled=sampled, mask=mask,
        adv=r.randn(N).astype(np.float64),
        ids_b=r.randint(5, jcfg.only_word_size, (N, T)).astype(np.int32),
        ctx_mask=ctx_mask,
        feats=r.randn(N, R, jcfg.img_feature_dim).astype(np.float32))


@pytest.fixture(scope="module")
def jax_scst():
    """The JAX driver's `scst_grad` closure (captioning.py:437-453) on a
    tiny fp32 model: params, loss and gradients."""
    jcfg = jax_tiny_config()
    x = scst_inputs(jcfg)
    model = jib.CaptioningModel(jcfg)
    ids_b, ctx_mask, feats = (jnp.asarray(x[k]) for k in
                              ("ids_b", "ctx_mask", "feats"))
    params = jax.jit(lambda: model.init(
        jax.random.PRNGKey(5), jnp.asarray(x["sampled"]), ids_b, ctx_mask,
        jnp.zeros((N, L), jnp.int32), jnp.ones_like(ids_b), feats,
        deterministic=True))()["params"]

    @jax.jit
    def scst_grad(p, sampled, sample_mask, adv):
        n, l = sampled.shape

        def loss(p):
            eye = jnp.eye(l, dtype=bool)[None]
            expanded = jnp.where(eye, MASK, sampled[:, None, :])
            flat = expanded.reshape(n * l, l)
            reps = flat.shape[0] // n
            logits = model.apply(
                {"params": p}, flat, jnp.repeat(ids_b, reps, 0),
                jnp.repeat(ctx_mask, reps, 0),
                jnp.zeros((flat.shape[0], l), jnp.int32),
                jnp.ones((flat.shape[0], ids_b.shape[1]), jnp.int32),
                jnp.repeat(feats, reps, 0), deterministic=True)
            diag = logits.reshape(n, l, l, -1)[
                :, jnp.arange(l), jnp.arange(l), :]
            logp = jax.nn.log_softmax(diag.astype(jnp.float32), -1)
            tok_lp = jnp.take_along_axis(logp, sampled[..., None], -1)[..., 0]
            return jscst.scst_loss(tok_lp, sample_mask, adv)
        return jax.value_and_grad(loss)(p)

    loss, grads = scst_grad(params, jnp.asarray(x["sampled"]),
                            jnp.asarray(x["mask"]), jnp.asarray(x["adv"]))
    return dict(jcfg=jcfg, x=x, params=jax.tree_util.tree_map(
        np.asarray, params), loss=float(loss),
        grads=jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                              grads)))


def test_scst_copy_loss_and_grads_match_jax(jax_scst):
    x = jax_scst["x"]
    model = CaptioningModel(
        ModelConfig.from_dict(dataclasses.asdict(jax_scst["jcfg"])),
        device="cpu")
    load_jax_params(model, jax_scst["params"])
    model.eval()
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in x.items()}
    loss = pcap.scst_copy_loss(model, t["sampled"].long(), t["mask"],
                               x["adv"], t["ids_b"], t["ctx_mask"],
                               t["feats"], MASK)
    loss.backward()
    np.testing.assert_allclose(loss.item(), jax_scst["loss"], atol=1e-5,
                               rtol=0)
    assert abs(jax_scst["loss"]) > 1e-3
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(jax_scst["grads"])
    # the attention key biases' gradients are zero in exact arithmetic (a
    # bias on every key of a row cancels in the softmax): both sides hold
    # rounding noise there, so a norm below 1e-6 of the largest counts as 0
    floor = 1e-6 * max(g.norm().item() for g in jax_scst["grads"].values())
    for name, want in jax_scst["grads"].items():
        # a parameter the loss never reaches (the pooler) has no torch
        # gradient and a zero JAX one
        got = torch.zeros_like(want) if grads[name] is None else grads[name]
        scale = max(want.norm().item(), floor)
        assert (got - want).norm().item() <= 1e-4 * scale, name


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

class Two(torch.nn.Module):
    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.dense = torch.nn.Linear(5, 4)
        self.norm = torch.nn.LayerNorm(4)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=g))


def test_scst_optimizer_matches_optax_adamw():
    """Two updates: weight decay 1e-4 on every parameter (the LayerNorm's
    too), no clipping (gradients far above norm 1)."""
    lr = 1e-3
    model = Two()
    params = {n: p.detach().numpy().copy()
              for n, p in model.named_parameters()}
    rs = np.random.RandomState(1)
    steps = [{n: rs.randn(*v.shape).astype(np.float32) * 10
              for n, v in params.items()} for _ in range(2)]
    tx = optax.adamw(lr)
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    state = tx.init(jp)
    opt = pcap.scst_optimizer(model, lr)
    for g in steps:
        upd, state = tx.update({n: jnp.asarray(v) for n, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(g[n])
        opt.step()
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[n]),
                                   atol=1e-6, rtol=0, err_msg=n)
    assert all(opt.decay)
