"""The port's captioning model (`models/img_bert.py`: `make_seq2seq_mask`,
`captioning_loss`, `CaptioningModel`) and the layers' history cache against
the JAX package's, in fp32 on the CPU.

- `make_seq2seq_mask` equal to the JAX mask;
- `captioning_loss` (within 2e-4, and its gradient in the logits) plain,
  with drop-worst, a sparse mask, tied losses (the stable rank decides which
  positions get a gradient) and the `apply_drop` gate;
- `StreamEncoder` with `history_states` and `collect_states` (within 2e-4);
- `CaptioningModel`: logits and loss (within 2e-4) and every parameter's
  gradient (atol 2e-4, rtol 1e-3) against `jax.value_and_grad`, with the
  drop-worst gate closed and open; `decode_logits` at a position;
  `prefill`'s cache and `decode_step`'s logits and cache at t = 1, 2 and 5,
  each JAX call made one at a time (no scan over the JAX model);
- the strict loads: a JAX tree, the JAX exporter's reference state dict
  with the full-table decoder copy, and a wrong copy that raises;
- the port's cached decoding against its recompute decoding on the tiny
  model: greedy and beam sequences equal.

Weights are the JAX model's seeded init, carried by `load_jax_params`. The
JAX results are computed once per module under `jax.jit`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvp_pytorch_tpu.convert import export_state_dict
from mvp_pytorch_tpu.models import img_bert as jib
from mvp_pytorch_tpu.models import layers as jlayers
from mvp_pytorch_tpu.models import tiny_config as jax_tiny_config
from mvp_pytorch_tpu.ops.attention import mask_to_bias as jax_mask_to_bias
from mvp_pytorch_tpu_torch.convert import (jax_params_to_state_dict,
                                           load_jax_params)
from mvp_pytorch_tpu_torch.models import ModelConfig
from mvp_pytorch_tpu_torch.models import img_bert as pib
from mvp_pytorch_tpu_torch.models.generation import (beam_search,
                                                     beam_search_cached,
                                                     generate,
                                                     generate_cached)
from mvp_pytorch_tpu_torch.models.layers import StreamEncoder, mask_to_bias

TOL = 2e-4
GRAD = dict(atol=2e-4, rtol=1e-3)
B, LC, T, R = 4, 8, 5, 3
PAD, BOS, EOS, MASK = 0, 2, 3, 4
SMOOTH, RATIO, AFTER = 0.1, 0.3, 2
STEPS = (1, 2, 5)


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    """torch single-threaded in this process: no intra-op thread pool is left
    behind for a later test in the same worker that forks."""
    torch.set_num_threads(1)


def port_config(jcfg):
    return ModelConfig.from_dict(dataclasses.asdict(jcfg))


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def caption_inputs(jcfg, seed=0):
    """One training batch: captions with [MASK]s at the masked positions,
    contexts with padded tags and regions, the masked targets."""
    r = np.random.RandomState(seed)
    masked_pos = (r.rand(B, LC) < 0.4).astype(np.int32)
    masked_pos[:, 0] = 0
    masked_pos[0, 3] = 1
    cap = r.randint(5, jcfg.only_word_size, (B, LC)).astype(np.int32)
    masked_ids = np.where(masked_pos > 0, cap, 0).astype(np.int32)
    ctx_mask = np.ones((B, T + R), np.int32)
    ctx_mask[1, T - 2:T] = 0                 # padded tags
    ctx_mask[2, T + R - 1:] = 0              # a padded region
    return dict(
        input_ids=np.where(masked_pos > 0, MASK, cap).astype(np.int32),
        ctx_ids=r.randint(5, jcfg.only_word_size, (B, T)).astype(np.int32),
        ctx_mask=ctx_mask,
        token_type_ids=np.zeros((B, LC), np.int32),
        ctx_token_type_ids=np.ones((B, T), np.int32),
        img_feats=r.randn(B, R, jcfg.img_feature_dim).astype(np.float32),
        masked_pos=masked_pos, masked_ids=masked_ids)


def to_torch(inputs):
    return {k: torch.from_numpy(v) for k, v in inputs.items()}


@pytest.fixture(scope="module")
def jax_results():
    """The JAX model's params, its loss, logits and gradients at steps 1
    (drop-worst gate closed) and 3 (open), its decode logits at position
    3, and its prefill and decode-step outputs at STEPS for a fixed
    committed prefix."""
    jcfg = jax_tiny_config()
    inputs = caption_inputs(jcfg)
    model = jib.CaptioningModel(jcfg, label_smoothing=SMOOTH,
                                drop_worst_ratio=RATIO,
                                drop_worst_after=AFTER)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    params = jax.jit(lambda: model.init(jax.random.PRNGKey(3), **jin,
                                        deterministic=True))()["params"]

    @jax.jit
    def loss_and_grads(p, step):
        def f(p):
            return model.apply({"params": p}, **jin, deterministic=True,
                               step=step)
        return jax.value_and_grad(f, has_aux=True)(p)

    train = {}
    for step in (1, 3):
        (loss, logits), grads = loss_and_grads(params, step)
        train[step] = (float(loss), np.asarray(logits), numpy_tree(grads))
    ctx = (jin["ctx_ids"], jin["ctx_mask"], jin["token_type_ids"],
           jin["ctx_token_type_ids"], jin["img_feats"])
    recompute = np.asarray(jax.jit(lambda p, cap: model.apply(
        {"params": p}, cap, *ctx, method=model.decode_logits))(
            params, jin["input_ids"])[:, 3])

    prefix = np.random.RandomState(7).randint(
        5, jcfg.only_word_size, (B, LC)).astype(np.int32)
    prefix[:, 0] = BOS
    prefill = jax.jit(lambda p: model.apply(
        {"params": p}, jin["ctx_ids"], jin["ctx_mask"],
        jin["ctx_token_type_ids"], jin["img_feats"], LC,
        method=model.prefill))
    step_fn = jax.jit(lambda p, cache, t, prev: model.apply(
        {"params": p}, cache, t, prev, jin["ctx_mask"], LC, MASK,
        method=model.decode_step))
    cache = prefill(params)
    decoded = {0: (None, np.asarray(cache))}
    for t in range(1, max(STEPS) + 1):
        logits, cache = step_fn(params, cache, jnp.asarray(t),
                                jnp.asarray(prefix[:, t - 1]))
        if t in STEPS:
            decoded[t] = (np.asarray(logits), np.asarray(cache))
    return dict(jcfg=jcfg, inputs=inputs, params=numpy_tree(params),
                train=train, recompute=recompute, prefix=prefix,
                decoded=decoded)


def port_model(jres):
    model = pib.CaptioningModel(port_config(jres["jcfg"]),
                                label_smoothing=SMOOTH,
                                drop_worst_ratio=RATIO,
                                drop_worst_after=AFTER, device="cpu")
    return load_jax_params(model, jres["params"])


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=0)


# ---------------------------------------------------------------------------
# the mask and the loss
# ---------------------------------------------------------------------------

def test_seq2seq_mask_matches_jax():
    ctx = np.ones((3, 7), np.int32)
    ctx[1, 4:] = 0
    ctx[2, [1, 5]] = 0
    want = np.asarray(jib.make_seq2seq_mask(5, jnp.asarray(ctx)))
    got = pib.make_seq2seq_mask(5, torch.from_numpy(ctx))
    assert got.dtype == torch.int32 and got.shape == (3, 12, 12)
    np.testing.assert_array_equal(got.numpy(), want)


LOSS_CASES = {
    "plain": dict(ratio=0.0),
    "drop_worst": dict(ratio=RATIO),
    "sparse": dict(ratio=0.5, sparse=True),
    "ties": dict(ratio=0.5, ties=True),
    "gate_closed": dict(ratio=RATIO, apply_drop=False),
    "gate_open": dict(ratio=RATIO, apply_drop=True),
    "one_masked": dict(ratio=0.9, one=True),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_captioning_loss_matches_jax(case):
    """The loss within 2e-4 and its gradient in the logits: with tied
    losses the stable rank picks the kept positions, and only those get a
    gradient."""
    c = LOSS_CASES[case]
    r = np.random.RandomState(4)
    logits = r.randn(3, 6, 17).astype(np.float32)
    tgt = r.randint(0, 17, (3, 6)).astype(np.int32)
    w = np.ones((3, 6), np.float32)
    if c.get("sparse"):
        w = (r.rand(3, 6) < 0.4).astype(np.float32)
        w[0, 0] = 1.0
    if c.get("ties"):
        logits[:] = logits[0, 0]
        tgt[:] = tgt[0, 0]
    if c.get("one"):
        w[:] = 0.0
        w[2, 4] = 1.0
    kw = dict(label_smoothing=SMOOTH, drop_worst_ratio=c["ratio"])

    def jloss(x):
        return jib.captioning_loss(
            x, jnp.asarray(tgt), jnp.asarray(w), **kw,
            apply_drop=(None if "apply_drop" not in c
                        else jnp.asarray(c["apply_drop"])))
    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = pib.captioning_loss(x, torch.from_numpy(tgt), torch.from_numpy(w),
                              **kw, apply_drop=c.get("apply_drop"))
    got.backward()
    close(got.item(), float(want))
    close(x.grad.numpy(), want_g)
    if case == "ties":
        kept = (np.abs(np.asarray(want_g)).sum(-1) > 0).reshape(-1)
        assert kept.sum() == 9 and kept[:9].all()   # the first 9 of 18


# ---------------------------------------------------------------------------
# the layers' history cache
# ---------------------------------------------------------------------------

def test_stream_encoder_history_and_collect_states():
    """Two fresh positions against a per-layer history, with a per-query
    bias: the output and each layer's input states equal the JAX
    encoder's; `collect_states` off keeps the two-value return."""
    jcfg = jax_tiny_config()
    r = np.random.RandomState(5)
    n_layers, lh, h = 2, 6, jcfg.hidden_size
    hidden = r.randn(B, 2, h).astype(np.float32)
    hist = r.randn(n_layers, B, lh, h).astype(np.float32)
    mask = (r.rand(B, 2, lh + 2) > 0.3).astype(np.int32)
    mask[..., 0] = 1
    enc = jlayers.StreamEncoder(jcfg, n_layers)
    jbias = jax_mask_to_bias(jnp.asarray(mask))
    params = enc.init(jax.random.PRNGKey(1), jnp.asarray(hidden), jbias,
                      history_states=list(jnp.asarray(hist)),
                      collect_states=True)
    want, _, want_states = enc.apply(params, jnp.asarray(hidden), jbias,
                                     history_states=list(jnp.asarray(hist)),
                                     collect_states=True)
    sd = jax_params_to_state_dict({"bert": {"encoder": numpy_tree(
        params["params"])}})
    port = StreamEncoder(port_config(jcfg), n_layers)
    port.load_state_dict({k[len("bert.encoder."):]: v for k, v in sd.items()},
                         strict=True)
    bias = mask_to_bias(torch.from_numpy(mask))
    with torch.no_grad():
        got, mid, states = port(torch.from_numpy(hidden), bias,
                                history_states=torch.from_numpy(hist),
                                collect_states=True)
        two = port(torch.from_numpy(hidden), bias,
                   history_states=list(torch.from_numpy(hist)))
    assert mid is None and len(two) == 2 and len(states) == n_layers
    close(got.numpy(), want)
    torch.testing.assert_close(two[0], got, rtol=0, atol=0)
    for a, b in zip(states, want_states):
        close(a.numpy(), b)


# ---------------------------------------------------------------------------
# CaptioningModel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [1, 3])
def test_captioning_model_logits_loss_grads_match_jax(jax_results, step):
    """Logits and loss within 2e-4 and every parameter's gradient against
    `jax.value_and_grad`, with the drop-worst gate closed (step 1) and
    open (step 3)."""
    model = port_model(jax_results)
    tin = to_torch(jax_results["inputs"])
    loss, logits = model(**tin, step=step)
    loss.backward()
    want_loss, want_logits, jgrads = jax_results["train"][step]
    assert logits.shape == (B, LC, jax_results["jcfg"].vocab_size)
    close(logits.detach().numpy(), want_logits)
    close(loss.item(), want_loss)
    want = jax_params_to_state_dict(jgrads)
    params = dict(model.named_parameters())
    assert set(want) == set(params)
    for name, p in params.items():     # the pooler takes no gradient
        grad = p.grad if p.grad is not None else torch.zeros_like(p)
        torch.testing.assert_close(grad, want[name], **GRAD,
                                   msg=lambda m, n=name: f"{n}: {m}")
    with torch.no_grad():
        plain = model(*(tin[k] for k in ("input_ids", "ctx_ids", "ctx_mask",
                                         "token_type_ids",
                                         "ctx_token_type_ids", "img_feats")))
    torch.testing.assert_close(plain, logits.detach(), rtol=0, atol=0)


def test_decode_logits_match_jax(jax_results):
    """The recompute forward's head at one position equals the JAX
    forward's logits there."""
    model = port_model(jax_results)
    tin = to_torch(jax_results["inputs"])
    with torch.no_grad():
        got = model.decode_logits(tin["input_ids"], tin["ctx_ids"],
                                  tin["ctx_mask"], tin["token_type_ids"],
                                  tin["ctx_token_type_ids"],
                                  tin["img_feats"], 3)
    close(got.numpy(), jax_results["recompute"])


def test_prefill_matches_jax(jax_results):
    model = port_model(jax_results)
    tin = to_torch(jax_results["inputs"])
    with torch.no_grad():
        cache = model.prefill(tin["ctx_ids"], tin["ctx_mask"],
                              tin["ctx_token_type_ids"], tin["img_feats"], LC)
    jcfg = jax_results["jcfg"]
    assert cache.shape == (jcfg.num_hidden_layers, B, LC + T + R,
                           jcfg.hidden_size)
    assert not cache[:, :, :LC].any()
    close(cache.numpy(), jax_results["decoded"][0][1])


@pytest.mark.parametrize("t", STEPS)
def test_decode_step_matches_jax(jax_results, t):
    """The port's prefill, then its decode steps over the committed prefix
    up to t: the logits at t and the cache (slot t - 1 written in place)
    equal the JAX calls'."""
    model = port_model(jax_results)
    tin = to_torch(jax_results["inputs"])
    prefix = torch.from_numpy(jax_results["prefix"])
    with torch.no_grad():
        cache = model.prefill(tin["ctx_ids"], tin["ctx_mask"],
                              tin["ctx_token_type_ids"], tin["img_feats"], LC)
        for s in range(1, t + 1):
            before = cache
            logits, cache = model.decode_step(cache, s, prefix[:, s - 1],
                                              tin["ctx_mask"], LC, MASK)
            assert cache is before
    want_logits, want_cache = jax_results["decoded"][t]
    close(logits.numpy(), want_logits)
    close(cache.numpy(), want_cache)
    assert not cache[:, :, t:LC].any()


def test_strict_loads(jax_results):
    """A JAX tree loads strictly (the fixture's models); the JAX exporter's
    reference state dict, with `cls.predictions.decoder.weight` a copy of
    the whole table, loads strictly to the same weights; a copy that is not
    the table raises, and a missing head raises."""
    model = port_model(jax_results)
    sd = model.state_dict()
    vocab = jax_results["jcfg"].vocab_size
    assert sd["cls.predictions.bias"].shape == (vocab,)
    ref = {k: torch.from_numpy(np.array(v))
           for k, v in export_state_dict(jax_results["params"]).items()}
    assert ref["cls.predictions.decoder.weight"].shape[0] == vocab
    fresh = pib.CaptioningModel(port_config(jax_results["jcfg"]),
                                device="cpu", seed=9)
    fresh.load_state_dict(ref, strict=True)
    for k, v in fresh.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    bad = dict(ref)
    bad["cls.predictions.decoder.weight"] = (
        bad["cls.predictions.decoder.weight"][:-1])
    with pytest.raises(ValueError, match="decoder.weight"):
        fresh.load_state_dict(bad, strict=True)
    missing = {k: v for k, v in ref.items() if k != "cls.predictions.bias"}
    with pytest.raises(RuntimeError, match="cls.predictions.bias"):
        fresh.load_state_dict(missing, strict=True)


# ---------------------------------------------------------------------------
# the port's cached decoding against its recompute decoding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("beams", [1, 3])
def test_cached_decoding_equals_recompute(jax_results, beams):
    """Greedy (logprobs within 2e-4) and beam search (scores within 2e-4)
    over the tiny model: the cached and the recompute sequences are
    equal."""
    model = port_model(jax_results)
    tin = to_torch(jax_results["inputs"])
    rb, rm, rs, rf = (tin[k].repeat_interleave(beams, 0) for k in (
        "ctx_ids", "ctx_mask", "ctx_token_type_ids", "img_feats"))
    seg = torch.zeros(B * beams, LC, dtype=torch.int32)

    def logits_fn(tokens, t):
        return model.decode_logits(tokens, rb, rm, seg, rs, rf, t)

    def prefill():
        return model.prefill(rb, rm, rs, rf, LC)

    def step(cache, t, prev):
        return model.decode_step(cache, t, prev, rm, LC, MASK)

    with torch.no_grad():
        if beams == 1:
            full = generate(logits_fn, BOS, EOS, PAD, MASK, B, LC,
                            device="cpu")
            cached = generate_cached(prefill, step, BOS, EOS, PAD, B, LC,
                                     device="cpu")
            torch.testing.assert_close(cached.sequences, full.sequences,
                                       rtol=0, atol=0)
            close(cached.logprobs.numpy(), full.logprobs.numpy())
            return
        seqs, scores = beam_search(logits_fn, BOS, EOS, PAD, MASK, B, LC,
                                   beams, device="cpu")
        cseqs, cscores = beam_search_cached(prefill, step, BOS, EOS, PAD, B,
                                            LC, beams, mask_token_id=MASK,
                                            device="cpu")
    torch.testing.assert_close(cseqs, seqs, rtol=0, atol=0)
    close(cscores.numpy(), scores.numpy())
