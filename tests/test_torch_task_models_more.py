"""The port's WREModel, CaseModel, MLMModel, RepModel and the retrieval
model's `encode_text_only` / `encode_image_only` against the JAX package's,
on the CPU.

The tiny config and shapes are `tests/test_torch_finetune_models.py`'s (B 4,
LA 10, T 5, R 4; hidden 32, 2+2+2 layers, dropouts 0) with padded captions
and regions. One JAX init of `MLMModel` (the backbone and the tied LM head)
plus seeded noise gives every model's weights: the `bert` subtree alone for
WRE, Case and Rep, with `cls_predictions` for MLM, with a seeded classifier
and `logit_scale` for retrieval; each loads into the port with
`load_jax_params(strict=True)`.

- `WREModel` mods 1, 2 and 3: the loss within 2e-4, the region scores within
  5e-4 and every parameter's gradient within 1e-3 relative (plus 1e-6
  absolute) of `jax.grad`'s. The hard-negative slot permutation is pinned on
  both sides (the JAX side's `jax.random.permutation` returns it), and mods
  2 and 3 pass the same WRA `pick` (and mod 3 the same negative offset) to
  both packages' WRA losses.
- `CaseModel` at the output and at fusion layer 0: the cosine matrices within
  5e-4, the validity masks equal.
- `MLMModel`: the `[B, LA, only_word_size]` scores within 5e-4; in bf16 over
  the same weights within 0.05 of the JAX fp32 scores (as
  `tests/test_models.py:258-280` holds bf16), and the argmax ids equal
  wherever the JAX fp32 top-2 gap exceeds that.
- `RepModel`: the four outputs under the JAX names, stream outputs within
  2e-4, fused outputs within 5e-4.
- `encode_text_only` / `encode_image_only`: within 2e-4.
- Strict loads of the five models the serving and task paths build (NLVR,
  MLM, Rep, WRE, Case): a missing or an extra flax path raises.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvp_pytorch_tpu.models import tiny_config as jax_tiny_config
from mvp_pytorch_tpu.models import tasks as jt
from mvp_pytorch_tpu_torch.convert import (jax_params_to_state_dict,
                                           load_jax_params)
from mvp_pytorch_tpu_torch.models import ModelConfig
from mvp_pytorch_tpu_torch.models import tasks as pt

B, LA, T, R = 4, 10, 5, 4
STREAM_TOL, FUSED_TOL, LOSS_TOL = 2e-4, 5e-4, 2e-4
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-6
BF16_TOL = 0.05
DICE = np.array([2, 0, 3, 1], np.int32)        # the pinned slot permutation
PICK, NEG_OFFSET = 1, 2                        # the pinned WRA choices
PHRASE_INDEX = np.array([[1, 4], [2, 6], [3, 3], [1, 5]], np.int32)
IMG_INDEX = np.array([[LA, LA + R]] * B, np.int32)
PHRASE_WIDTH = 4


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    """torch single-threaded in this process: no intra-op thread pool is left
    behind for a later test in the same worker that forks."""
    torch.set_num_threads(1)


def make_inputs(cfg, seed=0):
    """The seven inputs, two captions and one image padded."""
    r = np.random.RandomState(seed)
    mask_a = np.ones((B, LA), np.int32)
    mask_a[1::2, LA - 3:] = 0
    mask_b = np.ones((B, T + R), np.int32)
    mask_b[1, T + R - 1:] = 0
    return (r.randint(1, cfg.only_word_size, (B, LA)).astype(np.int32),
            mask_a, np.zeros((B, LA), np.int32),
            r.randint(1, cfg.only_word_size, (B, T)).astype(np.int32),
            mask_b, np.ones((B, T), np.int32),
            r.randn(B, R, cfg.img_feature_dim).astype(np.float32))


def seeded_params(cfg, inputs):
    """JAX MLMModel init plus seeded noise, as numpy; a seeded linear
    classifier and logit_scale beside it."""
    model = jt.MLMModel(cfg)
    params = jax.jit(lambda: model.init(
        jax.random.PRNGKey(3), *map(jnp.asarray, inputs),
        max_tag_length=T))()["params"]
    r = np.random.RandomState(11)
    params = jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + 0.05 * r.randn(*v.shape)).astype(
            np.float32), params)
    h = cfg.hidden_size
    classifier = {"out": {"kernel": (0.2 * r.randn(h, 2)).astype(np.float32),
                          "bias": (0.1 * r.randn(2)).astype(np.float32)}}
    return params, classifier


def tree_for(name, params, classifier):
    """The flax tree of model `name`."""
    if name == "MLMModel":
        return params
    if name == "NLVRModel":
        return {"bert": params["bert"], "classifier": classifier}
    if name == "RetrievalModel":
        return {"bert": params["bert"], "classifier": classifier,
                "logit_scale": np.asarray(np.log(1 / 0.07), np.float32)}
    return {"bert": params["bert"]}


@pytest.fixture(scope="module")
def setup():
    cfg = jax_tiny_config()
    inputs = make_inputs(cfg)
    params, classifier = seeded_params(cfg, inputs)
    return cfg, inputs, params, classifier


def port_model(name, cfg, tree, dtype="float32"):
    pcfg = ModelConfig.from_dict(dataclasses.asdict(cfg), dtype=dtype)
    return load_jax_params(getattr(pt, name)(pcfg, device="cpu"), tree)


def as_torch(arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.fixture(scope="module")
def wre_results(setup):
    """mod -> the JAX loss, scores and grads with the permutation, the WRA
    pick and the negative offset pinned."""
    cfg, inputs, params, classifier = setup
    tree = tree_for("WREModel", params, classifier)
    model = jt.WREModel(cfg)
    x = tuple(map(jnp.asarray, inputs))
    spans = (jnp.asarray(PHRASE_INDEX), jnp.asarray(IMG_INDEX))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "permutation",
                   lambda key, n: jnp.asarray(DICE))
        mp.setattr(jt, "wra_hard_loss",
                   functools.partial(jt.wra_hard_loss, pick=PICK))
        mp.setattr(jt, "wra_sample_loss",
                   functools.partial(jt.wra_sample_loss, pick=PICK,
                                     neg_offset=NEG_OFFSET))
        for mod in (1, 2, 3):
            def loss(p, mod=mod):
                return model.apply(
                    {"params": p}, *x, *spans, max_tag_length=T, mod=mod,
                    wra_phrase_width=PHRASE_WIDTH,
                    rngs={"hardneg": jax.random.PRNGKey(0),
                          "wra": jax.random.PRNGKey(1)})
            (jloss, jlogits), jgrads = jax.jit(
                jax.value_and_grad(loss, has_aux=True))(tree)
            out[mod] = dict(loss=float(jloss), logits=np.asarray(jlogits),
                            grads=jax_params_to_state_dict(
                                jax.tree_util.tree_map(np.asarray, jgrads)))
    return tree, out


@pytest.mark.parametrize("mod", [1, 2, 3])
def test_wre_model_matches_jax(setup, wre_results, mod):
    cfg, inputs, _, _ = setup
    tree, res = wre_results
    want = res[mod]
    model = port_model("WREModel", cfg, tree)
    loss, logits = model(*as_torch(inputs), *as_torch((PHRASE_INDEX,
                                                      IMG_INDEX)),
                         max_tag_length=T, mod=mod,
                         wra_phrase_width=PHRASE_WIDTH,
                         hn_dice=torch.from_numpy(DICE), wra_pick=PICK,
                         wra_neg_offset=NEG_OFFSET)
    np.testing.assert_allclose(logits.detach().numpy(), want["logits"],
                               atol=FUSED_TOL, rtol=0)
    assert abs(loss.item() - want["loss"]) <= LOSS_TOL, (loss.item(),
                                                         want["loss"])
    assert want["loss"] > 0.01                 # the margin is active
    loss.backward()
    params = dict(model.named_parameters())
    assert set(params) == set(want["grads"])
    nonzero = 0
    for name, p in params.items():
        g_want = want["grads"][name].numpy()
        g_got = (np.zeros_like(g_want) if p.grad is None
                 else p.grad.numpy().reshape(g_want.shape))
        err = np.linalg.norm(g_got - g_want)
        assert err <= GRAD_RTOL * np.linalg.norm(g_want) + GRAD_ATOL, (
            name, err, np.linalg.norm(g_want))
        nonzero += bool(np.linalg.norm(g_want) > 0)
    assert nonzero > len(params) // 2


def test_wre_model_mod3_skips_the_hard_negative_pass(setup, wre_results):
    """Mod 3 never reads the hard pairs: one fusion pass, not two."""
    cfg, inputs, _, _ = setup
    model = port_model("WREModel", cfg, wre_results[0])
    calls = []
    real = model.bert.fuse
    model.bert.fuse = lambda *a, **k: calls.append(1) or real(*a, **k)
    with torch.no_grad():
        for mod in (1, 3):
            calls.clear()
            model(*as_torch(inputs), *as_torch((PHRASE_INDEX, IMG_INDEX)),
                  max_tag_length=T, mod=mod, wra_phrase_width=PHRASE_WIDTH,
                  hn_dice=torch.from_numpy(DICE), wra_pick=PICK,
                  wra_neg_offset=NEG_OFFSET)
            assert len(calls) == (2 if mod == 1 else 1), (mod, calls)


@pytest.fixture(scope="module")
def inference_results(setup):
    """The JAX outputs of CaseModel (output and layer 0), MLMModel (fp32),
    RepModel and the retrieval encoders."""
    cfg, inputs, params, classifier = setup
    x = tuple(map(jnp.asarray, inputs))
    spans = (jnp.asarray(PHRASE_INDEX), jnp.asarray(IMG_INDEX))
    out = {}
    case_tree = tree_for("CaseModel", params, classifier)
    for layer in (None, 0):
        out[("case", layer)] = jax.tree_util.tree_map(
            np.asarray, jt.CaseModel(cfg).apply(
                {"params": case_tree}, *x, *spans, max_tag_length=T,
                phrase_width=PHRASE_WIDTH, phrase_layer=layer))
    out["mlm"] = np.asarray(jax.jit(lambda p: jt.MLMModel(cfg).apply(
        {"params": p}, *x, max_tag_length=T))(params))
    out["rep"] = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda p: jt.RepModel(cfg).apply({"params": p}, *x,
                                         max_tag_length=T))(
        tree_for("RepModel", params, classifier)))
    rtree = tree_for("RetrievalModel", params, classifier)
    rmodel = jt.RetrievalModel(cfg)
    out["text_only"] = np.asarray(rmodel.apply(
        {"params": rtree}, *x[:3], method=rmodel.encode_text_only))
    out["image_only"] = np.asarray(rmodel.apply(
        {"params": rtree}, *x[3:], method=rmodel.encode_image_only))
    return out


@pytest.mark.parametrize("layer", [None, 0])
def test_case_model_matches_jax(setup, inference_results, layer):
    cfg, inputs, params, classifier = setup
    model = port_model("CaseModel", cfg, tree_for("CaseModel", params,
                                                  classifier))
    with torch.no_grad():
        sims, ph_valid, im_valid = model(
            *as_torch(inputs), *as_torch((PHRASE_INDEX, IMG_INDEX)),
            max_tag_length=T, phrase_width=PHRASE_WIDTH, phrase_layer=layer)
    want = inference_results[("case", layer)]
    assert sims.shape == (B, PHRASE_WIDTH, R)
    np.testing.assert_allclose(sims.numpy(), want[0], atol=FUSED_TOL, rtol=0)
    np.testing.assert_array_equal(ph_valid.numpy(), want[1])
    np.testing.assert_array_equal(im_valid.numpy(), want[2])
    assert ph_valid.numpy()[2].sum() == 0      # the empty phrase span


def test_mlm_model_matches_jax(setup, inference_results):
    cfg, inputs, params, classifier = setup
    want = inference_results["mlm"]
    assert want.shape == (B, LA, cfg.only_word_size)
    with torch.no_grad():
        got = port_model("MLMModel", cfg, params)(*as_torch(inputs),
                                                  max_tag_length=T)
        got16 = port_model("MLMModel", cfg, params, "bfloat16")(
            *as_torch(inputs), max_tag_length=T)
    np.testing.assert_allclose(got.numpy(), want, atol=FUSED_TOL, rtol=0)
    assert got16.dtype == torch.float32
    np.testing.assert_allclose(got16.numpy(), want, atol=BF16_TOL, rtol=0)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * BF16_TOL
    assert clear.sum() > 0
    np.testing.assert_array_equal(got16.numpy().argmax(-1)[clear],
                                  want.argmax(-1)[clear])


def test_rep_model_matches_jax(setup, inference_results):
    cfg, inputs, params, classifier = setup
    model = port_model("RepModel", cfg, tree_for("RepModel", params,
                                                 classifier))
    with torch.no_grad():
        got = model(*as_torch(inputs), max_tag_length=T)
    want = inference_results["rep"]
    assert set(got) == set(want) == {"cross_modal_output", "pooled_output",
                                     "txt_encoder_output",
                                     "vis_encoder_output"}
    tol = {"txt_encoder_output": STREAM_TOL, "vis_encoder_output": STREAM_TOL}
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].float().numpy(), want[k],
                                   atol=tol.get(k, FUSED_TOL), rtol=0,
                                   err_msg=k)


def test_retrieval_encode_only_matches_jax(setup, inference_results):
    cfg, inputs, params, classifier = setup
    model = port_model("RetrievalModel", cfg,
                       tree_for("RetrievalModel", params, classifier))
    x = as_torch(inputs)
    with torch.no_grad():
        txt = model.encode_text_only(*x[:3])
        img = model.encode_image_only(*x[3:])
    np.testing.assert_allclose(txt.numpy(), inference_results["text_only"],
                               atol=STREAM_TOL, rtol=0)
    np.testing.assert_allclose(img.numpy(), inference_results["image_only"],
                               atol=STREAM_TOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(txt.numpy(), axis=1), 1.0,
                               atol=1e-5)


# model -> the head keys its state dict holds beside bert.*
HEAD_KEYS = {
    "NLVRModel": ["classifier.bias", "classifier.weight"],
    "MLMModel": sorted(f"cls.predictions.{k}" for k in (
        "bias", "transform.dense.bias", "transform.dense.weight",
        "transform.LayerNorm.bias", "transform.LayerNorm.weight")),
    "RepModel": [], "WREModel": [], "CaseModel": [],
}


@pytest.mark.parametrize("name", list(HEAD_KEYS))
def test_strict_loads(setup, name):
    """Each model's flax tree loads strictly under the reference's keys; a
    missing head or an extra flax path raises."""
    cfg, _, params, classifier = setup
    tree = tree_for(name, params, classifier)
    sd = jax_params_to_state_dict(tree)
    assert sorted(k for k in sd if not k.startswith("bert.")) == \
        HEAD_KEYS[name]
    model = port_model(name, cfg, tree)
    extra = dict(tree, extra_head={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="extra_head"):
        load_jax_params(model, extra)
    if HEAD_KEYS[name]:
        head = "classifier" if name == "NLVRModel" else "cls_predictions"
        with pytest.raises(RuntimeError, match="Missing key"):
            load_jax_params(model, {k: v for k, v in tree.items()
                                    if k != head})


def test_mlm_model_drops_a_reference_tied_decoder(setup):
    """A reference state dict's `cls.predictions.decoder.weight` (the first
    only_word_size rows of the table) loads strictly; a different one
    raises."""
    cfg, _, params, _ = setup
    sd = jax_params_to_state_dict(params)
    table = sd["bert.embeddings.word_embeddings.weight"]
    sd["cls.predictions.decoder.weight"] = table[:cfg.only_word_size].clone()
    model = port_model("MLMModel", cfg, params)
    model.load_state_dict(sd, strict=True)
    sd["cls.predictions.decoder.weight"] = sd[
        "cls.predictions.decoder.weight"] + 1.0
    with pytest.raises(ValueError, match="ties the decoder"):
        model.load_state_dict(sd, strict=True)
