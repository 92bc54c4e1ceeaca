"""The port's single-stream models (`models/img_bert.py`) and their
converter paths against the JAX package's, in fp32 on the CPU.

- `ImgBertModel`: the sequence and pooled outputs (within 2e-4) with a
  `[B, L]` mask (and the region LayerNorm), a `[B, L, L]` mask, a list of
  per-layer masks, and in the `dis_code` and `dis_code_t` variants;
- `ImgBertForPreTraining`: the losses (within 2e-4) and every parameter's
  gradient (atol 2e-4, rtol 1e-3) against `jax.value_and_grad`, with the
  masked-region heads (ITM rows labelled -1, a masked region without a tag
  label) and without them;
- `ImgBertForSequenceClassification` and `ImgBertForMultipleChoice`: logits
  and loss (within 2e-4) with `loss_type` CE and `bce`, a linear and an MLP
  classifier;
- the strict loads: JAX trees with and without the masked-region heads,
  and the JAX exporter's reference state dict with `cls.MRF_*` and the tied
  decoder copy;
- one dropout step is finite and repeatable from a generator seed.

Weights are the JAX models' seeded inits, carried by `load_jax_params`. The
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
from mvp_pytorch_tpu.models import tiny_config as jax_tiny_config
from mvp_pytorch_tpu_torch.convert import (jax_params_to_state_dict,
                                           load_jax_params)
from mvp_pytorch_tpu_torch.models import ModelConfig
from mvp_pytorch_tpu_torch.models import img_bert as pib

TOL = 2e-4
GRAD = dict(atol=2e-4, rtol=1e-3)
B, LT, R, TAGS = 4, 12, 5, 11
CODE_VOC, CODE_DIM = 17, 8


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    """torch single-threaded in this process: no intra-op thread pool is left
    behind for a later test in the same worker that forks."""
    torch.set_num_threads(1)


def port_config(jcfg):
    return ModelConfig.from_dict(dataclasses.asdict(jcfg))


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def text_inputs(rs, b=B):
    ids = rs.randint(1, 99, (b, LT)).astype(np.int32)
    seg = np.zeros((b, LT), np.int32)
    seg[:, LT // 2:] = 1
    return ids, seg


def padded_mask(b=B, l=LT + R):
    mask = np.ones((b, l), np.int32)
    mask[1, LT - 3:LT] = 0                     # padded text
    mask[2, l - 2:] = 0                        # padded regions
    return mask


def query_mask(rs, b=B, l=LT + R):
    mask = (rs.rand(b, l, l) > 0.3).astype(np.int32)
    mask[..., 0] = 1
    return mask


# ---------------------------------------------------------------------------
# ImgBertModel
# ---------------------------------------------------------------------------

BACKBONES = ("mask_2d", "mask_3d", "per_layer", "dis_code", "dis_code_t")


def backbone_case(case, rs):
    """(JAX config overrides, model kwargs, port model kwargs, inputs)."""
    ids, seg = text_inputs(rs)
    img = rs.randn(B, R, 22).astype(np.float32)
    over, kw, pkw = {}, {}, {}
    if case == "mask_2d":
        over = dict(use_img_layernorm=True, img_layer_norm_eps=1e-5)
        mask = padded_mask()
    elif case == "mask_3d":
        mask = query_mask(rs)
    elif case == "per_layer":
        mask = [padded_mask(), query_mask(rs), np.ones((B, LT + R), np.int32),
                query_mask(rs)]
    else:
        over = dict(img_feature_type=case)
        kw = dict(code_voc=CODE_VOC, code_dim=CODE_DIM)
        pkw = dict(kw, code_size=R if case == "dis_code_t" else 0)
        img = rs.randint(0, CODE_VOC, (B, R)).astype(np.int32)
        n_img = CODE_DIM if case == "dis_code_t" else R
        mask = padded_mask(l=LT + n_img)
    return over, kw, pkw, (ids, mask, seg, img)


@pytest.fixture(scope="module")
def backbones():
    """case -> (JAX config, port kwargs, params, inputs, (seq, pooled))."""
    out = {}
    for i, case in enumerate(BACKBONES):
        rs = np.random.RandomState(10 + i)
        over, kw, pkw, (ids, mask, seg, img) = backbone_case(case, rs)
        jcfg = jax_tiny_config(**over)
        model = jib.ImgBertModel(jcfg, **kw)
        jmask = ([jnp.asarray(m) for m in mask] if isinstance(mask, list)
                 else jnp.asarray(mask))
        args = (jnp.asarray(ids), jmask, jnp.asarray(seg))
        params = jax.jit(lambda a, im: model.init(
            jax.random.PRNGKey(i), *a, img_feats=im))(args, jnp.asarray(img))
        seq, pooled = jax.jit(lambda p, a, im: model.apply(
            p, *a, img_feats=im))(params, args, jnp.asarray(img))
        out[case] = (jcfg, pkw, numpy_tree(params["params"]),
                     (ids, mask, seg, img), (np.asarray(seq),
                                             np.asarray(pooled)))
    return out


def to_torch(x):
    if isinstance(x, list):
        return [torch.from_numpy(m) for m in x]
    return None if x is None else torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("case", BACKBONES)
def test_backbone_matches_jax(backbones, case):
    jcfg, pkw, params, (ids, mask, seg, img), (seq, pooled) = backbones[case]
    model = load_jax_params(
        pib.ImgBertModel(port_config(jcfg), **pkw).eval(), params)
    with torch.no_grad():
        got_seq, got_pooled = model(to_torch(ids), to_torch(mask),
                                    to_torch(seg), img_feats=to_torch(img))
    assert got_seq.shape == seq.shape
    np.testing.assert_allclose(got_seq.numpy(), seq, atol=TOL, rtol=0)
    np.testing.assert_allclose(got_pooled.numpy(), pooled, atol=TOL, rtol=0)
    if case == "mask_2d":
        assert "LayerNorm.weight" in model.state_dict()
    if case.startswith("dis_code"):
        assert tuple(model.code_embeddings.weight.shape) == (CODE_VOC,
                                                             CODE_DIM)


def test_backbone_masks_change_the_output(backbones):
    """The per-layer list is not read as one mask: its output differs from
    the first mask's alone."""
    jcfg, pkw, params, (ids, mask, seg, img), _ = backbones["per_layer"]
    model = load_jax_params(pib.ImgBertModel(port_config(jcfg)).eval(),
                            params)
    with torch.no_grad():
        staged, _ = model(to_torch(ids), to_torch(mask), to_torch(seg),
                          img_feats=to_torch(img))
        single, _ = model(to_torch(ids), to_torch(mask[0]), to_torch(seg),
                          img_feats=to_torch(img))
    assert float((staged - single).abs().max()) > 1e-3
    with pytest.raises(ValueError, match="biases for 4 layers"):
        model(to_torch(ids), to_torch(mask[:3]), to_torch(seg),
              img_feats=to_torch(img))


# ---------------------------------------------------------------------------
# ImgBertForPreTraining
# ---------------------------------------------------------------------------

PRETRAIN_CASES = {"mrfr": True, "mlm_itm": False}
LOSSES = ("mlm_loss", "itm_loss", "mrc_loss", "mrf_loss", "total_loss")
MAX_PRED = 6


def pretrain_inputs(seed, mrfr=True):
    rs = np.random.RandomState(seed)
    ids, seg = text_inputs(rs)
    img = rs.randn(B, R, 22).astype(np.float32)
    labels = np.full((B, LT), -1, np.int32)
    labels[:, 2:5] = rs.randint(0, 99, (B, 3))
    labels[1, 3] = -1
    batch = dict(input_ids=ids, attention_mask=padded_mask(),
                 token_type_ids=seg, img_feats=img, masked_lm_labels=labels,
                 next_sentence_label=np.array([0, 1, -1, 1], np.int32))
    if mrfr:
        flags = (rs.rand(B, R) < 0.4).astype(np.int32)
        flags[:, 0] = 1
        region_labels = np.where(flags > 0, rs.randint(0, TAGS, (B, R)), -1)
        region_labels[0, 0] = -1        # masked, its tag not in the vocab
        targets = img.copy()
        img[flags > 0] = 0.0
        batch.update(masked_region_labels=region_labels.astype(np.int32),
                     masked_region_targets=targets,
                     masked_region_flags=flags)
    return batch


@pytest.fixture(scope="module")
def pretrain_results():
    """case -> (JAX config, params, batch, JAX losses, JAX grads as the
    port's state-dict keys)."""
    jcfg = jax_tiny_config()
    out = {}
    for i, (case, mrfr) in enumerate(PRETRAIN_CASES.items()):
        model = jib.ImgBertForPreTraining(jcfg, use_mrfr=mrfr,
                                          od_tag_size=TAGS)
        batch = pretrain_inputs(20 + i, mrfr)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        params = jax.jit(lambda: model.init(
            jax.random.PRNGKey(i), **jb, max_pred=MAX_PRED,
            deterministic=True))()["params"]

        def loss(p):
            o = model.apply({"params": p}, **jb, max_pred=MAX_PRED,
                            deterministic=True)
            return o["total_loss"], o
        (_, jout), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            params)
        out[case] = (jcfg, numpy_tree(params), batch,
                     {k: float(v) for k, v in jout.items()},
                     jax_params_to_state_dict(numpy_tree(grads)))
    return out


def port_pretrain(jcfg, params, mrfr=True, **over):
    model = pib.ImgBertForPreTraining(
        dataclasses.replace(port_config(jcfg), **over), use_mrfr=mrfr,
        od_tag_size=TAGS, device="cpu")
    return load_jax_params(model, params)


@pytest.mark.parametrize("case", list(PRETRAIN_CASES))
def test_pretrain_losses_and_grads_match_jax(pretrain_results, case):
    jcfg, params, batch, jout, jgrads = pretrain_results[case]
    mrfr = PRETRAIN_CASES[case]
    model = port_pretrain(jcfg, params, mrfr)
    model.train()
    out = model(**{k: to_torch(v) for k, v in batch.items()},
                max_pred=MAX_PRED)
    names = LOSSES if mrfr else ("mlm_loss", "itm_loss", "total_loss")
    assert set(out) == set(names) == set(jout)
    for name in names:
        assert abs(out[name].item() - jout[name]) <= TOL, (
            name, out[name].item(), jout[name])
    out["total_loss"].backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(jgrads)
    for name, g in grads.items():
        assert g is not None, name
        np.testing.assert_allclose(g.numpy(), jgrads[name].numpy(), **GRAD,
                                   err_msg=name)
    table = grads["bert.embeddings.word_embeddings.weight"]
    assert float(table[99:].abs().max()) == 0      # no phrase rows read
    if mrfr:
        for name in ("cls.MRF_bias", "cls.MRC_predictor.weight",
                     "cls.MRF_predictor.0.weight",
                     "bert.img_embedding.weight"):
            assert float(grads[name].abs().max()) > 0, name


def test_mrf_weights_regions_by_flags_and_the_projection_by_both_uses(
        pretrain_results):
    """The MRF loss counts the flagged region whose label is -1; the region
    projection's gradient is the embedding's plus the tied head's."""
    jcfg, params, batch, _, _ = pretrain_results["mrfr"]
    model = port_pretrain(jcfg, params)
    tb = {k: to_torch(v) for k, v in batch.items()}
    mrf = model(**tb, max_pred=MAX_PRED)["mrf_loss"]
    by_labels = model(**{**tb, "masked_region_flags": None},
                      max_pred=MAX_PRED)["mrf_loss"]
    assert abs(mrf.item() - by_labels.item()) > 1e-6
    # without the tied head's use (the weight detached there) the
    # projection's gradient is the embedding's alone
    weight = model.bert.img_embedding.weight
    whole = torch.autograd.grad(mrf, weight)[0]
    model.bert.img_kernel = lambda: weight.detach()
    embedding_only = torch.autograd.grad(
        model(**tb, max_pred=MAX_PRED)["mrf_loss"], weight)[0]
    assert float((whole - embedding_only).abs().max()) > 0
    del model.bert.img_kernel
    with pytest.raises(ValueError, match="masked_region_targets"):
        model(**{**tb, "masked_region_targets": None}, max_pred=MAX_PRED)


def test_pretrain_dropout_step_is_repeatable(pretrain_results):
    jcfg, params, batch, _, _ = pretrain_results["mrfr"]
    tb = {k: to_torch(v) for k, v in batch.items()}

    def step(p, seed):
        model = port_pretrain(jcfg, params, hidden_dropout_prob=p,
                              attention_probs_dropout_prob=p)
        model.train()
        return model(**tb, max_pred=MAX_PRED,
                     generator=torch.Generator().manual_seed(seed))
    a, b, c, z = step(0.1, 3), step(0.1, 3), step(0.1, 4), step(0.0, 3)
    for name in LOSSES:
        assert torch.isfinite(a[name]) and torch.equal(a[name], b[name])
    assert a["total_loss"].item() != c["total_loss"].item()
    assert a["total_loss"].item() != z["total_loss"].item()
    model = port_pretrain(jcfg, params, hidden_dropout_prob=0.1)
    model.train()
    with pytest.raises(RuntimeError, match="generator"):
        model(**tb, max_pred=MAX_PRED)


@pytest.mark.parametrize("mrfr", [True, False])
def test_pretrain_trees_load_strictly(pretrain_results, mrfr):
    """A tree with the masked-region heads loads into the model that has
    them and into no other; the reference state dict the JAX exporter
    writes (`cls.MRF_*`, the tied `cls.predictions.decoder.weight`) loads
    strictly, and a decoder that is not the table's rows raises."""
    jcfg, params, _, _, _ = pretrain_results["mrfr" if mrfr else "mlm_itm"]
    model = port_pretrain(jcfg, params, mrfr)
    sd = model.state_dict()
    assert ("cls.MRF_bias" in sd) == mrfr
    if mrfr:
        np.testing.assert_array_equal(sd["cls.MRF_bias"].numpy(),
                                      params["mrf_mrc"]["mrf_bias"])
        np.testing.assert_array_equal(
            sd["cls.MRF_predictor.2.weight"].numpy(),
            params["mrf_mrc"]["mrf_norm"]["scale"])
        np.testing.assert_array_equal(
            sd["cls.MRC_predictor.weight"].numpy(),
            params["mrf_mrc"]["mrc"]["kernel"].T)
    wrong = pib.ImgBertForPreTraining(port_config(jcfg), use_mrfr=not mrfr,
                                      od_tag_size=TAGS, device="cpu")
    with pytest.raises(RuntimeError):
        load_jax_params(wrong, params)
    ref = {k: torch.from_numpy(np.asarray(v))
           for k, v in export_state_dict(params).items()}
    assert "cls.predictions.decoder.weight" in ref
    assert any(k.startswith("cls.MRF_") for k in ref) == mrfr
    fresh = pib.ImgBertForPreTraining(port_config(jcfg), use_mrfr=mrfr,
                                      od_tag_size=TAGS, device="cpu")
    fresh.load_state_dict(ref, strict=True)
    for k, v in fresh.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    bad = dict(ref)
    bad["cls.predictions.decoder.weight"] = (
        bad["cls.predictions.decoder.weight"] + 1e-3)
    with pytest.raises(ValueError, match="decoder.weight"):
        fresh.load_state_dict(bad, strict=True)


# ---------------------------------------------------------------------------
# classification and multiple choice
# ---------------------------------------------------------------------------

# case -> (model, config overrides, label kind)
CLS_CASES = {
    "seq_linear_ce": ("seq", dict(classifier="linear", loss_type="sfmx",
                                  num_labels=3), "int"),
    "seq_mlp_bce": ("seq", dict(classifier="mlp", loss_type="bce",
                                num_labels=3), "soft"),
    "choice_ce": ("choice", dict(loss_type="sfmx", num_labels=3), "int"),
    "choice_bce_mlp": ("choice", dict(classifier="mlp", loss_type="bce",
                                      num_labels=3), "soft"),
}
CHOICES = 3


def cls_inputs(kind, labels, seed):
    rs = np.random.RandomState(seed)
    shape = (B,) if kind == "seq" else (B, CHOICES)
    ids = rs.randint(1, 99, shape + (LT,)).astype(np.int32)
    seg = np.zeros(shape + (LT,), np.int32)
    mask = np.ones(shape + (LT + R,), np.int32)
    mask[..., 1:2, LT - 2:LT] = 0
    img = rs.randn(*shape, R, 22).astype(np.float32)
    y = (rs.randint(0, 3, B).astype(np.int32) if labels == "int"
         else rs.rand(B, 3).astype(np.float32))
    return ids, mask, seg, img, y


@pytest.fixture(scope="module")
def cls_results():
    out = {}
    for i, (case, (kind, over, labels)) in enumerate(CLS_CASES.items()):
        jcfg = jax_tiny_config(**over)
        model = (jib.ImgBertForSequenceClassification(jcfg) if kind == "seq"
                 else jib.ImgBertForMultipleChoice(jcfg, num_choice=CHOICES))
        ids, mask, seg, img, y = cls_inputs(kind, labels, 30 + i)
        args = tuple(jnp.asarray(x) for x in (ids, mask, seg, img))
        params = jax.jit(lambda a: model.init(jax.random.PRNGKey(i), *a))(
            args)
        loss, logits = jax.jit(lambda p, a, t: model.apply(p, *a, labels=t))(
            params, args, jnp.asarray(y))
        out[case] = (jcfg, numpy_tree(params["params"]),
                     (ids, mask, seg, img, y), float(loss),
                     np.asarray(logits))
    return out


@pytest.mark.parametrize("case", list(CLS_CASES))
def test_classifiers_match_jax(cls_results, case):
    kind = CLS_CASES[case][0]
    jcfg, params, (ids, mask, seg, img, y), loss, logits = cls_results[case]
    cfg = port_config(jcfg)
    model = (pib.ImgBertForSequenceClassification(cfg, device="cpu")
             if kind == "seq" else
             pib.ImgBertForMultipleChoice(cfg, num_choice=CHOICES,
                                          device="cpu"))
    load_jax_params(model, params)
    inputs = [to_torch(x) for x in (ids, mask, seg, img)]
    with torch.no_grad():
        got_loss, got_logits = model(*inputs, labels=to_torch(y))
        alone = model(*inputs)
    assert got_logits.dtype == torch.float32
    np.testing.assert_allclose(got_logits.numpy(), logits, atol=TOL, rtol=0)
    assert abs(got_loss.item() - loss) <= TOL, (got_loss.item(), loss)
    torch.testing.assert_close(alone, got_logits, rtol=0, atol=0)
    if kind == "choice":
        with pytest.raises(ValueError, match="choices"):
            model(*(x[:, :2] for x in inputs))


def test_classifier_takes_per_layer_and_3d_masks(cls_results):
    """A `[B, L, L]` mask and a per-layer list reach the classifier's
    backbone as the JAX model's do."""
    jcfg, params, (ids, mask, seg, img, _), _, _ = cls_results[
        "seq_linear_ce"]
    jmodel = jib.ImgBertForSequenceClassification(jcfg)
    rs = np.random.RandomState(5)
    masks = {"3d": query_mask(rs),
             "per_layer": [query_mask(rs), mask, mask, query_mask(rs)]}
    model = load_jax_params(pib.ImgBertForSequenceClassification(
        port_config(jcfg), device="cpu"), params)
    for name, m in masks.items():
        jm = ([jnp.asarray(x) for x in m] if isinstance(m, list)
              else jnp.asarray(m))
        want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids),
                                       jm, jnp.asarray(seg),
                                       jnp.asarray(img)))
        with torch.no_grad():
            got = model(to_torch(ids), to_torch(m), to_torch(seg),
                        to_torch(img))
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0,
                                   err_msg=name)
