"""The port's single-pair task models and loss helpers against the JAX
package's, on the CPU.

The tiny config and shapes are `tests/test_task_models.py`'s (B 4, LA 10,
T 5, R 4; hidden 32, 2+2+2 layers, dropouts 0), with padded captions and
regions. Each model's weights are made once per module: JAX init, plus
seeded noise so that the heads' logits are far from zero, then numpy, then
`load_jax_params(strict=True)` into the port. Per case (`VQAModel` bce,
`ClassificationModel`, `ClassificationPlusModel` with a linear and an mlp
classifier, `REModel` mods 1 / 2 / 3 with and without `phrase_layer`):

- fp32 logits within 5e-4 (fused outputs, the golden fixture's tolerance)
  and the loss within 2e-4 of the JAX model's;
- every parameter's gradient of the loss within 1e-3 relative (plus 1e-6
  absolute, for the heads a case never reads) of `jax.grad`'s;
- bf16 compute over the same fp32 weights: the logits within 0.05 of the JAX
  fp32 logits, as `tests/test_models.py:258-280` holds bf16 attention, and
  within 0.02 of the JAX bf16 logits;
- each head of the bf16 models against the JAX head on the same bf16
  inputs, which shows a dtype slip (such as the Plus model's fp32
  classifier computed in bf16) that the whole model's bf16 noise hides.

Also: every branch of `classification_loss` and the three loss helpers
against JAX's on random inputs, and the converter's keys against the JAX
exporter's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvp_pytorch_tpu.convert import export_state_dict
from mvp_pytorch_tpu.models import tiny_config as jax_tiny_config
from mvp_pytorch_tpu.models import tasks as jt
from mvp_pytorch_tpu_torch.convert import (jax_params_to_state_dict,
                                           load_jax_params)
from mvp_pytorch_tpu_torch.models import ModelConfig
from mvp_pytorch_tpu_torch.models import tasks as pt

B, LA, T, R = 4, 10, 5, 4
N_ANS = 7
LOGIT_TOL, LOSS_TOL, GRAD_RTOL, GRAD_ATOL = 5e-4, 2e-4, 1e-3, 1e-6
BF16_TOL, BF16_SAME_TOL = 0.05, 0.02

# case -> (model, config overrides, forward keywords, label kind)
CASES = {
    "vqa_bce": ("VQAModel", dict(num_labels=N_ANS, loss_type="bce"), {},
                "soft"),
    "cls_sfmx": ("ClassificationModel", dict(num_labels=3), {}, "int"),
    "plus_linear": ("ClassificationPlusModel", dict(num_labels=3), {}, "int"),
    "plus_mlp": ("ClassificationPlusModel",
                 dict(num_labels=3, classifier="mlp"), {}, "int"),
}
for _mod in (1, 2, 3):
    for _pl in (None, 0):
        CASES[f"re_mod{_mod}" + ("" if _pl is None else "_phrase0")] = (
            "REModel", dict(num_labels=1), dict(mod=_mod, phrase_layer=_pl),
            "iou")


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    """torch single-threaded in this process: no intra-op thread pool is left
    behind for a later test in the same worker that forks."""
    torch.set_num_threads(1)


def make_inputs(cfg, kind, seed=0):
    """The seven inputs (two captions and one image padded) and labels."""
    r = np.random.RandomState(seed)
    mask_a = np.ones((B, LA), np.int32)
    mask_a[1::2, LA - 3:] = 0
    mask_b = np.ones((B, T + R), np.int32)
    mask_b[1, T + R - 1:] = 0
    inputs = (r.randint(1, cfg.vocab_size, (B, LA)).astype(np.int32), mask_a,
              np.zeros((B, LA), np.int32),
              r.randint(1, cfg.only_word_size, (B, T)).astype(np.int32),
              mask_b, np.ones((B, T), np.int32),
              r.randn(B, R, cfg.img_feature_dim).astype(np.float32))
    if kind == "soft":
        labels = np.zeros((B, N_ANS), np.float32)
        for i in range(B):
            labels[i, r.choice(N_ANS, 2, replace=False)] = r.rand(2)
    elif kind == "int":
        labels = r.randint(0, 3, (B,)).astype(np.int32)
    else:
        labels = r.rand(B, R).astype(np.float32)
        labels[1, R - 1] = -1.0                 # the padded region
    return inputs, labels


def jax_params(name, cfg, inputs, labels):
    """JAX init (REModel at mod 3, as the JAX driver does, so that its
    classifier exists) plus seeded noise, as numpy."""
    model = getattr(jt, name)(cfg)
    kw = dict(labels=jnp.asarray(labels), mod=3) if name == "REModel" else {}
    params = jax.jit(lambda: model.init(
        jax.random.PRNGKey(3), *map(jnp.asarray, inputs), max_tag_length=T,
        **kw))()["params"]
    r = np.random.RandomState(11)
    return jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + 0.05 * r.randn(*v.shape)).astype(
            np.float32), params)


@pytest.fixture(scope="module")
def results():
    """case -> the JAX results and the inputs, the port's fp32 and bf16
    models loaded from the same params."""
    out, params_of = {}, {}
    for case, (name, over, kw, kind) in CASES.items():
        jcfg = jax_tiny_config(**over)
        inputs, labels = make_inputs(jcfg, kind)
        key = (name, tuple(sorted(over.items())))
        if key not in params_of:
            params_of[key] = jax_params(name, jcfg, inputs, labels)
        params = params_of[key]
        jmodel = getattr(jt, name)(jcfg)
        x = tuple(map(jnp.asarray, inputs))

        def loss(p, cfg_model=jmodel):
            l, logits = cfg_model.apply({"params": p}, *x,
                                        labels=jnp.asarray(labels),
                                        max_tag_length=T, **kw)
            return l, logits
        (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(params)
        jmodel16 = getattr(jt, name)(dataclasses.replace(jcfg,
                                                         dtype="bfloat16"))
        jlogits16 = jax.jit(lambda p: jmodel16.apply(
            {"params": p}, *x, max_tag_length=T, **kw))(params)
        models = {}
        for dt in ("float32", "bfloat16"):
            pcfg = ModelConfig.from_dict(dataclasses.asdict(jcfg), dtype=dt)
            models[dt] = load_jax_params(
                getattr(pt, name)(pcfg, device="cpu"), params)
        out[case] = dict(
            params=params, inputs=inputs, labels=labels, kw=kw,
            loss=float(jloss), logits=np.asarray(jlogits),
            grads=jax_params_to_state_dict(
                jax.tree_util.tree_map(np.asarray, jgrads)),
            logits16=np.asarray(jlogits16, np.float32),
            logits32_eval=np.asarray(jax.jit(lambda p: jmodel.apply(
                {"params": p}, *x, max_tag_length=T, **kw))(params)),
            models=models, jmodel16=jmodel16)
    return out


def port_forward(res, dt, labels=True):
    x = [torch.from_numpy(a) for a in res["inputs"]]
    kw = dict(res["kw"], max_tag_length=T)
    if labels:
        kw["labels"] = torch.from_numpy(res["labels"])
    return res["models"][dt](*x, **kw)


@pytest.mark.parametrize("case", list(CASES))
def test_fp32_logits_and_loss_match_jax(results, case):
    res = results[case]
    with torch.no_grad():
        loss, logits = port_forward(res, "float32")
        scores = port_forward(res, "float32", labels=False)
    np.testing.assert_allclose(logits.numpy(), res["logits"], atol=LOGIT_TOL,
                               rtol=0)
    assert abs(loss.item() - res["loss"]) <= LOSS_TOL
    # without labels: logits (RE mods 2 / 3: sigmoid scores)
    np.testing.assert_allclose(scores.numpy(), res["logits32_eval"],
                               atol=LOGIT_TOL, rtol=0)
    assert np.abs(res["logits"]).max() > 0.05     # the heads are exercised


@pytest.mark.parametrize("case", list(CASES))
def test_fp32_gradients_match_jax_grad(results, case):
    res = results[case]
    model = res["models"]["float32"]
    model.zero_grad(set_to_none=True)
    loss, _ = port_forward(res, "float32")
    loss.backward()
    params = dict(model.named_parameters())
    assert set(params) == set(res["grads"])
    nonzero = 0
    for name, p in params.items():
        want = res["grads"][name].numpy()
        got = (np.zeros_like(want) if p.grad is None
               else p.grad.numpy().reshape(want.shape))
        err = np.linalg.norm(got - want)
        assert err <= GRAD_RTOL * np.linalg.norm(want) + GRAD_ATOL, (
            name, err, np.linalg.norm(want))
        nonzero += bool(np.linalg.norm(want) > 0)
    assert nonzero > len(params) // 2


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_logits_hold_to_jax(results, case):
    res = results[case]
    with torch.no_grad():
        logits = port_forward(res, "bfloat16", labels=False)
    assert logits.dtype == torch.float32
    got = logits.numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, res["logits32_eval"], atol=BF16_TOL,
                               rtol=0)
    np.testing.assert_allclose(got, res["logits16"], atol=BF16_SAME_TOL,
                               rtol=0)


# head -> (case, the flax head in the JAX model, the port's submodule, input
# shape in units of H, the dtype its last product computes in)
HEADS = {
    "qa_head": ("vqa_bce", lambda m: m.cls, "cls.predictions", (B, 1),
                "bf16"),
    "classifier_head": ("cls_sfmx", lambda m: m.classifier, "classifier",
                        (B, 1), "bf16"),
    "plus_single_mapping": ("plus_linear", lambda m: m.single_mapping,
                            "single_mapping", (B, 4), "bf16"),
    "plus_mlp_first": ("plus_mlp", lambda m: m.classifier.layers[0],
                       "classifier.0", (B, 2), "bf16"),
    "plus_linear_classifier": ("plus_linear", lambda m: m.classifier,
                               "classifier", (B, 2), "fp32"),
    "plus_mlp_second": ("plus_mlp", lambda m: m.classifier.layers[2],
                        "classifier.2", (B, 2), "fp32"),
    "re_classifier": ("re_mod3", lambda m: m.classifier, "classifier",
                      (B, R, 1), "bf16"),
}


def bf16_exact(a):
    """Which elements of a float32 array are bf16 values."""
    return a == torch.from_numpy(a).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("head", list(HEADS))
def test_bf16_head_dtypes_match_jax(results, head):
    """Each head of the bf16 model on the same bf16 inputs as the JAX head,
    so that a dtype slip shows: a head whose last product runs in fp32 (the
    Plus model's linear classifier and its mlp's second layer, whose bf16
    inputs flax promotes to the fp32 kernel's type) agrees to fp32 rounding
    and its outputs are not bf16 values (a bf16 slip would round them all);
    a bf16 head agrees to bf16 rounding and, where it ends in the product,
    gives bf16 values (an fp32 slip would not round them)."""
    case, flax_head, port_path, shape, dt = HEADS[head]
    res = results[case]
    h = res["models"]["bfloat16"].config.hidden_size
    x = np.random.RandomState(4).randn(*shape[:-1], shape[-1] * h)
    x = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    want = np.asarray(res["jmodel16"].apply(
        {"params": res["params"]}, jnp.asarray(x.float().numpy(), jnp.bfloat16),
        method=lambda m, v: flax_head(m)(v)), np.float32)
    port = res["models"]["bfloat16"].get_submodule(port_path)
    with torch.no_grad():
        got = port(x).float().numpy()
    scale = np.abs(want).max()
    assert scale > 0.05
    err = np.abs(got - want).max()
    if dt == "fp32":
        assert err <= 1e-5 * scale, err
        assert bf16_exact(got).mean() < 0.5
    else:
        assert err <= 2.0 ** -6 * scale, err
        if head != "qa_head":           # the QA head adds an fp32 bias
            assert bf16_exact(got).all()


@pytest.mark.parametrize("case", ["vqa_bce", "cls_sfmx", "re_mod3"])
def test_keys_are_the_jax_exporters(results, case):
    """Where the JAX exporter has rules, the port's keys and values are its
    keys and values."""
    params = results[case]["params"]
    want = export_state_dict(params)
    got = jax_params_to_state_dict(params)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])


@pytest.mark.parametrize("case", ["plus_linear", "plus_mlp"])
def test_plus_model_keys_and_strict_load(results, case):
    """The Plus model's own names (the JAX exporter has no rule for
    `single_mapping`), and a strict load: a missing or an extra flax path
    raises."""
    res = results[case]
    sd = jax_params_to_state_dict(res["params"])
    heads = sorted(k for k in sd if not k.startswith("bert."))
    mlp = case == "plus_mlp"
    assert heads == sorted(
        [f"single_mapping.{i}.{s}" for i in (0, 2) for s in ("bias", "weight")]
        + ([f"classifier.{i}.{s}" for i in (0, 2) for s in ("bias", "weight")]
           if mlp else ["classifier.bias", "classifier.weight"]))
    model = res["models"]["float32"]
    missing = {k: v for k, v in res["params"].items() if k != "classifier"}
    with pytest.raises(RuntimeError, match="Missing key"):
        load_jax_params(model, missing)
    extra = dict(res["params"], extra_head={"kernel": np.zeros((2, 2))})
    with pytest.raises(KeyError, match="extra_head"):
        load_jax_params(model, extra)
    load_jax_params(model, res["params"])


# ---------------------------------------------------------------------------
# the loss helpers
# ---------------------------------------------------------------------------

def _rand(seed):
    r = np.random.RandomState(seed)
    return r, (2.0 * r.randn(6, 5)).astype(np.float32)


def _soft_targets(r):
    t = np.zeros((6, 5), np.float32)
    for i in range(6):
        t[i, r.choice(5, 2, replace=False)] = r.rand(2)
    return t


def _probs(r):
    t = _soft_targets(r)
    t[0] = 0.0                                  # a row with no answer
    return t / np.maximum(t.sum(1, keepdims=True), 1.0)


HELPERS = {
    "soft_cross_entropy": lambda r, x: (
        (r.rand(6).astype(np.float32), x[:, :2]), {}),
    "instance_bce_with_logits": lambda r, x: ((x, _soft_targets(r)), {}),
    "kl_div_loss": lambda r, x: ((x, _probs(r)), {}),
}
# classification_loss branch -> (config overrides, call, labels)
BRANCHES = {
    "mse": (dict(num_labels=1), lambda r, x: x[:, :1],
            lambda r: r.rand(6).astype(np.float32), {}),
    "soft_label": (dict(num_labels=2), lambda r, x: x[:, :2],
                   lambda r: r.rand(6).astype(np.float32),
                   dict(soft_label=True)),
    "kl": (dict(num_labels=5, loss_type="kl"), lambda r, x: x, _probs, {}),
    "bce": (dict(num_labels=5, loss_type="bce"), lambda r, x: x,
            _soft_targets, {}),
    "sfmx": (dict(num_labels=5), lambda r, x: x,
             lambda r: np.array([0, 4, 2, 7, -1, 3], np.int32), {}),
}


@pytest.mark.parametrize("name", list(HELPERS))
def test_loss_helpers_match_jax(name):
    r, x = _rand(1)
    args, kw = HELPERS[name](r, x)
    want = float(getattr(jt, name)(*map(jnp.asarray, args), **kw))
    got = getattr(pt, name)(*map(torch.from_numpy, args), **kw).item()
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (got, want)


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_classification_loss_branches_match_jax(branch):
    over, logits_of, labels_of, kw = BRANCHES[branch]
    r, x = _rand(2)
    logits, labels = logits_of(r, x), labels_of(r)
    want = float(jt.classification_loss(jax_tiny_config(**over),
                                        jnp.asarray(logits),
                                        jnp.asarray(labels), **kw))
    cfg = ModelConfig.from_dict(dataclasses.asdict(jax_tiny_config(**over)))
    t = torch.from_numpy(logits).requires_grad_()
    got = pt.classification_loss(cfg, t, torch.from_numpy(labels), **kw)
    got.backward()
    assert abs(got.item() - want) <= 1e-5 * max(1.0, abs(want)), (got, want)
    assert torch.isfinite(t.grad).all()
