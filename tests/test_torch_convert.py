"""`load_jax_params`: every flax parameter lands where the reference's torch
state dict keeps it, strictly."""

import os

import numpy as np
import pytest
import torch

from mvp_pytorch_tpu.convert import export_state_dict
from mvp_pytorch_tpu_torch.convert import (jax_params_to_state_dict,
                                           load_jax_params)
from mvp_pytorch_tpu_torch.models import RetrievalModel, tiny_config

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "golden")


def unflatten(flat):
    tree = {}
    for k, v in flat.items():
        parts = k.split("/")
        t = tree
        for p in parts[:-1]:
            t = t.setdefault(p, {})
        t[parts[-1]] = v
    return tree


def model_params(classifier="linear", seed=0):
    """The golden bert subtree plus a seeded classifier of either kind."""
    golden = unflatten(dict(np.load(os.path.join(FIX, "params.npz"))))
    r = np.random.RandomState(seed)
    h = 32
    if classifier == "mlp":
        cls = {"dense": {"kernel": r.randn(h, 2 * h).astype(np.float32),
                         "bias": r.randn(2 * h).astype(np.float32)},
               "out": {"kernel": r.randn(2 * h, 2).astype(np.float32),
                       "bias": r.randn(2).astype(np.float32)}}
    else:
        cls = {"out": {"kernel": r.randn(h, 2).astype(np.float32),
                       "bias": r.randn(2).astype(np.float32)}}
    return {"bert": golden["bert"], "classifier": cls,
            "logit_scale": np.asarray(2.5, np.float32)}


@pytest.mark.parametrize("classifier", ["linear", "mlp"])
def test_every_param_loads_with_its_layout(classifier):
    params = model_params(classifier)
    model = RetrievalModel(tiny_config(classifier=classifier), device="cpu")
    load_jax_params(model, params)
    sd = model.state_dict()
    bert = params["bert"]
    q = bert["txt_encoder"]["layer_1"]["attention"]["self"]["query"]
    np.testing.assert_array_equal(
        sd["bert.txt_encoder.layer.1.attention.self.query.weight"].numpy(),
        q["kernel"].T)                                    # dense: transposed
    np.testing.assert_array_equal(
        sd["bert.txt_proj"].numpy(), bert["txt_proj"])    # raw: as is
    np.testing.assert_array_equal(
        sd["bert.mul_encoder.layer.0.output.LayerNorm.weight"].numpy(),
        bert["mul_encoder"]["layer_0"]["output_norm"]["scale"])
    np.testing.assert_array_equal(
        sd["bert.embeddings.word_embeddings.weight"].numpy(),
        bert["embeddings"]["word_embeddings"]["embedding"])
    assert float(sd["logit_scale"]) == 2.5
    out_key = "classifier.2.weight" if classifier == "mlp" else "classifier.weight"
    np.testing.assert_array_equal(sd[out_key].numpy(),
                                  params["classifier"]["out"]["kernel"].T)
    # every parameter of the port came from the params (none left at init)
    assert len(jax_params_to_state_dict(params)) == len(sd)


def test_reference_state_dict_loads_strictly():
    """The JAX package's export (the reference's torch keys, as a
    `pytorch_model.bin` holds them) loads into the port unchanged."""
    params = model_params()
    ref = {k: torch.from_numpy(np.asarray(v))
           for k, v in export_state_dict(params).items()}
    model = RetrievalModel(tiny_config(), device="cpu")
    model.load_state_dict(ref, strict=True)
    mine = jax_params_to_state_dict(params)
    assert set(mine) == set(ref)
    for k in ref:
        torch.testing.assert_close(mine[k], ref[k], rtol=0, atol=0)


def test_missing_param_raises():
    params = model_params()
    del params["bert"]["vis_encoder"]["layer_0"]["intermediate_dense"]["bias"]
    with pytest.raises(RuntimeError, match="Missing key"):
        load_jax_params(RetrievalModel(tiny_config(), device="cpu"), params)


@pytest.mark.parametrize("extra", ["bert/unknown/kernel",
                                   "bert/img_norm/scale"])
def test_extra_param_raises(extra):
    params = model_params()
    t = params
    *parents, leaf = extra.split("/")
    for p in parents:
        t = t.setdefault(p, {})
    t[leaf] = np.ones(32, np.float32)
    # an unknown path has no key; img_norm has one, but the config has no
    # image LayerNorm, so the strict load finds it unexpected
    with pytest.raises((KeyError, RuntimeError)):
        load_jax_params(RetrievalModel(tiny_config(), device="cpu"), params)
