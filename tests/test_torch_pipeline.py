"""The port's GPipe pipeline and stacked layout against the sequential
stack and the JAX package, in fp32 on the CPU.

- A 4-layer `StreamEncoder` of a `pipeline_stages = 2` config, pipelined
  over 2 gloo pipe ranks with 2 microbatches: its output, the mid-layer
  readout (`return_at_layer` in the first stage and in the last), the input
  gradient and every layer's gradients (each from its stage's rank) equal
  the sequential stack (1e-5);
- two GPipe Trainer steps of a tiny retrieval model equal the one-rank
  steps (losses 1e-5, parameters 1e-5 relative, atol 1e-6);
- `stack_model_params` / `unstack_model_params` equal the JAX package's and
  round-trip bit for bit;
- a JAX params tree in the stacked layout (`pipeline_stages = 2`) loads into
  the port and gives the JAX model's train_step loss (2e-4) and gradients
  (atol 2e-4, rtol 1e-3);
- the stacked layout refuses history states, per-layer bias lists and MoE,
  as the JAX one does;
- `config.remat` recomputes each layer with the same dropout masks: the
  gradients equal those without remat at dropout 0.1.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvp_pytorch_tpu.models import ModelConfig as JaxConfig
from mvp_pytorch_tpu.parallel import pipeline as jax_pipeline
from mvp_pytorch_tpu_torch.convert import load_jax_params
from mvp_pytorch_tpu_torch.models import ModelConfig, RetrievalModel
from mvp_pytorch_tpu_torch.models.layers import (StreamEncoder,
                                                 dropout_generator,
                                                 init_weights)
from mvp_pytorch_tpu_torch.ops.attention import mask_to_bias
from mvp_pytorch_tpu_torch.parallel.pipeline import (stack_model_params,
                                                     unstack_model_params)

import torch_ranks as tr
from test_torch_models import FIX, retrieval_params, unflatten
from test_torch_train import GRAD, LOSS_TOL, jax_train_step

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("pipe"))
    torch.save({}, os.path.join(d, "setup.pt"))
    return tr.launch(["pipe"], d)["pipe"]


@pytest.mark.parametrize("mid", [None, 1, 3], ids=["no_mid", "mid_stage0",
                                                   "mid_stage1"])
def test_gpipe_encoder_equals_sequential(ranks, mid):
    out, got_mid, gx, grads = tr.encoder_grads(tr.pipe_encoder(), mid)
    per_rank = [r[f"enc_{mid}"] for r in ranks]
    for rout, rmid, rgx, _ in per_rank:
        np.testing.assert_allclose(rout.numpy(), out.numpy(), atol=TOL,
                                   rtol=TOL)
        if mid is None:
            assert rmid is None
        else:
            np.testing.assert_allclose(rmid.numpy(), got_mid.numpy(),
                                       atol=TOL, rtol=TOL)
        np.testing.assert_allclose(rgx.numpy(), gx.numpy(), atol=TOL,
                                   rtol=TOL)
    # each rank holds the gradients of its own stage's layers only
    assert {n.split(".")[1] for n in per_rank[0][3]} == {"0", "1"}
    assert {n.split(".")[1] for n in per_rank[1][3]} == {"2", "3"}
    merged = {**per_rank[0][3], **per_rank[1][3]}
    assert set(merged) == set(grads)
    for n, g in grads.items():
        np.testing.assert_allclose(merged[n].numpy(), g.numpy(), atol=TOL,
                                   rtol=TOL, err_msg=n)


def test_gpipe_step_equals_one_rank(ranks):
    hist, state = tr.seeded_step(tr.tp_config(pipeline_stages=2),
                                 tr.tp_batch())
    for out in ranks:
        rhist, rstate = out["step"]
        for a, b in zip(rhist, hist):
            assert abs(a["loss"] - b["loss"]) <= TOL
            assert abs(a["grad_norm"] - b["grad_norm"]) <= TOL * b["grad_norm"]
        for k, v in state.items():
            np.testing.assert_allclose(rstate[k].numpy(), v.numpy(),
                                       rtol=TOL, atol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def golden_tree():
    import json
    params = unflatten(dict(np.load(os.path.join(FIX, "params.npz"))))
    with open(os.path.join(FIX, "config.json")) as f:
        cfg_kw = json.load(f)
    mt = cfg_kw.pop("max_tag_length")
    return retrieval_params(params), cfg_kw, mt


def test_stacking_matches_jax_and_round_trips(golden_tree):
    tree = golden_tree[0]
    stacked = stack_model_params(tree)
    want = jax.tree_util.tree_map(np.asarray,
                                  jax_pipeline.stack_model_params(tree))
    assert jax.tree_util.tree_structure(stacked) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(stacked),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    back = unstack_model_params(stacked)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_jax_stacked_tree_loads_and_matches(golden_tree, monkeypatch):
    full, cfg_kw, mt = golden_tree
    cfg = {**cfg_kw, "pipeline_stages": 2}
    stacked = jax.tree_util.tree_map(
        np.asarray, jax_pipeline.stack_model_params(full))
    assert "layers" in stacked["bert"]["txt_encoder"]
    batch = tr.make_batch(mt, 3)
    jout, jgrads = jax_train_step(JaxConfig(**cfg), stacked, batch, mt, {},
                                  monkeypatch)
    port = RetrievalModel(ModelConfig(**cfg), device="cpu")
    load_jax_params(port, stacked)
    port.train()
    out = port(*(torch.from_numpy(np.asarray(batch[k])) for k in tr.KEYS),
               max_tag_length=mt, hn_dice=torch.from_numpy(tr.DICE))
    out.total_loss.backward()
    assert abs(out.total_loss.item() - float(jout.total_loss)) <= LOSS_TOL
    for n, p in port.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(g.numpy(), jgrads[n].numpy(), **GRAD,
                                   err_msg=n)


def test_stacked_layout_refusals():
    enc = tr.pipe_encoder()
    h = torch.zeros(2, 5, 32)
    bias = mask_to_bias(torch.ones(2, 5, dtype=torch.long))
    with pytest.raises(NotImplementedError, match="history"):
        enc(h, bias, history_states=[h] * 4)
    with pytest.raises(NotImplementedError, match="history"):
        enc(h, bias, collect_states=True)
    with pytest.raises(NotImplementedError, match="per-layer"):
        enc(h, [bias] * 4)
    moe = StreamEncoder(tr.tp_config(pipeline_stages=2, moe_experts=2), 4)
    with pytest.raises(NotImplementedError, match="MoE"):
        moe(h, bias)


def test_remat_keeps_the_dropout_masks():
    grads = []
    for remat in (False, True):
        cfg = tr.tp_config(num_hidden_layers=4, remat=remat,
                           hidden_dropout_prob=0.1,
                           attention_probs_dropout_prob=0.1)
        enc = StreamEncoder(cfg, 2)
        init_weights(enc, 0.02, torch.Generator().manual_seed(11))
        hidden, mask, w, _ = tr.pipe_encoder_inputs()
        hidden.requires_grad_(True)
        enc.train()
        with dropout_generator(enc, torch.Generator().manual_seed(4)):
            out, _ = enc(hidden, mask_to_bias(mask))
        (out * w).sum().backward()
        grads.append([hidden.grad] + [p.grad for p in enc.parameters()])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6,
                                   rtol=1e-5)
