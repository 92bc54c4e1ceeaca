"""The port's Mixture-of-Experts FFN (`ops/moe.py`) against the JAX
package's, in fp32 on the CPU.

- `MoEMLP` against the JAX `MoEMLP` on the same parameters: outputs within
  1e-5 and the load-balance aux within 1e-5, with a padded last group,
  choices over capacity dropped, top-1 and top-2;
- identical experts reduce to the dense (bias-free) FFN; grouped dispatch
  equals one group when nothing is dropped;
- a tiny MoE `BiPretrainModel` (every second layer of each encoder an
  `MoEMLP`): the total loss with `moe_aux_weight * sum(aux - 1)` and the
  aux within 2e-4 of the JAX model's, on the same tree through
  `convert.load_jax_params` (which names the MoE leaves);
- the TP placement rule splits the experts over the model ranks as
  `tp_param_pspec` does, for every parameter of that model;
- the aux is kept only inside `collect_aux`: two pretraining Trainer steps
  with `moe_aux_weight` give the same losses and weights under `remat` as
  without (the backward's recompute records no stale aux), and a Trainer
  that never collects (fine-tuning an MoE model) leaves no aux behind;
- expert parallelism over 2 gloo ranks (`all_to_all_single`) equals one
  rank: the MLP's output, aux and gradients, and two Trainer steps of a
  tiny MoE retrieval model (the ranks start through the port's launcher,
  with a 60 s deadline).
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvp_pytorch_tpu.models import ModelConfig as JaxConfig
from mvp_pytorch_tpu.models import pretrain as jax_pretrain
from mvp_pytorch_tpu.ops import moe as jax_moe
from mvp_pytorch_tpu.parallel import mesh as jax_mesh
from mvp_pytorch_tpu_torch.convert import _flatten, _torch_key, load_jax_params
from mvp_pytorch_tpu_torch.models import BiPretrainModel, ModelConfig
from mvp_pytorch_tpu_torch.models.config import tiny_config
from mvp_pytorch_tpu_torch.ops.moe import MoEMLP, collect_aux, moe_aux_loss
from mvp_pytorch_tpu_torch.parallel.mesh import tp_param_pspec
from mvp_pytorch_tpu_torch.tasks.pretrain import PRETRAIN_KEYS, pretrain_loss_fn
from mvp_pytorch_tpu_torch.training.optim import make_optimizer
from mvp_pytorch_tpu_torch.training.trainer import Trainer

import torch_ranks as tr
from test_torch_pretrain import (DICE, LAYERS, NEG_OFFSET, STEP_KW, WRA_PICK,
                                 config_kw, golden, make_batch, pin_jax_wra,
                                 pretrain_tree, torch_batch)

TOL = 1e-5
LOSS_TOL = 2e-4
AUX_WEIGHT = 0.01
MOE = dict(moe_experts=4, moe_top_k=2, moe_every=2, moe_group_size=16,
           moe_capacity_factor=1.0)


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    torch.set_num_threads(1)


def moe_params(rs, e, h, f, scale=0.3):
    return {"wi": (scale * rs.randn(e, h, f)).astype(np.float32),
            "wo": (scale * rs.randn(e, f, h)).astype(np.float32),
            "router": {"kernel": (0.5 * rs.randn(h, e)).astype(np.float32)}}


def port_moe(cfg, p):
    m = MoEMLP(cfg)
    with torch.no_grad():
        m.wi.copy_(torch.from_numpy(p["wi"]))
        m.wo.copy_(torch.from_numpy(p["wo"]))
        m.router.weight.copy_(torch.from_numpy(p["router"]["kernel"].T))
    return m


def jax_moe_apply(cfg, p, x):
    out, mut = jax_moe.MoEMLP(JaxConfig(**vars(cfg))).apply(
        {"params": jax.tree_util.tree_map(jnp.asarray, p)}, jnp.asarray(x),
        mutable=["intermediates"])
    return np.asarray(out), float(jax_moe.moe_aux_loss(mut["intermediates"]))


# (top_k, capacity factor, group size): a padded last group everywhere
# (3 x 13 = 39 tokens), drops at capacity factor 0.5 and 1.0
MLP_CASES = {"top2_drops": (2, 1.0, 16), "top2_tight": (2, 0.5, 16),
             "top1": (1, 1.0, 16), "one_group": (2, 1.25, 1024)}


@pytest.mark.parametrize("case", list(MLP_CASES))
def test_moe_mlp_matches_jax(case):
    k, cf, s = MLP_CASES[case]
    cfg = tiny_config(intermediate_size=48, moe_experts=4, moe_top_k=k,
                      moe_capacity_factor=cf, moe_group_size=s)
    rs = np.random.RandomState(3)
    p = moe_params(rs, 4, 32, 48)
    x = rs.randn(3, 13, 32).astype(np.float32)
    want, want_aux = jax_moe_apply(cfg, p, x)
    m = port_moe(cfg, p).train()
    with collect_aux(m) as aux_values:
        got = m(torch.from_numpy(x))
    aux = moe_aux_loss(aux_values)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=TOL,
                               rtol=TOL)
    assert abs(float(aux.detach()) - want_aux) <= TOL
    if case == "top2_tight":
        assert float(m.stats["dropped"]) > 0.1       # the drop path ran


def test_identical_experts_reduce_to_the_dense_ffn():
    cfg = tiny_config(intermediate_size=48, moe_experts=4, moe_top_k=2,
                      moe_capacity_factor=4.0, moe_group_size=16)
    rs = np.random.RandomState(5)
    w1 = (0.3 * rs.randn(32, 48)).astype(np.float32)
    w2 = (0.3 * rs.randn(48, 32)).astype(np.float32)
    p = {"wi": np.stack([w1] * 4), "wo": np.stack([w2] * 4),
         "router": {"kernel": (0.5 * rs.randn(32, 4)).astype(np.float32)}}
    x = torch.from_numpy(rs.randn(3, 13, 32).astype(np.float32))
    got = port_moe(cfg, p)(x)
    dense = torch.nn.functional.gelu(x @ torch.from_numpy(w1)) \
        @ torch.from_numpy(w2)
    np.testing.assert_allclose(got.detach().numpy(), dense.numpy(),
                               atol=TOL, rtol=TOL)


def test_grouped_dispatch_equals_one_group():
    rs = np.random.RandomState(6)
    p = moe_params(rs, 4, 32, 48)
    x = torch.from_numpy(rs.randn(3, 13, 32).astype(np.float32))
    outs = []
    for s in (8, 16, 1024):
        cfg = tiny_config(intermediate_size=48, moe_experts=4, moe_top_k=2,
                          moe_capacity_factor=8.0, moe_group_size=s)
        outs.append(port_moe(cfg, p)(x).detach().numpy())
    for o in outs[:-1]:
        np.testing.assert_allclose(o, outs[-1], atol=TOL, rtol=TOL)


def moe_tree(params):
    """The golden pretraining tree with LAYERS layers per encoder, every
    second layer's FFN an MoE of 4 seeded experts."""
    tree = copy.deepcopy(pretrain_tree(params, qa_pairs=False))
    rs = np.random.RandomState(23)
    for enc in ("txt_encoder", "vis_encoder", "mul_encoder"):
        for i in range(1, LAYERS, 2):
            layer = tree["bert"][enc][f"layer_{i}"]
            h, f = layer["intermediate_dense"]["kernel"].shape
            del layer["intermediate_dense"], layer["output_dense"]
            layer["moe"] = moe_params(rs, 4, h, f)
    return tree


@pytest.fixture(scope="module")
def moe_losses(golden):
    params, cfg_kw, mt, _ = golden
    tree = moe_tree(params)
    batch = make_batch(mt, seed=3, qa=False)
    kw = dict(phrase_mod="sample", phrase_layer=None)
    with pytest.MonkeyPatch.context() as mp:
        pin_jax_wra(mp)
        jm = jax_pretrain.BiPretrainModel(JaxConfig(**config_kw(cfg_kw,
                                                                **MOE)))

        def loss(p):
            out, mut = jm.apply(
                {"params": p}, *(jnp.asarray(batch[k]) if k in batch
                                 else None for k in PRETRAIN_KEYS),
                max_tag_length=mt, hn_mod="hard", hn_dice=jnp.asarray(DICE),
                deterministic=True, rngs={"wra": jax.random.PRNGKey(0)},
                mutable=["intermediates"], **STEP_KW, **kw)
            aux = jax_moe.moe_aux_loss(mut["intermediates"])
            return out.total_loss + AUX_WEIGHT * aux, aux
        jtotal, jaux = jax.jit(loss)(jax.tree_util.tree_map(jnp.asarray,
                                                            tree))
    port = BiPretrainModel(ModelConfig(**config_kw(cfg_kw, **MOE)),
                           device="cpu")
    load_jax_params(port, tree)
    port.train()
    tb = torch_batch(batch)
    with collect_aux(port) as aux_values:
        out = port(*(tb.get(k) for k in PRETRAIN_KEYS), max_tag_length=mt,
                   hn_dice=torch.from_numpy(DICE), wra_pick=WRA_PICK,
                   wra_neg_offset=NEG_OFFSET, **STEP_KW, **kw)
    aux = moe_aux_loss(aux_values)
    return (float(jtotal), float(jaux),
            float((out.total_loss + AUX_WEIGHT * aux).detach()),
            float(aux.detach()), tree, port)


def test_moe_pretrain_loss_matches_jax(moe_losses):
    jtotal, jaux, total, aux, _, port = moe_losses
    assert abs(aux - jaux) <= LOSS_TOL
    assert abs(total - jtotal) <= LOSS_TOL
    assert aux > 0                  # six MoE calls, off perfect balance
    assert sum(isinstance(m, MoEMLP) for m in port.modules()) == 6


def moe_pretrain_steps(golden, tree, remat, steps=2):
    """`steps` Trainer steps of the tiny MoE pretraining model with the aux
    in the loss -> (each step's loss and aux, the weights after)."""
    params, cfg_kw, mt, _ = golden
    model = BiPretrainModel(ModelConfig(**config_kw(cfg_kw, **MOE,
                                                    remat=remat)),
                            device="cpu")
    load_jax_params(model, tree)
    loss_fn = pretrain_loss_fn(
        max_tag_length=mt, hn_dice=torch.from_numpy(DICE),
        wra_pick=WRA_PICK, wra_neg_offset=NEG_OFFSET,
        moe_aux_weight=AUX_WEIGHT, **STEP_KW)
    trainer = Trainer(model, loss_fn, make_optimizer(model, 1e-3))
    batch = torch_batch(make_batch(mt, seed=3, qa=False))
    hist = [trainer.step(batch) for _ in range(steps)]
    return ([(h["loss"], h["moe_aux"]) for h in hist],
            {k: v.detach().clone() for k, v in model.state_dict().items()},
            model)


def test_moe_remat_step_equals_plain(golden, moe_losses):
    """Under remat the backward recomputes each MoE layer after the loss_fn's
    `collect_aux` has closed: nothing is recorded then, so the second step's
    loss holds no stale aux from the first."""
    tree = moe_losses[4]
    plain, plain_state, _ = moe_pretrain_steps(golden, tree, remat=False)
    remat, remat_state, model = moe_pretrain_steps(golden, tree, remat=True)
    for (loss, aux), (rloss, raux) in zip(plain, remat):
        assert abs(rloss - loss) <= TOL * max(1.0, abs(loss))
        assert abs(raux - aux) <= TOL
    for k, v in plain_state.items():
        np.testing.assert_allclose(remat_state[k].numpy(), v.numpy(),
                                   rtol=TOL, atol=TOL, err_msg=k)
    assert all(m.aux_sink is None for m in model.modules()
               if isinstance(m, MoEMLP))


def test_moe_finetune_keeps_no_aux():
    """A loss_fn that never opens `collect_aux` (fine-tuning from an MoE
    checkpoint) leaves no aux, and so no autograd graph, on the layers; an
    eval forward inside the scope records nothing either."""
    model = tr.RetrievalModel(tr.moe_config(), device="cpu", seed=3)
    layers = [m for m in model.modules() if isinstance(m, MoEMLP)]
    assert layers
    loss_fn = tr.pinned_loss(tr.TP_T, np.arange(4)[::-1].copy())
    trainer = Trainer(model, loss_fn, make_optimizer(model, 1e-3))
    batch = tr.tensors(tr.make_batch(tr.TP_T, 4, b=4))
    for _ in range(3):
        assert np.isfinite(trainer.step(batch)["loss"])
    assert all(m.aux_sink is None for m in layers)
    assert not any(isinstance(v, (list, torch.Tensor)) and
                   not isinstance(v, torch.nn.Parameter)
                   for m in layers for k, v in vars(m).items()
                   if k not in ("_parameters", "_buffers", "_modules"))
    model.eval()
    with collect_aux(model) as aux_values, torch.no_grad():
        loss_fn(model, batch, None)
    assert aux_values == []


def test_moe_placement_matches_jax(moe_losses):
    """Every parameter of the tiny MoE model splits over 2 model ranks as
    `tp_param_pspec` splits its flax leaf (dense kernels transposed)."""
    tree = moe_losses[4]
    devices = np.asarray(jax.devices()[:2]).reshape(1, 2)
    jmesh = jax.sharding.Mesh(devices, ("data", "model"))
    seen = set()
    for path, val in _flatten(tree):
        key, tval = _torch_key(path, val, False)
        want = tuple(jax_mesh.tp_param_pspec(path, val.shape, jmesh))
        want = want + (None,) * (val.ndim - len(want))
        if path[-1] == "kernel" and val.ndim == 2:
            want = want[::-1]
        assert tp_param_pspec(key, tval.shape, 2) == want, key
        seen.add(key)
    assert any(k.endswith("moe.wi") for k in seen)
    assert tp_param_pspec("bert.txt_encoder.layer.1.moe.wi",
                          (4, 32, 48), 2) == ("model", None, None)


@pytest.fixture(scope="module")
def ep_ranks(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ep"))
    torch.save({}, os.path.join(d, "setup.pt"))
    return tr.launch(["ep"], d)["ep"]


def test_expert_parallel_mlp_equals_one_rank(ep_ranks):
    y, aux, gx, grads = tr.moe_grads(tr.MoEHolder(tr.moe_config()))
    for rank, out in enumerate(ep_ranks):
        ry, raux, rgx, rgrads = out["mlp"]
        np.testing.assert_allclose(ry.numpy(), y.numpy(), atol=TOL, rtol=TOL)
        assert abs(raux - aux) <= TOL
        np.testing.assert_allclose(rgx.numpy(), gx.numpy(), atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(rgrads["moe.router.weight"].numpy(),
                                   grads["moe.router.weight"].numpy(),
                                   atol=TOL, rtol=TOL)
    for name in ("moe.wi", "moe.wo"):      # 2 experts a rank
        got = torch.cat([o["mlp"][3][name] for o in ep_ranks])
        np.testing.assert_allclose(got.numpy(), grads[name].numpy(),
                                   atol=TOL, rtol=TOL)


def test_expert_parallel_step_equals_one_rank(ep_ranks):
    hist, state = tr.seeded_step(tr.moe_config(),
                                 tr.make_batch(tr.TP_T, 4, b=4))
    for out in ep_ranks:
        rhist, rstate = out["step"]
        for a, b in zip(rhist, hist):
            assert abs(a["loss"] - b["loss"]) <= TOL
            assert abs(a["grad_norm"] - b["grad_norm"]) <= TOL * b["grad_norm"]
        for k, v in state.items():
            np.testing.assert_allclose(rstate[k].numpy(), v.numpy(),
                                       rtol=TOL, atol=1e-5, err_msg=k)
