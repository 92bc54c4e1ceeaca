"""The port's tensor and sequence parallelism on 2 gloo ranks against one
rank, and its placement rule against the JAX package's `tp_param_pspec`,
in fp32 on the CPU.

- Two Trainer steps of a tiny retrieval model with Megatron TP over 2 model
  ranks (query / key / value and the FFN up-projection column-parallel,
  the attention output and FFN down-projection row-parallel; 2 of the 4
  heads a rank in the attention kernel), and with SP on top (LayerNorm,
  dropout and residual regions cut along L), equal the one-rank steps:
  losses within 1e-5, the global gradient norm within 1e-5 relative, every
  parameter (gathered from its shards) within 1e-5 relative (atol 1e-6).
  The text stream is L 75 and the fused stream L 145: both odd, so SP pads
  its regions;
- the placement rule gives `tp_param_pspec`'s split for every parameter of
  the tiny retrieval and pretraining models (dense kernels transposed),
  and names the port's column- and row-parallel parameters.
"""

import os

import jax
import numpy as np
import pytest
import torch

from mvp_pytorch_tpu.parallel import mesh as jax_mesh
from mvp_pytorch_tpu_torch.convert import _flatten, _torch_key
from mvp_pytorch_tpu_torch.parallel.mesh import tp_param_pspec, tp_specs

import torch_ranks as tr
from test_torch_models import FIX, retrieval_params, unflatten
from test_torch_pretrain import pretrain_tree

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tp"))
    torch.save({}, os.path.join(d, "setup.pt"))
    return tr.launch(["tp"], d)["tp"]


@pytest.fixture(scope="module")
def one_rank():
    return tr.seeded_step(tr.tp_config(), tr.tp_batch())


@pytest.mark.parametrize("sp", [0, 1], ids=["tp2", "tp2_sp"])
def test_tensor_parallel_step_equals_one_rank(ranks, one_rank, sp):
    hist, state = one_rank
    for out in ranks:
        rhist, rstate = out[f"sp{sp}"]
        for a, b in zip(rhist, hist):
            assert abs(a["loss"] - b["loss"]) <= TOL
            assert abs(a["grad_norm"] - b["grad_norm"]) <= TOL * b["grad_norm"]
        assert set(rstate) == set(state)
        for k, v in state.items():
            np.testing.assert_allclose(rstate[k].numpy(), v.numpy(),
                                       rtol=TOL, atol=1e-6, err_msg=k)


def test_odd_lengths_are_exercised():
    b = tr.tp_batch()
    assert b["input_ids_a"].shape[1] == 75
    assert b["input_ids_a"].shape[1] + tr.TP_R == 145


def _check_placement(tree):
    devices = np.asarray(jax.devices()[:2]).reshape(1, 2)
    jmesh = jax.sharding.Mesh(devices, ("data", "model"))
    split = 0
    for path, val in _flatten(tree):
        key, tval = _torch_key(path, val, False)
        want = tuple(jax_mesh.tp_param_pspec(path, val.shape, jmesh))
        want = want + (None,) * (val.ndim - len(want))
        if path[-1] == "kernel" and val.ndim == 2:
            want = want[::-1]
        got = tp_param_pspec(key, tval.shape, 2)
        assert got == want, (key, got, want)
        split += "model" in got
    return split


@pytest.mark.parametrize("model", ["retrieval", "pretrain"])
def test_placement_matches_jax(model):
    params = unflatten(dict(np.load(os.path.join(FIX, "params.npz"))))
    tree = (retrieval_params(params) if model == "retrieval"
            else pretrain_tree(params, qa_pairs=True))
    assert _check_placement(tree) > 0


def test_placement_over_port_names():
    model = tr.RetrievalModel(tr.tp_config(), device="cpu")
    specs = tp_specs(model, 2)
    layer = "bert.txt_encoder.layer.0."
    assert specs[layer + "attention.self.query.weight"] == ("model", None)
    assert specs[layer + "attention.self.value.bias"] == ("model",)
    assert specs[layer + "attention.output.dense.weight"] == (None, "model")
    assert specs[layer + "attention.output.dense.bias"] == (None,)
    assert specs[layer + "intermediate.dense.weight"] == ("model", None)
    assert specs[layer + "output.dense.weight"] == (None, "model")
    assert specs["bert.pooler.dense.weight"] == (None, None)
    assert specs["classifier.weight"] == (None, None)
