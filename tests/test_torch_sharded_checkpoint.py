"""The port's sharded checkpoints (`training/sharded_checkpoint.py`,
`training/consolidate.py`) against the JAX package's format, on the CPU.

- A directory the JAX `save_sharded` wrote (a leaf sharded over 2 devices,
  a bf16 leaf, a scalar, an empty node) consolidates in the port to the same
  arrays, the bf16 leaf as a bf16 tensor;
- the ZeRO-2 optimizer state of a 2-rank step (saved at world 2, each rank
  writing its pieces) consolidates at world 1 to the one-rank step's state
  (within 1e-5 of each tensor's largest magnitude), and a world-1 save restored into the 2-rank layout
  and saved again is the same bit for bit;
- a stale shard file of an older, larger save is ignored (and removed by
  the next save); a missing shard file and a partly covered leaf are hard
  errors;
- the consolidate command line writes `optimizer.pt` from `opt_shards/`.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mvp_pytorch_tpu.training import sharded_checkpoint as jax_sc
from mvp_pytorch_tpu_torch.convert import jax_params_to_state_dict
from mvp_pytorch_tpu_torch.training import consolidate as cons
from mvp_pytorch_tpu_torch.training.checkpoint import OPT_SHARDS_DIR
from mvp_pytorch_tpu_torch.training.optim import make_optimizer
from mvp_pytorch_tpu_torch.training.sharded_checkpoint import (consolidate,
                                                               save_sharded)
from mvp_pytorch_tpu_torch.training.trainer import Trainer

import torch_ranks as tr
from test_torch_models import FIX, retrieval_params, unflatten


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    torch.set_num_threads(1)


def test_jax_directory_consolidates_in_the_port(tmp_path):
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    rs = np.random.RandomState(0)
    w = rs.randn(8, 3).astype(np.float32)
    b16 = rs.randn(4, 5).astype(np.float32)
    tree = {"mu": {"w": jax.device_put(w, NamedSharding(mesh, P("data"))),
                   "b16": jnp.asarray(b16, jnp.bfloat16)},
            "count": jnp.asarray(3, jnp.int32), "empty": {}}
    jax_sc.save_sharded(str(tmp_path), tree)
    with np.load(tmp_path / "shard-00000.npz") as z:
        assert any(k.startswith("mu/w|0:4") for k in z.files)
    got = consolidate(str(tmp_path))
    np.testing.assert_array_equal(got["mu"]["w"], w)
    assert got["mu"]["b16"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["mu"]["b16"].float().numpy(),
        np.asarray(jnp.asarray(b16, jnp.bfloat16).astype(jnp.float32)))
    assert int(got["count"]) == 3 and got["empty"] == {}


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A one-rank ZeRO-free step's state saved at world 1 (`w1`), then the
    2-rank run: its own step saved at world 2 (`w2`) and `w1` restored into
    its layout and saved again (`w1_at_w2`)."""
    params = unflatten(dict(np.load(os.path.join(FIX, "params.npz"))))
    with open(os.path.join(FIX, "config.json")) as f:
        cfg_kw = json.load(f)
    mt = cfg_kw.pop("max_tag_length")
    d = str(tmp_path_factory.mktemp("ckpt"))
    setup = dict(cfg=cfg_kw, weights=jax_params_to_state_dict(
        retrieval_params(params)), mt=mt, seed=3, dice=tr.DICE, dir=d)
    torch.save(setup, os.path.join(d, "setup.pt"))
    model = tr.retrieval_model(setup)
    trainer = Trainer(model, tr.pinned_loss(mt, tr.DICE),
                      make_optimizer(model, tr.LR))
    trainer.step(tr.tensors(tr.make_batch(mt, 3)))
    save_sharded(os.path.join(d, "w1"), trainer.optimizer_state_tree())
    tr.launch(["ckpt"], d)
    return d, setup


def test_world_two_save_restores_at_world_one(saved):
    d, setup = saved
    w1, w2 = (consolidate(os.path.join(d, n)) for n in ("w1", "w2"))
    with open(os.path.join(d, "w2", "manifest.json")) as f:
        assert json.load(f)["world_size"] == 2
    assert int(w2["count"]) == int(w1["count"]) == 1
    for key in ("mu", "nu"):
        assert set(w2[key]) == set(w1[key])
        for n, v in w1[key].items():
            # within 1e-5 of each tensor's scale: the two steps' gradients
            # differ by the order of their sums
            err = np.abs(np.asarray(w2[key][n]) - v).max()
            assert err <= 1e-5 * np.abs(v).max() + 1e-12, (key, n, err)
    # and it loads into a one-rank trainer, which steps on
    model = tr.retrieval_model(setup)
    trainer = Trainer(model, tr.pinned_loss(setup["mt"], tr.DICE),
                      make_optimizer(model, tr.LR))
    trainer.load_optimizer_state(w2)
    assert np.isfinite(trainer.step(
        tr.tensors(tr.make_batch(setup["mt"], 3)))["loss"])


def test_world_one_save_restores_at_world_two(saved):
    d, _ = saved
    a = consolidate(os.path.join(d, "w1"))
    b = consolidate(os.path.join(d, "w1_at_w2"))
    with open(os.path.join(d, "w1_at_w2", "manifest.json")) as f:
        assert json.load(f)["world_size"] == 2
    for key in ("mu", "nu"):
        for n, v in a[key].items():
            np.testing.assert_array_equal(b[key][n], v, err_msg=n)


def test_stale_shard_is_ignored_and_removed(saved, tmp_path):
    d, _ = saved
    shutil.copytree(os.path.join(d, "w1"), tmp_path / "c")
    # what a larger, older save would have left behind
    with open(tmp_path / "c" / "shard-00001.npz", "wb") as f:
        np.savez(f, **{"mu/logit_scale|": np.asarray(99.0, np.float32)})
    want = consolidate(os.path.join(d, "w1"))
    got = consolidate(str(tmp_path / "c"))
    assert float(got["mu"]["logit_scale"]) == float(want["mu"]["logit_scale"])
    save_sharded(str(tmp_path / "c"), {"x": np.zeros(3, np.float32)})
    assert not (tmp_path / "c" / "shard-00001.npz").exists()


def test_missing_or_partial_shards_are_errors(saved, tmp_path):
    d, _ = saved
    shutil.copytree(os.path.join(d, "w2"), tmp_path / "p")
    path = tmp_path / "p" / "shard-00001.npz"
    with np.load(path) as z:
        kept = {k: z[k] for k in z.files}
    dropped = next(k for k in kept if not k.endswith("|"))
    del kept[dropped]
    with open(path, "wb") as f:
        np.savez(f, **kept)
    with pytest.raises(ValueError, match="covered"):
        consolidate(str(tmp_path / "p"))
    os.remove(path)
    with pytest.raises(FileNotFoundError, match="rank 1 of 2"):
        consolidate(str(tmp_path / "p"))


def test_consolidate_cli_writes_optimizer_pt(saved, tmp_path, capsys):
    d, setup = saved
    ckpt = tmp_path / "checkpoint-0000001"
    shutil.copytree(os.path.join(d, "w2"), ckpt / OPT_SHARDS_DIR)
    cons.main([str(ckpt), "--rm"])
    out = capsys.readouterr().out.strip()
    assert out == str(ckpt / "optimizer.pt")
    assert not (ckpt / OPT_SHARDS_DIR).exists()
    state = torch.load(out, weights_only=True)
    model = tr.retrieval_model(setup)
    opt = make_optimizer(model, tr.LR)
    opt.load_state_dict(state)
    assert opt.count == 1
