"""Rank programs for the port's multi-process tests (gloo on the CPU).

Imports torch, numpy and the port only, never JAX: the tests start it on
two ranks through the port's launcher,

    python -m mvp_pytorch_tpu_torch.tools.launch --nproc 2 -- \
        tests/torch_ranks.py CASE[,CASE...] DIR

and each case writes `DIR/{case}_rank{r}.pt`. DIR holds what the test
prepared (`setup.pt`: the config, the weights, the batch seed). The shared
builders (`make_batch`, `tiny_retrieval`, ...) are imported by the tests
too, so both sides build the same inputs.
"""

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from mvp_pytorch_tpu_torch.models import ModelConfig, RetrievalModel  # noqa
from mvp_pytorch_tpu_torch.parallel.collectives import LOCAL  # noqa
from mvp_pytorch_tpu_torch.training.optim import make_optimizer  # noqa
from mvp_pytorch_tpu_torch.training.trainer import Trainer  # noqa

KEYS = ("input_ids_a", "attention_mask_a", "token_type_ids_a", "input_ids_b",
        "attention_mask_b", "token_type_ids_b", "img_feats")
B, LA, R = 6, 9, 5
DICE = np.array([3, 0, 5, 1, 4, 2])
LR = 1e-3


def make_batch(mt, seed, b=B, la=LA, r=R, feat=22, vocab=99):
    """Continuous, padded inputs (no argmax ties in the hard mining)."""
    rs = np.random.RandomState(seed)
    ma = np.ones((b, la), np.int64)
    ma[1::2, la - 2:] = 0
    mb = np.ones((b, mt + r), np.int64)
    mb[1, mt + r - 2:] = 0
    return dict(input_ids_a=rs.randint(1, vocab, (b, la)),
                attention_mask_a=ma,
                token_type_ids_a=np.zeros((b, la), np.int64),
                input_ids_b=rs.randint(1, vocab, (b, mt)),
                attention_mask_b=mb,
                token_type_ids_b=np.ones((b, mt), np.int64),
                img_feats=rs.randn(b, r, feat).astype(np.float32))


def tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def pinned_loss(mt, dice):
    """The retrieval loss with the hard-negative permutation pinned."""
    dice = torch.as_tensor(dice)

    def loss_fn(model, batch, generator, global_batch=LOCAL):
        out = model.train_step(*(batch[k] for k in KEYS), max_tag_length=mt,
                               hn_dice=dice, generator=generator,
                               global_batch=global_batch)
        return out.total_loss, {"clip": out.retrieval_loss,
                                "itm": out.itm_loss}
    return loss_fn


def retrieval_model(setup):
    model = RetrievalModel(ModelConfig(**setup["cfg"]), device="cpu")
    model.load_state_dict(setup["weights"], strict=True)
    return model


def one_rank_step(setup, batch, steps=1):
    """The reference: the one-process Trainer over the global batch."""
    model = retrieval_model(setup)
    trainer = Trainer(model, pinned_loss(setup["mt"], setup["dice"]),
                      make_optimizer(model, LR))
    hist = [trainer.step(tensors(batch)) for _ in range(steps)]
    return hist, {k: v.detach().clone() for k, v in model.state_dict().items()}


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------

def case_dp(setup, out):
    """Plain DDP, ZeRO-2 and FSDP over 2 data ranks: 2 steps each."""
    from mvp_pytorch_tpu_torch.parallel.mesh import make_mesh, shard_batch
    mesh = make_mesh(data=2)
    batch = make_batch(setup["mt"], setup["seed"])
    for name, kw in (("ddp", dict(zero_sharding=False)),
                     ("zero2", dict(zero_sharding=True)),
                     ("fsdp", dict(fsdp=True))):
        model = retrieval_model(setup)
        trainer = Trainer(model, pinned_loss(setup["mt"], setup["dice"]),
                          make_optimizer(model, LR), mesh=mesh, **kw)
        local = tensors(shard_batch(mesh, batch))
        hist = [trainer.step(local) for _ in range(2)]
        out[name] = {"hist": hist, "state": trainer.full_state_dict()}
        if name == "fsdp":
            out[name]["at_rest"] = {n: p.data.numel() for n, p in
                                    model.named_parameters()}
        if name == "zero2":
            out[name]["moments"] = {n: tuple(m.shape) for n, m in
                                    trainer.optimizer.state_dict()["mu"]
                                    .items()}


def case_grads(setup, out):
    """The averaged gradients of one data-parallel step (plain DDP)."""
    from mvp_pytorch_tpu_torch.parallel.mesh import make_mesh, shard_batch
    mesh = make_mesh(data=2)
    model = retrieval_model(setup)
    trainer = Trainer(model, pinned_loss(setup["mt"], setup["dice"]),
                      make_optimizer(model, LR), mesh=mesh,
                      zero_sharding=False)
    local = tensors(shard_batch(mesh, make_batch(setup["mt"],
                                                 setup["seed"])))
    model.train()
    loss, _ = trainer.loss_fn(model, local, trainer.generator(0),
                              global_batch=trainer.global_batch)
    loss.backward()
    grads = trainer._reduce_grads()
    total = loss.detach().clone()
    torch.distributed.all_reduce(total)
    out["loss"] = float(total) / 2
    out["grads"] = dict(zip(trainer.optimizer.names, grads))


def case_dropout(setup, out):
    """Each data rank's generator draws its own masks."""
    from mvp_pytorch_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(data=2)
    model = retrieval_model(setup)
    trainer = Trainer(model, pinned_loss(setup["mt"], setup["dice"]),
                      make_optimizer(model, LR), mesh=mesh)
    gen = trainer.generator(0, 0)
    out["mask"] = torch.empty(64).bernoulli_(0.5, generator=gen)
    out["seed"] = trainer.seed_of(0, 0)


def case_eval(setup, out):
    """Sequential eval shards over 2 ranks and their gather."""
    from mvp_pytorch_tpu_torch.parallel.collectives import (
        gather_eval_arrays, process_shard_indices)
    from mvp_pytorch_tpu_torch.parallel.mesh import EvalSharder, make_mesh
    idx = process_shard_indices(7)
    out["idx"] = idx
    out["gathered"] = gather_eval_arrays(7, idx * 10, idx[:, None] * 1.5)
    sharder = EvalSharder(4, make_mesh(data=2, register=False))
    rows = sharder.put_batch({"x": np.arange(8).reshape(4, 2)})["x"]
    out["sharder"] = (sharder.active, rows, sharder.gather(rows * 2))


# --- tensor and sequence parallelism ---------------------------------------

TP_LA, TP_T, TP_R = 75, 10, 70      # text L 75, fused L 75 + 70 = 145


def tp_config(**kw):
    from mvp_pytorch_tpu_torch.models.config import tiny_config
    return tiny_config(intermediate_size=48, max_position_embeddings=128,
                       **kw)


def tp_batch(seed=5, b=4):
    return make_batch(TP_T, seed, b=b, la=TP_LA, r=TP_R)


def seeded_step(cfg, batch, steps=2, mesh=None, prepare=None, **kw):
    """`steps` Trainer steps of a seeded RetrievalModel(cfg) over `batch`
    (this rank's rows), hn_dice pinned to the reverse permutation."""
    model = RetrievalModel(cfg, device="cpu", seed=3)
    if prepare is not None:
        prepare(model)
    dice = np.arange(batch["input_ids_a"].shape[0] * (
        mesh.data_size if mesh is not None else 1))[::-1].copy()
    trainer = Trainer(model, pinned_loss(TP_T, dice),
                      make_optimizer(model, LR), mesh=mesh, **kw)
    hist = [trainer.step(tensors(batch)) for _ in range(steps)]
    return hist, trainer.full_state_dict()


def case_tp(setup, out):
    """TP 2, and TP 2 with SP, at L 75 / 145."""
    from mvp_pytorch_tpu_torch.parallel.mesh import (apply_tensor_parallel,
                                                     make_mesh)
    mesh = make_mesh(model=2)
    for sp in (False, True):
        out[f"sp{int(sp)}"] = seeded_step(
            tp_config(), tp_batch(), mesh=mesh,
            prepare=lambda m, sp=sp: apply_tensor_parallel(m, mesh, sp))


# --- pipeline ---------------------------------------------------------------

def pipe_encoder_inputs(seed=7, b=4, l=11, h=32):
    rs = np.random.RandomState(seed)
    mask = np.ones((b, l), np.int64)
    mask[1, l - 3:] = 0
    return (torch.from_numpy(rs.randn(b, l, h).astype(np.float32)),
            torch.from_numpy(mask),
            torch.from_numpy(rs.randn(b, l, h).astype(np.float32)),
            torch.from_numpy(rs.randn(b, l, h).astype(np.float32)))


def pipe_encoder(stages=2):
    from mvp_pytorch_tpu_torch.models.layers import (StreamEncoder,
                                                     init_weights)
    cfg = tp_config(num_hidden_layers=8, pipeline_stages=stages)
    enc = StreamEncoder(cfg, cfg.half_layers)
    init_weights(enc, 0.02, torch.Generator().manual_seed(11))
    return enc


def encoder_grads(enc, return_at_layer, scope=None):
    """(out, mid, d hidden, d params) of sum(out * w) + sum(mid * w2)."""
    from mvp_pytorch_tpu_torch.ops.attention import mask_to_bias
    hidden, mask, w, w2 = pipe_encoder_inputs()
    hidden.requires_grad_(True)
    enc.train()
    out, mid = enc(hidden, mask_to_bias(mask),
                   return_at_layer=return_at_layer)
    loss = (out * w).sum() + (0 if mid is None else (mid * w2).sum())
    loss.backward()
    grads = {n: p.grad.clone() for n, p in enc.named_parameters()
             if p.grad is not None}
    return (out.detach(), None if mid is None else mid.detach(),
            hidden.grad.clone(), grads)


def case_pipe(setup, out):
    """A 2-stage GPipe encoder (with and without the mid readout) and a
    2-stage GPipe Trainer step."""
    from mvp_pytorch_tpu_torch.parallel.mesh import make_mesh
    from mvp_pytorch_tpu_torch.parallel.pipeline import pipeline_scope
    mesh = make_mesh(pipe=2)
    for r in (None, 1, 3):
        enc = pipe_encoder()
        with pipeline_scope(mesh, 2, seed=1):
            out[f"enc_{r}"] = encoder_grads(enc, r)
    out["step"] = seeded_step(tp_config(pipeline_stages=2), tp_batch(),
                              mesh=mesh, pipeline_microbatches=2)


# --- expert parallelism -----------------------------------------------------

def moe_config(**kw):
    from mvp_pytorch_tpu_torch.models.config import tiny_config
    return tiny_config(intermediate_size=48, moe_experts=4, moe_top_k=2,
                       moe_every=1, moe_group_size=16,
                       moe_capacity_factor=1.0, **kw)


class MoEHolder(torch.nn.Module):
    def __init__(self, cfg):
        super().__init__()
        from mvp_pytorch_tpu_torch.ops.moe import MoEMLP
        self.moe = MoEMLP(cfg)
        self.moe.init_weights(0.3, torch.Generator().manual_seed(5))
        with torch.no_grad():
            self.moe.router.weight.normal_(
                0, 0.5, generator=torch.Generator().manual_seed(6))


def moe_inputs(seed=9, b=3, l=13, h=32):
    rs = np.random.RandomState(seed)
    return (torch.from_numpy(rs.randn(b, l, h).astype(np.float32)),
            torch.from_numpy(rs.randn(b, l, h).astype(np.float32)))


def moe_grads(holder):
    from mvp_pytorch_tpu_torch.ops.moe import collect_aux, moe_aux_loss
    x, w = moe_inputs()
    x.requires_grad_(True)
    holder.train()
    with collect_aux(holder) as aux_values:
        y = holder.moe(x)
    aux = moe_aux_loss(aux_values)
    ((y * w).sum() + aux).backward()
    return (y.detach(), float(aux.detach()), x.grad.clone(),
            {n: p.grad.clone() for n, p in holder.named_parameters()})


def case_ep(setup, out):
    """MoEMLP with its experts over 2 model ranks, and an EP Trainer step of
    a tiny MoE retrieval model."""
    from mvp_pytorch_tpu_torch.parallel.mesh import (apply_tensor_parallel,
                                                     make_mesh)
    mesh = make_mesh(model=2)
    holder = MoEHolder(moe_config())
    apply_tensor_parallel(holder, mesh)
    out["mlp"] = moe_grads(holder)
    out["step"] = seeded_step(
        moe_config(), make_batch(TP_T, 4, b=4), mesh=mesh,
        prepare=lambda m: apply_tensor_parallel(m, mesh))


# --- sharded retrieval ------------------------------------------------------

def coarse_inputs(n_img=13, cpi=3, d=8, seed=2):
    rs = np.random.RandomState(seed)
    return (torch.from_numpy(rs.randn(n_img, d).astype(np.float32)),
            torch.from_numpy(rs.randn(n_img * cpi, d).astype(np.float32)),
            cpi)


def case_coarse(setup, out):
    from mvp_pytorch_tpu_torch.parallel.sharded_retrieval import (
        sharded_coarse_eval)
    img, txt, cpi = coarse_inputs()
    out["res"] = sharded_coarse_eval(img, txt, cpi, 5, 4, block=7)


# --- sharded checkpoints ----------------------------------------------------

def case_ckpt(setup, out):
    """Save a ZeRO-2 step's optimizer state at world 2; restore a world-1
    save into the world-2 layout and save it again."""
    from mvp_pytorch_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from mvp_pytorch_tpu_torch.training.sharded_checkpoint import (
        consolidate, save_sharded)
    directory = setup["dir"]
    mesh = make_mesh(data=2)
    model = retrieval_model(setup)
    trainer = Trainer(model, pinned_loss(setup["mt"], setup["dice"]),
                      make_optimizer(model, LR), mesh=mesh)
    trainer.step(tensors(shard_batch(mesh, make_batch(setup["mt"],
                                                      setup["seed"]))))
    save_sharded(os.path.join(directory, "w2"),
                 trainer.optimizer_state_tree())
    fresh = Trainer(retrieval_model(setup),
                    pinned_loss(setup["mt"], setup["dice"]),
                    make_optimizer(model, LR), mesh=mesh)
    fresh.load_optimizer_state(consolidate(os.path.join(directory, "w1")))
    save_sharded(os.path.join(directory, "w1_at_w2"),
                 fresh.optimizer_state_tree())


# --- the global batch of a pretraining step ---------------------------------

def pretrain_batch(seed=11, b=B, la=LA, mt=4, r=R):
    """A pretraining batch whose masked means count differently on each
    data rank: MLM labels on a few text and tag positions (one fewer in row
    2), phrase spans (row 2's empty) and QA-pair labels with -1 rows."""
    rs = np.random.RandomState(seed)
    batch = make_batch(mt, seed, b=b, la=la, r=r)
    la_lab = np.full((b, la), -1, np.int64)
    la_lab[:, 1:4] = rs.randint(0, 99, (b, 3))
    la_lab[2, 1] = -1
    lb_lab = np.full((b, mt + r), -1, np.int64)
    lb_lab[:, 1:3] = rs.randint(0, 99, (b, 2))
    start = rs.randint(1, 4, b)
    phrase = np.stack([start, start + rs.randint(1, 4, b)], 1)
    phrase[2] = [3, 3]
    qa_is_next = rs.randint(0, 2, b)
    qa_is_next[[0, 1, 3]] = -1
    batch.update(lm_label_ids_a=la_lab, lm_label_ids_b=lb_lab,
                 phrase_index=phrase,
                 image_index=np.stack([np.full(b, la),
                                       np.full(b, la + r)], 1),
                 qa_ans=rs.randint(0, 7, b), qa_is_next=qa_is_next)
    return batch


def pretrain_step(batch, phrase_mod, mesh=None, steps=2):
    """`steps` Trainer steps of a seeded tiny BiPretrainModel over `batch`
    (this rank's rows): hard negatives, the WRA pick and (in 'sample'
    mode) the WRA negative pinned; the WRA negatives' spans are the global
    batch's rows in either mode."""
    from mvp_pytorch_tpu_torch.models import BiPretrainModel
    from mvp_pytorch_tpu_torch.models.config import tiny_config
    from mvp_pytorch_tpu_torch.tasks.pretrain import pretrain_loss_fn
    model = BiPretrainModel(tiny_config(), qa_pairs=True, device="cpu",
                            seed=3)
    loss_fn = pretrain_loss_fn(
        max_tag_length=4, hn_dice=torch.as_tensor(DICE), phrase_mod=phrase_mod,
        wra_pick=1, wra_neg_offset=4, max_pred_a=3, max_pred_b=2,
        wra_phrase_width=4)
    trainer = Trainer(model, loss_fn, make_optimizer(model, LR), mesh=mesh)
    hist = [trainer.step(tensors(batch)) for _ in range(steps)]
    return hist, trainer.full_state_dict()


def case_pretrain(setup, out):
    """The pretraining step over 2 data ranks (ZeRO-2)."""
    from mvp_pytorch_tpu_torch.parallel.mesh import make_mesh, shard_batch
    mesh = make_mesh(data=2)
    for mod in ("hard", "sample"):
        out[mod] = pretrain_step(shard_batch(mesh, pretrain_batch()), mod,
                                 mesh)


CASES = {"dp": case_dp, "grads": case_grads, "dropout": case_dropout,
         "eval": case_eval, "pretrain": case_pretrain, "tp": case_tp, "pipe": case_pipe, "ep": case_ep,
         "coarse": case_coarse, "ckpt": case_ckpt}


def launch(cases, directory, timeout=60.0, nproc=2):
    """Run `cases` on `nproc` gloo ranks through the port's launcher, with a
    deadline: past it the launcher and its ranks are killed and this raises
    naming the cases. Returns {case: [each rank's results]}."""
    import signal
    import subprocess
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["DIST_INIT_TIMEOUT_S"] = str(int(timeout))
    proc = subprocess.Popen(
        [sys.executable, "-m", "mvp_pytorch_tpu_torch.tools.launch",
         "--nproc", str(nproc), "--", os.path.abspath(__file__),
         ",".join(cases), directory], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise TimeoutError(f"ranks of {cases} ran past {timeout:.0f} s")
    if proc.returncode != 0:
        raise RuntimeError(f"ranks of {cases} failed (rc {proc.returncode})"
                           f":\n{log[-6000:]}")
    return {c: [torch.load(os.path.join(directory, f"{c}_rank{r}.pt"),
                           weights_only=False) for r in range(nproc)]
            for c in cases}


def main():
    names, directory = sys.argv[1].split(","), sys.argv[2]
    torch.set_num_threads(1)
    from mvp_pytorch_tpu_torch.parallel import distributed
    info = distributed.initialize("cpu", need_group=True)
    setup = torch.load(os.path.join(directory, "setup.pt"),
                       weights_only=False)
    for name in names:
        out = {}
        CASES[name](setup, out)
        torch.save(out, os.path.join(
            directory, f"{name}_rank{info['rank']}.pt"))
    distributed.barrier()
    distributed.shutdown()


if __name__ == "__main__":
    main()
