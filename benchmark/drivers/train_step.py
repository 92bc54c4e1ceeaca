"""Pretraining steps through the program's trainer.

Set-up builds one `Trainer` (the configuration's pretraining model, its
loss_fn, AdamW at a constant learning rate), loads the benchmark's seeded
weights into it, and draws a pool of `pool` batches on the card. Its first
`check_steps` steps, on the pool's first batches, are both the warm-up and
the steps the check compares; the window then goes on with the same
trainer over the pool, a step at a time, until `--seconds` have passed.

The check follows the same first steps with the plain reference
(`reference/<family>.py`, plain AdamW) from the same weights, batches and
random stream (and, two-stream, the program's hard negatives), and reads:
the losses of each step, each parameter's first gradient as AdamW received
it (its first moment after one step) and each parameter's change over the
checked steps, as gaps of norms by the worst leaf and as the whole model's
relative difference; `limits/<cell>.json` says which of them the cell
compares.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Dict, List

import torch

from benchmark import generate, weights
from benchmark.reference import family as ref_family
from benchmark.reference.adamw import AdamW as RefAdamW
from benchmark.reference.common import Numerics, Stream, no_tf32, step_seed

# a leaf whose reference gradient is under this share of the median leaf's
# moves under Adam by rounding alone (a key's bias under softmax): its
# change is not compared
STILL_LEAF = 1e-3


def _model_config(cfg: dict):
    from mvp_pytorch_tpu_torch.models.config import ModelConfig
    return ModelConfig.from_dict(cfg)


def _dtype(cfg: dict) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg["dtype"]]


def loss_gap(prog: List[Dict[str, float]], ref: List[Dict[str, float]]):
    """Widest gap of any loss term at any step, relative to the reference's
    value where that is over 1."""
    return max(abs(p[k] - r[k]) / max(abs(r[k]), 1.0)
               for p, r in zip(prog, ref) for k in r)


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keys=None):
    """Worst leaf's gap between the two sides' norms, against the larger of
    the reference leaf's norm and the median leaf's."""
    keys = list(ref) if keys is None else keys
    med = sorted(ref.values())[len(ref) // 2]
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys)


def rel_diff(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             keys) -> float:
    """The norm of the difference over the reference's norm, over all of
    `keys` together."""
    num = sum(float((prog[k].float() - ref[k]).norm()) ** 2 for k in keys)
    den = sum(float(ref[k].norm()) ** 2 for k in keys)
    return (num / max(den, 1e-60)) ** 0.5


def mine_gap(mined, ref_mining) -> float:
    """How far each hard slot's pair lies below the best negative that the
    reference's similarities offer, as a share of that text's (or image's)
    range of similarities; worst slot of any checked step. The first half
    of the slots pairs the permutation's texts with a hard image, the rest
    its images with a hard text: a slot off that plan, or paired with
    itself, reads 1."""
    worst = 0.0
    if len(mined) != len(ref_mining):
        return 1.0
    for (t, i), m in zip(mined, ref_mining):
        sim, dice = m["sim"], m["dice"]
        n = sim.shape[0]
        h = n // 2
        if t.shape[0] != n or not (torch.equal(t[:h], dice[:h])
                                   and torch.equal(i[h:], dice[h:])):
            return 1.0
        eye = torch.eye(n, dtype=torch.bool, device=sim.device)
        for rows, anchor, other in ((sim, t[:h], i[:h]),
                                    (sim.t(), i[h:], t[h:])):
            r = rows[anchor]
            best = r.masked_fill(eye[anchor], float("-inf")).max(1).values
            span = (r.max(1).values - r.min(1).values).clamp(min=1e-30)
            gap = (best - r.gather(1, other[:, None])[:, 0]) / span
            gap = torch.where(anchor == other, torch.ones_like(gap), gap)
            worst = max(worst, float(gap.max()))
    return worst


class Driver:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed = cell, seed
        self.device = torch.device(device)
        self.cfg, self.tr = cell.config, cell.traffic
        self.notes: List[str] = []
        self.extra: dict = {}
        self.detail: dict = {}

    # ------------------------------------------------------------- program
    def _program(self):
        from mvp_pytorch_tpu_torch.training.optim import make_optimizer
        from mvp_pytorch_tpu_torch.training.trainer import Trainer
        cfg, tr = self.cfg, self.tr
        mc = _model_config(cfg)
        if cfg["family"] == "two_stream":
            from mvp_pytorch_tpu_torch.models.pretrain import BiPretrainModel
            from mvp_pytorch_tpu_torch.tasks.pretrain import pretrain_loss_fn
            model = BiPretrainModel(mc, device=self.device)
            loss_fn = pretrain_loss_fn(
                max_tag_length=tr["tag_len"], hn_mod=tr["hn_mod"],
                phrase_mod=tr["phrase_mod"], max_pred_a=tr["max_pred_a"],
                max_pred_b=tr["max_pred_b"],
                wra_phrase_width=tr["phrase_width"])
        elif cfg["family"] == "single_stream":
            from mvp_pytorch_tpu_torch.models.img_bert import \
                ImgBertForPreTraining
            from mvp_pytorch_tpu_torch.tasks.pretrain import \
                single_stream_loss_fn
            model = ImgBertForPreTraining(mc, use_mrfr=True,
                                          od_tag_size=cfg["od_tag_size"],
                                          device=self.device)
            loss_fn = single_stream_loss_fn(
                max_pred=tr["max_pred_a"] + tr["max_pred_b"])
        else:
            raise ValueError(cfg["family"])
        model.load_state_dict(self.W, strict=True)
        opt = make_optimizer(model, tr["learning_rate"], schedule="constant",
                             weight_decay=tr["weight_decay"],
                             max_grad_norm=tr["max_grad_norm"])
        return model, opt, Trainer(model, loss_fn, opt, seed=self.seed)

    def setup(self) -> None:
        cfg, tr, dev = self.cfg, self.tr, self.device
        no_tf32()
        self.ref = ref_family(cfg["family"])
        self.W = weights.make(self.ref.param_spec(cfg, "pretrain"), cfg,
                              self.seed, dev)
        g = torch.Generator(device=dev).manual_seed(self.seed + 1)
        self.pool = [generate.pretrain_batch(cfg["family"], cfg, tr, g, dev)
                     for _ in range(tr["pool"])]
        self.model, self.opt, self.trainer = self._program()
        self.losses, self.k, self.mined = [], 0, []
        with self._recording_mining():
            for _ in range(tr["check_steps"]):
                self.losses.append(self._step())
                if self.k == 1:
                    # the first gradient as AdamW took it: mu = (1 - b1) g
                    self.g1 = {n: m.detach() / (1.0 - self.opt.b1)
                               for n, m in zip(self.opt.names, self.opt.mu)}
        self.delta = {n: p.detach() - self.W[n]
                      for n, p in zip(self.opt.names, self.opt.params)}

    @contextlib.contextmanager
    def _recording_mining(self):
        """Keep the hard-negative pairs that the two-stream model picks in
        each checked step (its `mine_hard_negatives`' result), which the
        reference follows: an argmax over nearly tied similarities flips
        with rounding. The choice itself is judged by `mine_gap`."""
        if self.cfg["family"] != "two_stream":
            yield
            return
        from mvp_pytorch_tpu_torch.models.bi_encoder import BiEncoder
        orig = BiEncoder.mine_hard_negatives

        def mine(model, *args, **kwargs):
            txt, img = orig(model, *args, **kwargs)
            self.mined.append((txt.clone(), img.clone()))
            return txt, img
        BiEncoder.mine_hard_negatives = mine
        try:
            yield
        finally:
            BiEncoder.mine_hard_negatives = orig

    def _step(self) -> Dict[str, float]:
        out = self.trainer.step(self.pool[self.k % len(self.pool)])
        self.k += 1
        return out

    # -------------------------------------------------------------- window
    def window(self, seconds: float):
        failed, n = 0, 0
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else (lambda: None))
        sync()
        t0 = time.perf_counter()
        marks = [t0]
        while True:
            out = self._step()
            n += 1
            failed += not math.isfinite(out["loss"])
            marks.append(time.perf_counter())
            if marks[-1] - t0 >= seconds:
                break
        sync()
        dt = time.perf_counter() - t0
        ms = sorted(1e3 * (b - a) for a, b in zip(marks, marks[1:]))
        self.notes.append(
            f"window {n} steps in {dt:.3f} s; step ms min {ms[0]:.2f} "
            f"median {ms[len(ms) // 2]:.2f} max {ms[-1]:.2f}")
        b = self.tr["batch"]
        e2e = {"train_samples_per_s": n * b / dt}
        flops = self.cell.flops().train_step(self.cfg, self.tr)
        self.extra.update(flops_per_step=flops)
        return e2e, {"seconds": dt, "units": n, "attempted": n,
                     "failed": failed}

    def traced(self):
        from benchmark.trace import Tracer
        n = self.tr["trace_steps"]
        with Tracer([(self.opt, "step", "bench.optimizer")]) as tr:
            for _ in range(n):
                self._step()
        return tr.summary(n)

    def memory_peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def free(self) -> None:
        keep = self.tr["check_steps"]
        del self.trainer, self.opt, self.model
        self.pool = self.pool[:keep]
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # --------------------------------------------------------------- check
    def reference(self, precision: str = "float32", mined=None):
        """The reference's (losses, first gradients, changes) over the
        checked steps, following `mined` hard pairs where given; its own
        mining of each step goes to `self.ref_mining`."""
        cfg, tr, dev = self.cfg, self.tr, self.device
        Wr = {k: v.detach().clone().requires_grad_(True)
              for k, v in self.W.items()}
        kind = "TwoStream" if cfg["family"] == "two_stream" else \
            "SingleStream"
        model = getattr(self.ref, kind)(Wr, cfg, Numerics(precision))
        opt = RefAdamW(Wr, tr["learning_rate"],
                       weight_decay=tr["weight_decay"],
                       max_grad_norm=tr["max_grad_norm"])
        losses, g1 = [], None
        self.ref_mining = []
        for s in range(tr["check_steps"]):
            gen = torch.Generator(device=dev).manual_seed(
                step_seed(self.seed, s))
            st = Stream(gen, cfg["hidden_dropout_prob"],
                        cfg["attention_probs_dropout_prob"], _dtype(cfg))
            batch = self.pool[s]
            if cfg["family"] == "two_stream":
                out = model.pretrain_loss(
                    batch, st, max_tag_length=tr["tag_len"],
                    max_pred_a=tr["max_pred_a"], max_pred_b=tr["max_pred_b"],
                    phrase_width=tr["phrase_width"],
                    mined=self._usable(mined, s, batch))
                self.ref_mining.append(model.mining)
            else:
                out = model.pretrain_loss(
                    batch, st, max_pred=tr["max_pred_a"] + tr["max_pred_b"])
            grads = torch.autograd.grad(out["loss"], list(Wr.values()),
                                        allow_unused=True)
            opt.step({k: g if g is not None else torch.zeros_like(Wr[k])
                      for k, g in zip(Wr, grads)})
            losses.append({k: float(v.detach()) for k, v in out.items()})
            if s == 0:
                g1 = {k: m.clone() / (1.0 - opt.b1)
                      for k, m in opt.mu.items()}
            del out, grads
        delta = {k: Wr[k].detach() - self.W[k] for k in Wr}
        return losses, g1, delta

    def numbers(self, prog, ref) -> Dict[str, float]:
        """The compared numbers of `prog` readings against `ref`'s: each
        (losses a step, first gradients, changes over the checked steps)."""
        (pl, pg, pd), (rl, rg, rd) = prog, ref
        norms = [{k: float(t.norm()) for k, t in d.items()}
                 for d in (pg, rg, pd, rd)]
        png, rgn, pdn, rdn = norms
        med = sorted(rgn.values())[len(rgn) // 2]
        moving = [k for k in rdn if rgn[k] >= STILL_LEAF * med]
        out = {"loss_gap": loss_gap(pl, rl),
               "loss0_gap": loss_gap(pl[:1], rl[:1]),
               "grad_gap": leaf_gap(png, rgn),
               "update_gap": leaf_gap(pdn, rdn, moving),
               "grad_diff": rel_diff(pg, rg, list(rg)),
               "update_diff": rel_diff(pd, rd, moving)}
        for name, p, r, keys in (("grad", png, rgn, list(rgn)),
                                 ("update", pdn, rdn, moving)):
            m = sorted(r[k] for k in keys)[len(keys) // 2]
            gaps = sorted(((abs(p[k] - r[k]) / max(r[k], m, 1e-30), k)
                           for k in keys), reverse=True)
            self.detail[name] = [(k, g, p[k], r[k]) for g, k in gaps[:6]]
        self.detail["loss"] = sorted(
            ((abs(p[k] - r[k]) / max(abs(r[k]), 1.0), s, k)
             for s, (p, r) in enumerate(zip(pl, rl)) for k in r),
            reverse=True)[:4]
        return out

    def program_readings(self):
        losses = [{k: v for k, v in out.items() if k != "grad_norm"}
                  for out in self.losses]
        return losses, self.g1, self.delta

    @staticmethod
    def _usable(mined, s, batch):
        """Step s's given hard pairs, if they are one per row of its
        batch (a program that dropped rows gave fewer: `mine_gap` then
        reads 1, and the reference keeps its own)."""
        if mined is None or len(mined) <= s or \
                mined[s][0].shape[0] != batch["input_ids_a"].shape[0]:
            return None
        return mined[s]

    def check(self) -> Dict[str, float]:
        mined = self.mined or None
        ref = self.reference("float32", mined)
        prog = self.program_readings()
        for s, (p, r) in enumerate(zip(prog[0], ref[0])):
            self.notes.append(f"step {s} loss program {p} reference {r}")
        out = self.numbers(prog, ref)
        if mined:
            out["mine_gap"] = mine_gap(mined, self.ref_mining)
        return out

    def control(self) -> Dict[str, float]:
        """The same numbers with the reference in float8 in the program's
        place: its own hard negatives, which the float32 reference then
        follows."""
        low = self.reference("float8")
        mined = ([(m["txt"], m["img"]) for m in self.ref_mining]
                 if self.mined else None)
        ref = self.reference("float32", mined)
        out = self.numbers(low, ref)
        if mined:
            out["mine_gap"] = mine_gap(mined, self.ref_mining)
        return out
