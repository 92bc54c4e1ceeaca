"""SigLIP pretraining steps through the program's trainer.

Set-up builds one `Trainer` over the program's `SiglipModel` and its
`siglip_loss_fn` (AdamW at a constant learning rate, the traffic's betas),
loads the benchmark's seeded weights into it (`reference/siglip.py`
`make_weights`), and draws a pool of `pool` batches of image-text pairs on
the card (`pairs`). As in `train_step.py`, whose driver this one extends
(that file names its two families and is left as it is), the first
`check_steps` steps are the warm-up and the steps the check compares; the
window then steps over the pool until `--seconds` have passed. Tracing
adds the range `bench.vision_fwd` around the vision tower's forward.

The check runs the same first steps with the plain float32 reference (each
layer under activation checkpointing on the card) and plain AdamW from the
same weights and batches, and reads the numbers of `train_step.Driver.
numbers`: the loss gaps, the worst leaf's gap of first-gradient and change
norms, and the whole model's relative difference of them.
"""

from __future__ import annotations

import torch

from benchmark.drivers import train_step
from benchmark.reference import family as ref_family
from benchmark.reference.adamw import AdamW as RefAdamW
from benchmark.reference.common import Numerics, no_tf32


def pairs(cfg: dict, tr: dict, g: torch.Generator, device):
    """`batch` image-text pairs: pixels normal(0, 1) [B, C, S, S], and
    captions of `caption_tokens` ids drawn from the table's rows but the
    pad id, padded to `text_len` with the pad id (no mask, as SigLIP
    pads)."""
    v, t = cfg["vision_config"], cfg["text_config"]
    b, s, length = tr["batch"], v["image_size"], tr["text_len"]
    pixels = torch.randn((b, v["num_channels"], s, s), generator=g,
                         device=device)
    lo, hi = tr["caption_tokens"]
    n = torch.randint(lo, hi + 1, (b, 1), generator=g, device=device)
    words = torch.randint(0, t["vocab_size"] - 1, (b, length), generator=g,
                          device=device)
    pad = t["pad_token_id"]
    words = words + (words >= pad).long()
    pos = torch.arange(length, device=device)[None]
    ids = torch.where(pos < n, words, torch.full_like(words, pad))
    return {"pixel_values": pixels, "input_ids": ids}


class Driver(train_step.Driver):
    def _program(self):
        from mvp_pytorch_tpu_torch.models.siglip import SiglipConfig, \
            SiglipModel
        from mvp_pytorch_tpu_torch.tasks.pretrain import siglip_loss_fn
        from mvp_pytorch_tpu_torch.training.optim import make_optimizer
        from mvp_pytorch_tpu_torch.training.trainer import Trainer
        tr = self.tr
        model = SiglipModel(SiglipConfig.from_dict(self.cfg),
                            device=self.device, seed=self.seed)
        model.load_state_dict(self.W, strict=True)
        opt = make_optimizer(model, tr["learning_rate"], schedule="constant",
                             weight_decay=tr["weight_decay"], b1=tr["b1"],
                             b2=tr["b2"], max_grad_norm=tr["max_grad_norm"])
        return model, opt, Trainer(model, siglip_loss_fn(), opt,
                                   seed=self.seed)

    def setup(self) -> None:
        cfg, tr, dev = self.cfg, self.tr, self.device
        no_tf32()
        self.ref = ref_family(cfg["family"])
        self.W = self.ref.make_weights(cfg, self.seed, dev)
        g = torch.Generator(device=dev).manual_seed(self.seed + 1)
        self.pool = [pairs(cfg, tr, g, dev) for _ in range(tr["pool"])]
        self.model, self.opt, self.trainer = self._program()
        self.losses, self.k, self.mined = [], 0, []
        from mvp_pytorch_tpu_torch.ops import attention as attn
        counters = (lambda: (attn.masked_attention.launches,
                             attn.masked_attention.backward_launches,
                             attn.plain_attention.calls))
        for _ in range(tr["check_steps"]):
            before = counters()
            self.losses.append(self._step())
            if self.k == 1:
                fwd, bwd, plain = (b - a for a, b in zip(before, counters()))
                self.notes.append(f"step 0 attention: {fwd} forward and {bwd} "
                                  f"backward kernel launches, {plain} plain "
                                  f"calls")
            if self.k == 1:
                # the first gradient as AdamW took it: mu = (1 - b1) g
                self.g1 = {n: m.detach() / (1.0 - self.opt.b1)
                           for n, m in zip(self.opt.names, self.opt.mu)}
        self.delta = {n: p.detach() - self.W[n]
                      for n, p in zip(self.opt.names, self.opt.params)}

    def traced(self):
        from benchmark.trace import Tracer
        n = self.tr["trace_steps"]
        with Tracer([(self.opt, "step", "bench.optimizer"),
                     (self.model.vision_model, "forward",
                      "bench.vision_fwd")]) as tr:
            for _ in range(n):
                self._step()
        return tr.summary(n)

    def reference(self, precision: str = "float32", mined=None):
        """The reference's (losses, first gradients, changes) over the
        checked steps."""
        cfg, tr = self.cfg, self.tr
        Wr = {k: v.detach().clone().requires_grad_(True)
              for k, v in self.W.items()}
        model = self.ref.Siglip(Wr, cfg, Numerics(precision),
                                checkpoint=self.device.type == "cuda")
        opt = RefAdamW(Wr, tr["learning_rate"], b1=tr["b1"], b2=tr["b2"],
                       weight_decay=tr["weight_decay"],
                       max_grad_norm=tr["max_grad_norm"])
        losses, g1 = [], None
        for s in range(tr["check_steps"]):
            out = model.pretrain_loss(self.pool[s])
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

    def check(self):
        ref = self.reference("float32")
        prog = self.program_readings()
        for s, (p, r) in enumerate(zip(prog[0], ref[0])):
            self.notes.append(f"step {s} loss program {p} reference {r}")
        return self.numbers(prog, ref)

    def control(self):
        """The same numbers with the reference in float8 in the program's
        place."""
        return self.numbers(self.reference("float8"),
                            self.reference("float32"))
