#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mvp_pytorch_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --sweep float32   # phase 3 alone, in one dtype
    python3 chip_smoke.py --cli             # phase 7 alone

Phases, each ended by torch.cuda.synchronize(); any failure raises and the
script exits non-zero:
1. print the card (name, power limit) and build the kernels from csrc/;
   print each kernel's registers and spills (ptxas), its tensor-core
   instructions (HMMA/HGMMA in the SASS, from cuobjdump) and its resident
   blocks per SM; fail if a bf16 or an fp32 (3xTF32) kernel has no
   tensor-core instruction, or a dropout instantiation another count than
   its p = 0 twin;
2. hold the masked-attention kernel against its plain PyTorch version at the
   main path's shapes (fused L 125, text 75, vision 70; H 12, D 64; B 1,000
   and 8), both dtypes, both layouts, with padded 2-D key masks, 3-D masks,
   Lk > Lq, fully-masked rows, a bf16 bias and D 32 / 128, and across the
   bf16 kernel's 128-row tiles (Lk 200, L 160, B 1, odd lengths 17 / 129 and
   1 / 1); tolerances fp32 2e-5, bf16 0.05. Time the kernel, the plain
   version and, as a yardstick the port never calls,
   F.scaled_dot_product_attention with the same mask, at the main path's
   batches (1,000 pairs fused; 500 text or images). Then the attention
   backward (`MaskedAttentionFn`: the kernel forward, the recompute backward)
   at the training shapes (B 96; L 125, 75, 70), both dtypes and layouts,
   padded key masks with a fully-masked row and a 3-D mask: q, k, v and bias
   grads against torch autograd through the plain version in fp32 on the
   same values (fp32 1e-4, bf16 0.05); the forward and the backward timed
   beside the plain version's and, as a yardstick the port never calls,
   F.scaled_dot_product_attention forward and forward+backward. Then the
   attention-prob dropout (p 0.1) inside the kernel, both dtypes and
   layouts: the kernel's mask read back (q = k = 0, v = I at Lk = D = 64, so
   each output row is keep / (64 (1 - p))) equal bit for bit to the plain
   hash's at B 96, L 125, with a keep share within 0.002 of 0.9; the dropout
   kernel against the plain dropout version at the training shapes
   (fp32 2e-5, bf16 0.05) and its backward against fp32 autograd of the
   plain dropout version (fp32 1e-4, bf16 0.05); the dropout kernel timed
   beside the p = 0 kernel and F.scaled_dot_product_attention(dropout_p=0.1);
3. two-stage retrieval scoring at MVPTR-base width and depth (hidden 768,
   6+6+6 layers, vocab 86,051, seeded random weights) at the bench
   geometry: 1,000 images x 5 captions, LA 75, T 20, R 50, K 20/10, encoder
   batch 500, pair batch 1,000: two sweeps in bf16, then one in fp32 (the
   default `ModelConfig.dtype`; matmuls in full fp32, TF32 off), each after
   a warm-up on a subset; every sweep must launch the kernel exactly
   6 x (10 + 2 + 70) = 492 times; pairs/s and peak memory;
4. the kernel path against the plain path end to end at full width on a few
   padded captions and images: ITM probabilities and global embeddings;
5. the retrieval training step at MVPTR-base (bf16 over fp32 weights, the
   config's dropouts 0.1 / 0.1) on one fixed batch of 96 (LA 75, T 20, R 50,
   hard negatives), AdamW lr 4e-5 with clip 1.0: 3 warm-up steps through
   `train_retrieval`, then 10 timed `Trainer` steps; exactly 24 kernel
   launches per step, all of them the dropout instantiation, finite losses
   and a last loss below the first; step ms, samples/s and peak memory.
   Then one step's kernel path against its plain path (the same dropout
   masks, drawn from the same generator), in fp32 and bf16, with the hard
   pairs pinned to the kernel run's: the losses and the relative error of
   the gradients of a query weight of each encoder, the classifier and
   logit_scale;
6. the pretraining step (`BiPretrainModel`, the five losses) at MVPTR-base
   in bf16 at the config's dropouts 0.1 / 0.1, on bench.py's pretraining
   geometry (bench.py:416-440: B 96, LA 75 = 70 text + 5 phrase slots, T 20,
   R 50, 8 masked text and 3 masked tag positions, max_pred 20 / 10, phrase
   span [9, 14], image span [75, 125], WRA 'sample', hard negatives), half
   the captions and images padded, AdamW lr 1e-4: 3 warm-up steps through
   `train_pretrain`, then 10 timed `Trainer` steps; exactly 24 kernel
   launches per step, all of them the dropout instantiation, no call of the
   plain attention, finite losses and a last loss below the first; step ms,
   samples/s and peak memory. Then one step at dropouts 0 with the QA heads
   (3,129 answers, QA-pair relation), the slot permutation, the WRA pick and
   negative and the hard pairs pinned: kernel path against plain path, in
   fp32 and bf16, on the seven losses and five named gradients (phase 5's
   tolerances);
7. the retrieval command line (`tasks.retrieval.main`) at MVPTR-base on a
   root it writes under `_smoke/` with the port's `tsv_writer` at
   bench.py:99-105's Flickr30k test geometry (1,000 images x 5 captions,
   50 regions x 2,054 fp32 and 50 tags an image, captions past LA 75 =
   70 text + 5 phrase slots): 13 batches of 96 fetched into memory and
   trained with `train_retrieval` (bf16, the config's dropouts 0.1 / 0.1,
   the CLI's default lr 4e-5, linear decay); then 26 steps through the CLI
   and its process loader (4 forked workers),
   each step launching the dropout kernel exactly 24 times and the plain
   attention never, the losses finite and the last five below the first
   (from seeded weights they fall to chance and stay there), step 1's loss
   equal to the in-memory run's (the loader delivered the sampler's batch); samples/s over steps
   6-26 beside the in-memory steps 4-13 (target ratio 0.90, not a failure),
   the main thread's data ms a step, the workers' ms a batch, the H2D copy's
   device ms and whether the native decode is on; then the CLI's eval of
   the trained checkpoint (K 20 / 10, encoder batch 500, rerank batch
   1,000): exactly 492 launches, and ranks, candidates and fine scores
   (within 1e-6) equal to `two_stage_scoring` on the dataset's arrays in
   memory. The root is deleted at the end;
8. one JSON line of kernel numbers (the bf16 kernel, then the fp32 one),
   then the result line.

With `--sweep DTYPE` only phase 3 runs, in that dtype (bf16: two sweeps,
fp32: one), and the last line is a JSON object of its numbers; run from a
copy of another tree, the script drives that tree's package. With `--cli`
only phases 1 (the build) and 7 run, the last line a JSON object of phase
7's numbers.

Exits 2 without a result when no CUDA device is visible.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,    # dense tensor cores
              "float32": 495e12}     # dense TF32 tensor cores
# tensor-core passes per product: fp32 at fp32 accuracy takes three TF32
# passes (3xTF32: lo.hi + hi.lo + hi.hi)
PASSES = {"bfloat16": 1, "float32": 3}
TOL = {"float32": 2e-5, "bfloat16": 0.05}
E2E_TOL = {"float32": 1e-4, "bfloat16": 0.02}
# attention grads against fp32 autograd of the plain version: fp32, the same
# math summed in another order; bf16, the grads rounded to bf16 at |g| ~ 4
GRAD_TOL = {"float32": 1e-4, "bfloat16": 0.05}
# one training step, kernel path against plain path (hard pairs pinned):
# loss abs error, and ||g_kernel - g_plain|| / ||g_plain|| of each named
# parameter. bf16: the plain path's backward runs through bf16 scores and
# probabilities, the kernel path's recomputes them in fp32, so a few bf16
# ulps (2^-8) per element, over 18 layers
STEP_TOL = {"float32": (1e-4, 1e-3), "bfloat16": (0.02, 0.05)}
TRAIN_B, TRAIN_WARMUP, TRAIN_TIMED = 96, 3, 10
GRAD_PARAMS = ("bert.txt_encoder.layer.0.attention.self.query.weight",
               "bert.vis_encoder.layer.0.attention.self.query.weight",
               "bert.mul_encoder.layer.0.attention.self.query.weight",
               "classifier.weight", "logit_scale")
PRETRAIN_GRAD_PARAMS = ("bert.embeddings.word_embeddings.weight",
                        "cls.predictions.transform.dense.weight",
                        "half_mlm.transform.dense.weight",
                        "bert.vis_encoder.layer.0.attention.self.query.weight",
                        "bert.mul_encoder.layer.0.attention.self.query.weight")
PRETRAIN_LOSSES = ("total_loss", "vis_mlm_loss", "retrieval_loss",
                   "masked_lm_loss", "itm_loss", "qa_loss", "wra_loss")
DROP_P = 0.1                         # ModelConfig's default dropouts
KEEP_SHARE_TOL = 0.002
DEVICE = "cuda"
H, D = 12, 64
LENGTHS = {"fused": 125, "text": 75, "vis": 70}
MAIN_BATCH = {"fused": 1000, "text": 500, "vis": 500}   # pair / encoder batch
KERNEL_SOURCE = "mvp_pytorch_tpu_torch/csrc/masked_attention.cu"
REPLACES = "mvp_pytorch_tpu/ops/attention.py:114 (git 8625894^; also :169)"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device ms per call of `fn`. The card first sleeps for about 50 ms,
    long enough for the host to queue all `iters` calls, so that the events
    time the device running them back to back, not the host's enqueue rate
    (at B 96 a call's host work is longer than its kernel)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def attention_bound_ms(b, lq, lk, dtype_name, bias) -> tuple:
    """(bound ms, 'bytes' | 'operations'): q, k, v, out and the bias read or
    written once, against 4 B H Lq Lk D operations per pass at the type's
    tensor-core peak."""
    elem = 2 if dtype_name == "bfloat16" else 4
    nbytes = elem * H * D * b * (2 * lq + 2 * lk)
    if bias is not None:
        nbytes += bias.numel() * bias.element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (PASSES[dtype_name] * 4.0 * b * H * lq * lk * D
             / PEAK_FLOPS[dtype_name] * 1e3)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_bwd_bound_ms(b, lq, lk, dtype_name, bias) -> tuple:
    """(bound ms, 'bytes' | 'operations') of the backward: q, k, v, the
    output's grad and the bias read once, dq, dk, dv written once, against
    10 B H Lq Lk D operations per pass (q.k^T again, g.v^T, p^T.g, ds.k,
    ds^T.q)."""
    elem = 2 if dtype_name == "bfloat16" else 4
    nbytes = elem * H * D * b * (3 * lq + 4 * lk)
    if bias is not None:
        nbytes += bias.numel() * bias.element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (PASSES[dtype_name] * 10.0 * b * H * lq * lk * D
             / PEAK_FLOPS[dtype_name] * 1e3)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_report(path) -> dict:
    """Kernel name -> its ptxas lines (registers, spills) from the build."""
    report, name = {}, None
    with open(path) as f:
        for line in f:
            if "Compiling entry function" in line:
                name = line.split("'")[1]
            elif name and ("registers" in line or "spill" in line):
                report.setdefault(name, []).append(
                    " ".join(line.replace("ptxas info    :", "").split()))
    return report


def phase1_kernel_report(torch, attn, kernels_mod, lib_path):
    """Registers, tensor-core instructions and resident blocks per SM of
    every kernel; fails unless each bf16 and each fp32 (3xTF32) kernel has
    HMMA/HGMMA in its SASS (TF32 shows as HMMA.1684.F32.TF32) and each
    dropout instantiation has as many as its p = 0 twin."""
    ptxas = ptxas_report(os.path.join(kernels_mod.BUILD, "ptxas.log"))
    sass = kernels_mod.sass_mma_counts(lib_path)
    names = sorted(n for n in set(ptxas) | set(sass) if "masked_attention" in n)
    for name in names:
        log(f"  {name}: HMMA/HGMMA={sass.get(name, 'missing')}  "
            + "  ".join(ptxas.get(name, ["no ptxas report"])))
    for dn, key in (("bf16", "masked_attention_mma"),
                    ("fp32", "masked_attention_3xtf32")):
        tc = [n for n in names if key in n]
        if not tc or any(sass.get(n, 0) == 0 for n in tc):
            raise AssertionError(
                f"a {dn} kernel has no tensor-core instruction in its SASS: "
                f"{[(n, sass.get(n)) for n in tc]}")
    # each dropout instantiation (template argument kDrop = true, "Lb1E" in
    # the mangled name) runs the same products as its p = 0 twin
    drops = [n for n in names if "Lb1EE" in n]
    if len(drops) != len(names) // 2:
        raise AssertionError(f"{len(drops)} dropout kernels of {len(names)}")
    for n in drops:
        twin = n.replace("Lb1EE", "Lb0EE")
        if sass.get(n) != sass.get(twin) or twin not in sass:
            raise AssertionError(f"dropout kernel {n} has {sass.get(n)} "
                                 f"HMMA, its p = 0 twin {sass.get(twin)}")
    for dn, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        log(f"  resident blocks per SM, {dn}, D {D}, fp32 bias: "
            f"{attn.kernel_blocks_per_sm(dt, D)}")


def phase2_kernel_vs_plain(torch, attn):
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(1)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def qkv(b, lq, lk, dt, layout, d=D, exact=False):
        """q, k, v; with `exact`, q and k in multiples of 1/8 so that q.k is
        exact in every summation order (a fully-masked fp32 row keeps only 10
        fraction bits next to the -10000 bias, where two correct orders may
        round a score to neighbouring values)."""
        def one(l, quantize):
            x = torch.randn(b, l, H, d, device="cuda", generator=gen)
            if quantize:
                x = torch.clamp(torch.round(x * 8) / 8, -4, 4)
            x = x.to(dt)
            return x if layout == "blhd" else x.transpose(1, 2).contiguous()
        return one(lq, exact), one(lk, exact), one(lk, False)

    def key_mask(b, lk, full_row=False):
        lens = torch.randint(lk // 2, lk + 1, (b,), device="cuda",
                             generator=gen)
        mask = (torch.arange(lk, device="cuda")[None, :] < lens[:, None])
        mask = mask.to(torch.int32)
        if full_row:
            mask[0] = 0
        return mask

    def query_mask(b, lq, lk, full_row=False):
        mask = (torch.rand(b, lq, lk, device="cuda", generator=gen) > 0.3)
        mask = mask.to(torch.int32)
        mask[..., 0] = 1
        if full_row:
            mask[:, lq // 2] = 0
        return mask

    cases = []
    for name, l in LENGTHS.items():
        for b in (1000, 8):
            for dn in dtypes:
                for layout in ("bhld", "blhd"):
                    cases.append((f"{name} 2-D padded keys", b, l, l, dn,
                                  layout, "key", D, "float32"))
    for dn in dtypes:
        for layout in ("bhld", "blhd"):
            cases += [
                ("fused 3-D mask", 1000, 125, 125, dn, layout, "query", D, "float32"),
                ("Lk>Lq 75/125", 1000, 75, 125, dn, layout, "key", D, "float32"),
                ("fully-masked rows 2-D", 8, 125, 125, dn, layout, "key_full", D, "float32"),
                ("fully-masked rows 3-D", 8, 125, 125, dn, layout, "query_full", D, "float32"),
                ("bf16 bias", 8, 125, 125, dn, layout, "key", D, "bfloat16"),
                ("D=32", 8, 125, 125, dn, layout, "key", 32, "float32"),
                ("D=128", 8, 125, 125, dn, layout, "query", 128, "float32"),
                ("no bias", 8, 70, 70, dn, layout, None, D, "float32"),
                ("Lk>128 75/200", 8, 75, 200, dn, layout, "key", D, "float32"),
                ("Lq>128 160/160", 8, 160, 160, dn, layout, "query", D, "float32"),
                ("B=1", 1, 125, 125, dn, layout, "key", D, "float32"),
                ("odd 17/129", 8, 17, 129, dn, layout, "key", D, "float32"),
                ("odd 1/1", 8, 1, 1, dn, layout, None, D, "float32"),
            ]
    errors = {}
    for label, b, lq, lk, dn, layout, mk, d, bias_dt in cases:
        q, k, v = qkv(b, lq, lk, dtypes[dn], layout, d,
                      exact=bool(mk) and mk.endswith("_full"))
        if mk is None:
            bias = None
        elif mk.startswith("key"):
            bias = attn.mask_to_bias(key_mask(b, lk, mk == "key_full"))
        else:
            bias = attn.mask_to_bias(query_mask(b, lq, lk, mk == "query_full"))
        if bias is not None:
            bias = bias.to(dtypes[bias_dt])
        plain = (attn.plain_attention_blhd if layout == "blhd"
                 else attn.plain_attention)
        got = attn.masked_attention(q, k, v, bias, layout=layout)
        want = plain(q, k, v, bias)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        finite = bool(torch.isfinite(got.float()).all())
        ok = finite and err <= TOL[dn]
        log(f"  kernel vs plain  {label:24s} B={b:<5d} Lq={lq:<4d} Lk={lk:<4d} "
            f"D={d:<4d} {dn:9s} {layout}  max|err|={err:.3e}  "
            f"tol={TOL[dn]:g}  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel disagrees with plain: {label} "
                                 f"{dn} {layout} err={err} finite={finite}")
        errors[(label, b, dn, layout)] = err
        del q, k, v, bias, got, want

    timings = {}
    for name, l in LENGTHS.items():
        for dn in dtypes:
            b = MAIN_BATCH[name]
            q, k, v = qkv(b, l, l, dtypes[dn], "blhd")
            bias = attn.mask_to_bias(key_mask(b, l))
            qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
            mask_lib = bias.to(dtypes[dn])
            ms = cuda_ms(lambda: attn.masked_attention(q, k, v, bias,
                                                       layout="blhd"))
            plain_ms = cuda_ms(lambda: attn.plain_attention_blhd(q, k, v, bias))
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask_lib))
            lib_err = (F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask_lib).transpose(1, 2).float()
                - attn.plain_attention_blhd(q, k, v, bias).float()
            ).abs().max().item()
            bound, by = attention_bound_ms(b, l, l, dn, bias)
            timings[(name, dn)] = dict(ms=ms, plain_ms=plain_ms,
                                       library_ms=lib_ms, bound_ms=bound,
                                       bound_by=by)
            log(f"  time {name:5s} B={b} L={l} {dn:9s} blhd: kernel "
                f"{ms:.4f} ms  plain {plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms "
                f"(|sdpa-plain| {lib_err:.2e})  bound {bound:.4f} ms ({by})  "
                f"bound/kernel {bound / ms:.3f}  kernel/sdpa {ms / lib_ms:.3f}")
            del q, k, v, bias, qh, kh, vh, mask_lib
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return errors, timings


def phase2_backward(torch, attn):
    """MaskedAttentionFn's grads against fp32 autograd of the plain version
    at the training shapes, and the forward/backward times."""
    import torch.nn.functional as F
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def inputs(l, dt, layout, mask_kind):
        x = [torch.randn(TRAIN_B, l, H, D, device=DEVICE, generator=gen)
             .to(dt) for _ in range(4)]              # q, k, v, grad of out
        if layout == "bhld":
            x = [t.transpose(1, 2).contiguous() for t in x]
        lens = torch.randint(l // 2, l + 1, (TRAIN_B,), device=DEVICE,
                             generator=gen)
        if mask_kind == "query":
            mask = (torch.rand(TRAIN_B, l, l, device=DEVICE, generator=gen)
                    > 0.3).to(torch.int32)
            mask[..., 0] = 1
            mask[:, l // 2] = 0                      # a fully-masked row
        else:
            mask = (torch.arange(l, device=DEVICE)[None, :]
                    < lens[:, None]).to(torch.int32)
            mask[0] = 0                              # a fully-masked row
        return x, attn.mask_to_bias(mask)

    errs = {}
    for name, l in LENGTHS.items():
        for dn, dt in dtypes.items():
            for layout in ("blhd", "bhld"):
                for mk in (("key", "query") if name == "fused" else ("key",)):
                    (q, k, v, g), bias = inputs(l, dt, layout, mk)
                    leaves = [t.requires_grad_() for t in (q, k, v, bias)]
                    before = attn.masked_attention.launches
                    out = attn.masked_attention(q, k, v, bias, layout=layout)
                    if not isinstance(out.grad_fn,
                                      attn.MaskedAttentionFn._backward_cls):
                        raise AssertionError("kernel output has no grad_fn")
                    got = torch.autograd.grad(out, leaves, g)
                    ref_in = [t.detach().float().requires_grad_()
                              for t in leaves]
                    plain = (attn.plain_attention_blhd if layout == "blhd"
                             else attn.plain_attention)
                    want = torch.autograd.grad(plain(*ref_in), ref_in,
                                               g.float())
                    torch.cuda.synchronize()
                    if attn.masked_attention.launches != before + 1:
                        raise AssertionError("the backward launched a kernel")
                    err = max((a.float() - b).abs().max().item()
                              for a, b in zip(got, want))
                    finite = all(bool(torch.isfinite(a).all()) for a in got)
                    ok = finite and err <= GRAD_TOL[dn]
                    log(f"  grads vs plain   {name:5s} {mk:5s} B={TRAIN_B} "
                        f"L={l:<4d} {dn:9s} {layout}  max|err|={err:.3e}  "
                        f"tol={GRAD_TOL[dn]:g}  {'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(
                            f"attention grads disagree: {name} {mk} {dn} "
                            f"{layout} err={err} finite={finite}")
                    errs[(name, dn, layout, mk)] = err
                    del q, k, v, g, bias, leaves, out, got, ref_in, want

    timings = {}
    for name, l in LENGTHS.items():
        for dn, dt in dtypes.items():
            (q, k, v, g), bias = inputs(l, dt, "blhd", "key")
            qkv = [t.requires_grad_() for t in (q, k, v)]
            out = attn.masked_attention(*qkv, bias, layout="blhd")
            fwd = cuda_ms(lambda: attn.masked_attention(q, k, v, bias,
                                                        layout="blhd"))
            bwd = cuda_ms(lambda: torch.autograd.grad(out, qkv, g,
                                                      retain_graph=True))
            p_out = attn.plain_attention_blhd(*qkv, bias)
            plain_bwd = cuda_ms(lambda: torch.autograd.grad(
                p_out, qkv, g, retain_graph=True))
            qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_()
                          for t in (q, k, v))
            mask_lib = bias.to(dt)
            sdpa_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask_lib))
            gh = g.transpose(1, 2)
            sdpa_fb = cuda_ms(lambda: torch.autograd.grad(
                F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask_lib),
                (qh, kh, vh), gh))
            bound, by = attention_bwd_bound_ms(TRAIN_B, l, l, dn, bias)
            fwd_bound, fwd_by = attention_bound_ms(TRAIN_B, l, l, dn, bias)
            timings[(name, dn)] = dict(
                fwd_ms=fwd, fwd_bound_ms=fwd_bound, fwd_bound_by=fwd_by,
                bwd_ms=bwd, plain_bwd_ms=plain_bwd,
                sdpa_fwd_ms=sdpa_fwd, sdpa_fwd_bwd_ms=sdpa_fb,
                bwd_bound_ms=bound, bwd_bound_by=by,
                grad_err=max(v for k_, v in errs.items()
                             if k_[:2] == (name, dn)))
            log(f"  time train {name:5s} B={TRAIN_B} L={l} {dn:9s} blhd: "
                f"kernel fwd {fwd:.4f} ms (bound {fwd_bound:.4f}, {fwd_by}; "
                f"kernel/sdpa {fwd / sdpa_fwd:.3f})  "
                f"recompute bwd {bwd:.4f} ms  "
                f"plain bwd {plain_bwd:.4f} ms  sdpa fwd {sdpa_fwd:.4f} ms  "
                f"sdpa fwd+bwd {sdpa_fb:.4f} ms  bwd bound {bound:.4f} ms "
                f"({by})")
            del q, k, v, g, bias, qkv, out, p_out, qh, kh, vh, gh, mask_lib
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return timings


def phase2_dropout(torch, attn):
    """Attention-prob dropout inside the kernel: the mask read back bit for
    bit, the dropout kernel and its backward against the plain dropout
    version at the training shapes, and its time beside the p = 0 kernel and
    SDPA with the same dropout."""
    import torch.nn.functional as F
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def new_seed():
        return torch.randint(-2 ** 63, 2 ** 63 - 1, (1,), dtype=torch.int64,
                             device=DEVICE, generator=gen)

    # the mask: q = k = 0 gives uniform probabilities 1/64 over Lk = D = 64
    # keys, v = I per (b, h) copies each probability to its own dim
    lq, lk = LENGTHS["fused"], D
    for dn, dt in dtypes.items():
        for layout in ("bhld", "blhd"):
            seed = new_seed()
            q = torch.zeros(TRAIN_B, H, lq, D, device=DEVICE, dtype=dt)
            k = torch.zeros(TRAIN_B, H, lk, D, device=DEVICE, dtype=dt)
            v = torch.eye(lk, device=DEVICE, dtype=dt).expand(
                TRAIN_B, H, lk, D).contiguous()
            if layout == "blhd":
                q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            before = attn.masked_attention.dropout_launches
            out = attn.masked_attention(q, k, v, layout=layout,
                                        dropout_p=DROP_P, seed=seed)
            torch.cuda.synchronize()
            if attn.masked_attention.dropout_launches != before + 1:
                raise AssertionError("the dropout kernel was not launched")
            if layout == "blhd":
                out = out.transpose(1, 2)
            got = out > 0
            want = attn.dropout_keep(seed, DROP_P, (TRAIN_B, H, lq, lk))
            mismatched = int((got != want).sum())
            share = got.float().mean().item()
            value = torch.tensor(1.0 / lk / (1.0 - DROP_P)).to(dt).float()
            bad_value = int((out.float()[got] != value.to(DEVICE)).sum())
            ok = (mismatched == 0 and bad_value == 0
                  and abs(share - (1 - DROP_P)) <= KEEP_SHARE_TOL)
            log(f"  dropout mask     {dn:9s} {layout}  B={TRAIN_B} Lq={lq} "
                f"Lk={lk}: {got.numel()} elements, {mismatched} differ from "
                f"the plain hash, keep share {share:.6f} "
                f"(want {1 - DROP_P} +- {KEEP_SHARE_TOL}), {bad_value} kept "
                f"values off 1/(Lk (1-p))  {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"dropout mask {dn} {layout}: "
                                     f"{mismatched} differ, share {share}")
            del q, k, v, out, got, want

    def inputs(l, dt, layout):
        x = [torch.randn(TRAIN_B, l, H, D, device=DEVICE, generator=gen)
             for _ in range(4)]                      # q, k, v, grad of out
        # q and k in multiples of 1/8: q.k is exact in every summation order,
        # as the fully-masked fp32 row needs (phase2_kernel_vs_plain's qkv)
        x[:2] = [torch.clamp(torch.round(t * 8) / 8, -4, 4) for t in x[:2]]
        x = [t.to(dt) for t in x]
        if layout == "bhld":
            x = [t.transpose(1, 2).contiguous() for t in x]
        lens = torch.randint(l // 2, l + 1, (TRAIN_B,), device=DEVICE,
                             generator=gen)
        mask = (torch.arange(l, device=DEVICE)[None, :]
                < lens[:, None]).to(torch.int32)
        mask[0] = 0                                  # a fully-masked row
        return x, attn.mask_to_bias(mask)

    errs = {}
    for name, l in LENGTHS.items():
        for dn, dt in dtypes.items():
            for layout in ("blhd", "bhld"):
                (q, k, v, g), bias = inputs(l, dt, layout)
                seed = new_seed()
                plain = (attn.plain_attention_blhd if layout == "blhd"
                         else attn.plain_attention)
                leaves = [t.requires_grad_() for t in (q, k, v, bias)]
                out = attn.masked_attention(*leaves[:3], leaves[3],
                                            layout=layout, dropout_p=DROP_P,
                                            seed=seed)
                want = plain(q.detach(), k.detach(), v.detach(), bias.detach(),
                             DROP_P, seed)
                got_g = torch.autograd.grad(out, leaves, g)
                ref_in = [t.detach().float().requires_grad_() for t in leaves]
                want_g = torch.autograd.grad(plain(*ref_in, DROP_P, seed),
                                             ref_in, g.float())
                torch.cuda.synchronize()
                f_err = (out.float() - want.float()).abs().max().item()
                b_err = max((a.float() - b).abs().max().item()
                            for a, b in zip(got_g, want_g))
                finite = (bool(torch.isfinite(out.float()).all())
                          and all(bool(torch.isfinite(a).all())
                                  for a in got_g))
                ok = finite and f_err <= TOL[dn] and b_err <= GRAD_TOL[dn]
                log(f"  dropout vs plain {name:5s} B={TRAIN_B} L={l:<4d} "
                    f"{dn:9s} {layout}  fwd max|err|={f_err:.3e} "
                    f"(tol {TOL[dn]:g})  grads max|err|={b_err:.3e} "
                    f"(tol {GRAD_TOL[dn]:g})  {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(
                        f"dropout kernel disagrees: {name} {dn} {layout} "
                        f"fwd {f_err} grads {b_err} finite={finite}")
                errs[(name, dn, layout)] = (f_err, b_err)
                del q, k, v, g, bias, leaves, out, want, got_g, ref_in, want_g

    timings = {}
    for name, l in LENGTHS.items():
        for dn, dt in dtypes.items():
            (q, k, v, _), bias = inputs(l, dt, "blhd")
            seed = new_seed()
            drop_ms = cuda_ms(lambda: attn.masked_attention(
                q, k, v, bias, layout="blhd", dropout_p=DROP_P, seed=seed))
            p0_ms = cuda_ms(lambda: attn.masked_attention(q, k, v, bias,
                                                          layout="blhd"))
            plain_ms = cuda_ms(lambda: attn.plain_attention_blhd(
                q, k, v, bias, DROP_P, seed), iters=5)
            qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
            mask_lib = bias.to(dt)
            sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask_lib, dropout_p=DROP_P))
            # the recompute backward with and without the mask regeneration
            qkv = [t.requires_grad_() for t in (q, k, v)]
            g = torch.randn_like(q)
            out_d = attn.masked_attention(*qkv, bias, layout="blhd",
                                          dropout_p=DROP_P, seed=seed)
            out_0 = attn.masked_attention(*qkv, bias, layout="blhd")
            bwd_ms = cuda_ms(lambda: torch.autograd.grad(
                out_d, qkv, g, retain_graph=True), iters=5)
            bwd_p0_ms = cuda_ms(lambda: torch.autograd.grad(
                out_0, qkv, g, retain_graph=True), iters=5)
            bound, by = attention_bound_ms(TRAIN_B, l, l, dn, bias)
            timings[(name, dn)] = dict(
                ms=drop_ms, p0_ms=p0_ms, plain_ms=plain_ms, sdpa_ms=sdpa_ms,
                bound_ms=bound, bound_by=by, bwd_ms=bwd_ms,
                bwd_p0_ms=bwd_p0_ms,
                max_abs_err=max(errs[(name, dn, lay)][0]
                                for lay in ("blhd", "bhld")))
            log(f"  time dropout {name:5s} B={TRAIN_B} L={l} {dn:9s} blhd: "
                f"kernel p=0.1 {drop_ms:.4f} ms  p=0 {p0_ms:.4f} ms "
                f"(ratio {drop_ms / p0_ms:.3f})  plain {plain_ms:.4f} ms  "
                f"sdpa p=0.1 {sdpa_ms:.4f} ms  bound {bound:.4f} ms ({by})  "
                f"recompute bwd p=0.1 {bwd_ms:.4f} ms  p=0 {bwd_p0_ms:.4f} ms")
            del q, k, v, g, qkv, out_d, out_0, bias, qh, kh, vh, mask_lib
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return timings


def bench_inputs(torch, cfg, n_img, cpi, la, t, r, seed=0):
    """The bench geometry's inputs (bench.py:99-123), made on the card."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    n_cap = n_img * cpi
    caps = dict(
        input_ids_a=torch.randint(0, cfg.only_word_size, (n_cap, la),
                                  device=DEVICE, generator=gen),
        attention_mask_a=torch.ones(n_cap, la, dtype=torch.int32,
                                    device=DEVICE),
        token_type_ids_a=torch.zeros(n_cap, la, dtype=torch.int64,
                                     device=DEVICE))
    imgs = dict(
        input_ids_b=torch.randint(0, cfg.only_word_size, (n_img, t),
                                  device=DEVICE, generator=gen),
        attention_mask_b=torch.ones(n_img, t + r, dtype=torch.int32,
                                    device=DEVICE),
        token_type_ids_b=torch.ones(n_img, t, dtype=torch.int64,
                                    device=DEVICE),
        img_feats=torch.randn(n_img, r, cfg.img_feature_dim, device=DEVICE,
                              generator=gen))
    return caps, imgs


def base_config(ModelConfig, dtype, dropout=0.0, **kw):
    """MVPTR-base with the 86,051-row vocabulary (__graft_entry__.py:25-30);
    `dropout` sets both dropouts (the config's default is 0.1)."""
    return ModelConfig(vocab_size=86051, only_word_size=30522, dtype=dtype,
                       hidden_dropout_prob=dropout,
                       attention_probs_dropout_prob=dropout, **kw)


def phase3_two_stage(torch, attn, ModelConfig, RetrievalModel,
                     two_stage_scoring, dtype="bfloat16", reps=2):
    """`reps` full sweeps at the bench geometry in `dtype`, after a warm-up
    on a subset; each must launch the kernel exactly 492 times. Returns the
    last sweep's launches, the pairs/s of every sweep and the peak memory."""
    n_img, cpi, la, t, r = 1000, 5, 75, 20, 50
    k_i2t, k_t2i, eb, sb = 20, 10, 500, 1000
    cfg = base_config(ModelConfig, dtype)
    assert (cfg.hidden_size, cfg.half_layers, cfg.num_attention_heads,
            cfg.intermediate_size, cfg.img_feature_dim) == (768, 6, 12, 3072,
                                                             2054)
    t0 = time.perf_counter()
    model = RetrievalModel(cfg, device="cuda", seed=0)
    caps, imgs = bench_inputs(torch, cfg, n_img, cpi, la, t, r)
    torch.cuda.synchronize()
    log(f"  {dtype}: model + inputs ready in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params)")

    # warm-up at the same batch shapes on a subset (excluded from the count)
    sub = 500
    two_stage_scoring(model, {k: v[:sub * cpi] for k, v in caps.items()},
                      {k: v[:sub] for k, v in imgs.items()}, cpi, k_i2t,
                      k_t2i, eb, sb, max_tag_length=t)
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    pairs_per_s = []
    for rep in range(reps):
        attn.masked_attention.launches = 0
        res = two_stage_scoring(model, caps, imgs, cpi, k_i2t, k_t2i, eb, sb,
                                max_tag_length=t)
        torch.cuda.synchronize()
        launches = attn.masked_attention.launches
        n_enc_batches = math.ceil(n_img * cpi / eb) + math.ceil(n_img / eb)
        n_pair_batches = math.ceil(res["n_pairs"] / sb)
        want = cfg.half_layers * (n_enc_batches + n_pair_batches)
        sec = res["seconds"]
        sweep = sum(sec[s] for s in ("encode_text", "encode_image", "coarse",
                                     "rerank"))
        pairs_per_s.append(res["n_pairs"] / sweep)
        peak = torch.cuda.max_memory_allocated() / 1e9
        log(f"  two-stage {dtype} run {rep + 1}: pairs={res['n_pairs']} "
            f"launches={launches} (want {want})  "
            + "  ".join(f"{s}={v:.4f}s" for s, v in sec.items())
            + f"  sweep={sweep:.4f}s  pairs/s={pairs_per_s[-1]:.1f}"
            + f"  peak_mem={peak:.2f}GB")
        if launches != want or want != 492:
            raise AssertionError(f"masked_attention launched {launches} "
                                 f"times, want {want} (= 492)")
        scores = res["scores"]
        if (scores.shape != (n_img * k_i2t + n_img * cpi * k_t2i,)
                or not np.isfinite(scores).all()
                or scores.min() < 0 or scores.max() > 1):
            raise AssertionError("rerank scores malformed")
        if (res["i2t_cands"].shape != (n_img, k_i2t)
                or res["t2i_cands"].shape != (n_img * cpi, k_t2i)):
            raise AssertionError("candidate lists malformed")
        log(f"    coarse {json.dumps(res['coarse'])}")
        log(f"    fine   {json.dumps(res['fine'])}")
    del model, caps, imgs
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return dict(launches=launches, pairs_per_s=pairs_per_s, peak_gb=peak)


@contextlib.contextmanager
def plain_attention_path(layers_mod, attn):
    """Route the model's attention through the plain version (on the card)."""
    def plain(q, k, v, bias=None, *, layout="bhld", dropout_p=0.0, seed=None):
        fn = (attn.plain_attention_blhd if layout == "blhd"
              else attn.plain_attention)
        return fn(q, k, v, bias, dropout_p, seed)
    saved = layers_mod.masked_attention
    layers_mod.masked_attention = plain
    try:
        yield
    finally:
        layers_mod.masked_attention = saved


def phase4_end_to_end(torch, attn, layers_mod, ModelConfig, RetrievalModel):
    n_img, cpi, la, t, r = 6, 2, 75, 20, 50
    for dn in ("float32", "bfloat16"):
        cfg = base_config(ModelConfig, dn)
        model = RetrievalModel(cfg, device="cuda", seed=0)
        caps, imgs = bench_inputs(torch, cfg, n_img, cpi, la, t, r, seed=3)
        caps["attention_mask_a"][1::2, 60:] = 0      # padded captions
        imgs["attention_mask_b"][1::2, t + 40:] = 0  # padded regions
        ca = [caps[k] for k in ("input_ids_a", "attention_mask_a",
                                "token_type_ids_a")]
        ib = [imgs[k] for k in ("input_ids_b", "attention_mask_b",
                                "token_type_ids_b", "img_feats")]
        cap_idx = torch.arange(n_img * cpi, device="cuda")
        img_idx = cap_idx % n_img                    # true and false pairs

        def run():
            with torch.inference_mode():
                ts, tg = model.encode_text_full(*ca)
                vp, vm, ig = model.encode_image_full(*ib, max_tag_length=t)
                logits = model.score_cached(ts[cap_idx], ca[1][cap_idx],
                                            vp[img_idx], vm[img_idx])
                return torch.softmax(logits, -1)[:, 1], tg, ig

        before = attn.masked_attention.launches
        k_out = run()
        torch.cuda.synchronize()
        if attn.masked_attention.launches - before != 3 * cfg.half_layers:
            raise AssertionError("kernel path did not launch the kernel")
        with plain_attention_path(layers_mod, attn):
            p_out = run()
        torch.cuda.synchronize()
        if attn.masked_attention.launches - before != 3 * cfg.half_layers:
            raise AssertionError("plain path launched the kernel")
        for name, a, b in zip(("itm_prob", "txt_glob", "img_glob"), k_out,
                              p_out):
            err = (a.float() - b.float()).abs().max().item()
            ok = bool(torch.isfinite(a).all()) and err <= E2E_TOL[dn]
            log(f"  end to end {dn:9s} {name:9s} shape={tuple(a.shape)} "
                f"max|kernel-plain|={err:.3e} tol={E2E_TOL[dn]:g} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"end to end {dn} {name}: {err}")
        del model, caps, imgs, k_out, p_out
        torch.cuda.empty_cache()
    torch.cuda.synchronize()


def train_batch(torch, cfg, seed):
    """One padded batch of true pairs at the training geometry."""
    t = 20
    caps, imgs = bench_inputs(torch, cfg, TRAIN_B, 1, 75, t, 50, seed=seed)
    caps["attention_mask_a"][1::2, 60:] = 0          # padded captions
    imgs["attention_mask_b"][1::2, t + 40:] = 0      # padded regions
    return {**caps, **imgs}


@contextlib.contextmanager
def hard_pairs(model, pinned=None):
    """Record the hard pairs the model mines, or make it take `pinned`
    instead (an instance override of `mine_hard_negatives`). The real mining
    runs either way, so that it takes the same draws from the generator and
    the dropout masks after it stay the same."""
    record, real = [], model.bert.mine_hard_negatives

    def mine(*args, **kw):
        mined = real(*args, **kw)
        record.append(pinned if pinned is not None else mined)
        return record[-1]
    model.bert.mine_hard_negatives = mine
    try:
        yield record
    finally:
        del model.bert.mine_hard_negatives


def reset_counts(attn):
    attn.masked_attention.launches = 0
    attn.masked_attention.dropout_launches = 0
    attn.plain_attention.calls = 0


def check_counts(attn, want, what):
    """Every launch since `reset_counts` was the dropout instantiation, there
    were `want` of them, and the plain version never ran."""
    got = attn.masked_attention.launches
    drop = attn.masked_attention.dropout_launches
    plain = attn.plain_attention.calls
    if got != want or drop != want or plain != 0:
        raise AssertionError(f"{what} launched the kernel {got} times ({drop} "
                             f"with dropout) and the plain version {plain} "
                             f"times; want {want}, {want} and 0")


def timed_steps(torch, attn, trainer, batch, per_step):
    """TRAIN_TIMED Trainer steps, each of which must launch the dropout
    kernel `per_step` times and the plain version never. Returns the
    metrics, the launches and the seconds per step."""
    torch.cuda.reset_peak_memory_stats()
    history, launches = [], 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_TIMED):
        reset_counts(attn)
        history.append(trainer.step(batch))     # ends in a device sync
        check_counts(attn, per_step, "a training step")
        launches += attn.masked_attention.launches
    torch.cuda.synchronize()
    return history, launches, (time.perf_counter() - t0) / TRAIN_TIMED


def compare_step(torch, what, dn, k_out, p_out, loss_names, k_grads, p_grads):
    """One step's kernel path against its plain path: each loss within
    STEP_TOL's loss tolerance, each named gradient within its relative
    tolerance."""
    loss_tol, grad_tol = STEP_TOL[dn]
    for name in loss_names:
        a = getattr(k_out, name).item()
        b = getattr(p_out, name).item()
        ok = math.isfinite(a) and abs(a - b) <= loss_tol
        log(f"  {what} {dn:9s} {name:14s} kernel={a:.6f} plain={b:.6f} "
            f"|diff|={abs(a - b):.3e} tol={loss_tol:g} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{what} {dn} {name}: {a} vs {b}")
    for name in k_grads:
        a, b = k_grads[name].float(), p_grads[name].float()
        rel = ((a - b).norm() / b.norm()).item()
        ok = bool(torch.isfinite(a).all()) and rel <= grad_tol
        log(f"  {what} {dn:9s} grad {name}: |g|={b.norm().item():.4e} "
            f"rel err={rel:.3e} tol={grad_tol:g} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{what} {dn} grad {name}: {rel}")


def phase5_training(torch, attn, layers_mod, ModelConfig, RetrievalModel):
    from mvp_pytorch_tpu_torch.tasks.retrieval import (retrieval_loss_fn,
                                                       train_retrieval)
    from mvp_pytorch_tpu_torch.training.optim import make_optimizer
    from mvp_pytorch_tpu_torch.training.trainer import Trainer
    cfg = base_config(ModelConfig, "bfloat16", DROP_P)
    per_step = cfg.half_layers * 4       # txt + vis + 2 fusion passes
    model = RetrievalModel(cfg, device=DEVICE, seed=0)
    batch = train_batch(torch, cfg, seed=5)
    torch.cuda.synchronize()
    opt_kw = dict(schedule="constant", max_grad_norm=1.0)

    reset_counts(attn)
    warm = train_retrieval(model, [batch], TRAIN_WARMUP, learning_rate=4e-5,
                           max_tag_length=20, hn_mod="hard", logger=log,
                           log_period=1, **opt_kw)
    torch.cuda.synchronize()
    check_counts(attn, per_step * TRAIN_WARMUP, "train_retrieval")

    trainer = Trainer(model, retrieval_loss_fn(max_tag_length=20,
                                               hn_mod="hard"),
                      make_optimizer(model, 4e-5, **opt_kw), seed=1)
    history, launches, step_s = timed_steps(torch, attn, trainer, batch,
                                            per_step)
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in warm + history]
    log("  losses " + " ".join(f"{x:.4f}" for x in losses))
    log(f"  last step clip={history[-1]['clip']:.4f} "
        f"itm={history[-1]['itm']:.4f} "
        f"grad_norm={history[-1]['grad_norm']:.4f}")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"training losses not finite and falling: "
                             f"{losses}")
    log(f"  train step B={TRAIN_B} bf16, dropouts {DROP_P}: "
        f"{step_s * 1e3:.2f} ms/step  {TRAIN_B / step_s:.1f} samples/s  "
        f"launches/step={per_step} (all with dropout)  "
        f"peak_mem={peak / 1e9:.2f}GB")
    del trainer, model
    torch.cuda.empty_cache()

    # the same step on both paths: the same generator draws the same
    # dropout masks (hidden: bernoulli_; attention: the kernel's seed and the
    # plain version's hash of it)
    for dn in ("float32", "bfloat16"):
        model = RetrievalModel(base_config(ModelConfig, dn, DROP_P),
                               device=DEVICE, seed=0)
        model.train()
        batch = train_batch(torch, model.config, seed=6)

        def step():
            model.zero_grad(set_to_none=True)
            out = model.train_step(*(batch[k] for k in (
                "input_ids_a", "attention_mask_a", "token_type_ids_a",
                "input_ids_b", "attention_mask_b", "token_type_ids_b",
                "img_feats")), max_tag_length=20, hn_mod="hard",
                generator=torch.Generator(device=DEVICE).manual_seed(0))
            out.total_loss.backward()
            params = dict(model.named_parameters())
            return out, {n: params[n].grad.detach().clone()
                         for n in GRAD_PARAMS}

        before = attn.masked_attention.launches
        with hard_pairs(model) as mined:
            k_out, k_grads = step()
        if attn.masked_attention.launches - before != per_step:
            raise AssertionError("kernel path did not launch the kernel")
        with plain_attention_path(layers_mod, attn), hard_pairs(
                model, pinned=mined[0]):
            p_out, p_grads = step()
        torch.cuda.synchronize()
        if attn.masked_attention.launches - before != per_step:
            raise AssertionError("plain path launched the kernel")
        compare_step(torch, "train step", dn, k_out, p_out,
                     ("total_loss", "retrieval_loss", "itm_loss"), k_grads,
                     p_grads)
        del model, batch, k_out, p_out, k_grads, p_grads
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return dict(step_ms=step_s * 1e3, samples_per_s=TRAIN_B / step_s,
                peak_gb=peak / 1e9, launches_per_step=per_step,
                launches=launches, losses=losses)


QA_ANSWERS = 3129                    # VQA v2's answer set


def pretrain_batch(torch, cfg, seed, qa=False):
    """bench.py's pretraining batch (bench.py:416-440) made on the card:
    `train_batch`'s padded captions and images, 8 labelled text positions
    and 3 labelled tag positions, phrase span [9, 14) and image span
    [75, 125); with `qa`, answers and QA-pair labels with -1 rows."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 1000)
    batch = train_batch(torch, cfg, seed)
    b, la = batch["input_ids_a"].shape
    tr = batch["attention_mask_b"].shape[1]                # tags + regions

    def labels(width, pos):
        lab = torch.full((b, width), -1, dtype=torch.int64, device=DEVICE)
        lab[:, pos] = torch.randint(0, cfg.only_word_size,
                                    (b, pos.stop - pos.start), device=DEVICE,
                                    generator=gen)
        return lab
    batch.update(
        lm_label_ids_a=labels(la, slice(1, 9)),
        lm_label_ids_b=labels(tr, slice(1, 4)),
        phrase_index=torch.tensor([[9, 14]], device=DEVICE).repeat(b, 1),
        # the fused sequence is [text (LA) ; regions (R)]
        image_index=torch.tensor([[la, la + batch["img_feats"].shape[1]]],
                                 device=DEVICE).repeat(b, 1))
    if qa:
        batch["qa_ans"] = torch.randint(0, QA_ANSWERS, (b,), device=DEVICE,
                                        generator=gen)
        batch["qa_ans"][::7] = -1
        batch["qa_is_next"] = torch.randint(0, 2, (b,), device=DEVICE,
                                            generator=gen)
        batch["qa_is_next"][::5] = -1
    return batch


def phase6_pretraining(torch, attn, layers_mod, ModelConfig):
    """`BiPretrainModel` trained at MVPTR-base in bf16 at the config's
    dropouts, then one step at dropouts 0 on both paths."""
    from mvp_pytorch_tpu_torch.models import BiPretrainModel
    from mvp_pytorch_tpu_torch.tasks.pretrain import (PRETRAIN_KEYS,
                                                      pretrain_loss_fn,
                                                      train_pretrain)
    from mvp_pytorch_tpu_torch.training.optim import make_optimizer
    from mvp_pytorch_tpu_torch.training.trainer import Trainer
    t_phase = time.perf_counter()
    if ModelConfig().attention_probs_dropout_prob != DROP_P or \
            ModelConfig().hidden_dropout_prob != DROP_P:
        raise AssertionError("the config's default dropouts are not 0.1")
    cfg = base_config(ModelConfig, "bfloat16", DROP_P)
    per_step = cfg.half_layers * 4       # txt + vis + 2 fusion passes
    model = BiPretrainModel(cfg, device=DEVICE, seed=0)
    batch = pretrain_batch(torch, cfg, seed=7)
    torch.cuda.synchronize()
    log(f"  model + batch ready in {time.perf_counter() - t_phase:.1f} s "
        f"({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params)")
    step_kw = dict(max_tag_length=20, hn_mod="hard", phrase_mod="sample",
                   max_pred_a=20, max_pred_b=10)
    opt_kw = dict(schedule="constant", max_grad_norm=1.0)

    reset_counts(attn)
    warm = train_pretrain(model, [batch], TRAIN_WARMUP, learning_rate=1e-4,
                          logger=log, log_period=1, **opt_kw, **step_kw)
    torch.cuda.synchronize()
    check_counts(attn, per_step * TRAIN_WARMUP, "train_pretrain")

    trainer = Trainer(model, pretrain_loss_fn(**step_kw),
                      make_optimizer(model, 1e-4, **opt_kw), seed=1)
    history, launches, step_s = timed_steps(torch, attn, trainer, batch,
                                            per_step)
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in warm + history]
    log("  losses " + " ".join(f"{x:.4f}" for x in losses))
    log("  last step " + " ".join(f"{k}={v:.4f}"
                                  for k, v in history[-1].items()))
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"pretraining losses not finite and falling: "
                             f"{losses}")
    log(f"  pretrain step B={TRAIN_B} bf16, dropouts {DROP_P}: "
        f"{step_s * 1e3:.2f} ms/step  {TRAIN_B / step_s:.1f} samples/s  "
        f"launches/step={per_step} (all with dropout, plain version 0)  "
        f"peak_mem={peak / 1e9:.2f}GB")
    del trainer, model, batch
    torch.cuda.empty_cache()

    # one step at dropouts 0 with every loss (QA heads on), kernel path
    # against plain path, the draws and the hard pairs pinned
    for dn in ("float32", "bfloat16"):
        cfg0 = base_config(ModelConfig, dn, qa_answer_size=QA_ANSWERS)
        model = BiPretrainModel(cfg0, qa_pairs=True, device=DEVICE, seed=0)
        model.train()
        batch = pretrain_batch(torch, cfg0, seed=8, qa=True)
        dice = torch.randperm(TRAIN_B, device=DEVICE, generator=torch.Generator(
            device=DEVICE).manual_seed(9))

        def step():
            model.zero_grad(set_to_none=True)
            out = model.train_step(
                *(batch[k] for k in PRETRAIN_KEYS), hn_dice=dice, wra_pick=1,
                wra_neg_offset=1,
                generator=torch.Generator(device=DEVICE).manual_seed(0),
                **step_kw)
            out.total_loss.backward()
            params = dict(model.named_parameters())
            return out, {n: params[n].grad.detach().clone()
                         for n in PRETRAIN_GRAD_PARAMS}

        reset_counts(attn)
        with hard_pairs(model) as mined:
            k_out, k_grads = step()
        torch.cuda.synchronize()
        if (attn.masked_attention.launches != per_step
                or attn.masked_attention.dropout_launches != 0):
            raise AssertionError("kernel path did not launch the p = 0 kernel")
        with plain_attention_path(layers_mod, attn), hard_pairs(
                model, pinned=mined[0]):
            p_out, p_grads = step()
        torch.cuda.synchronize()
        if attn.masked_attention.launches != per_step:
            raise AssertionError("plain path launched the kernel")
        compare_step(torch, "pretrain step", dn, k_out, p_out,
                     PRETRAIN_LOSSES, k_grads, p_grads)
        del model, batch, k_out, p_out, k_grads, p_grads
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t_phase
    log(f"  phase 6 took {seconds:.1f} s")
    return dict(step_ms=step_s * 1e3, samples_per_s=TRAIN_B / step_s,
                peak_gb=peak / 1e9, launches_per_step=per_step,
                launches=launches, losses=losses, seconds=seconds)


# phase 7: the retrieval command line on a generated root at the real widths
# (bench.py:99-105's Flickr30k test geometry)
CLI_IMAGES, CLI_CAPS, CLI_REGIONS, CLI_TAGS = 1000, 5, 50, 50
CLI_VOCAB, CLI_WORDS_PER_CAP, CLI_PHRASES = 30522, 90, 1000
CLI_MEM_STEPS, CLI_STEPS, CLI_TIMED_FROM = 13, 26, 6   # CLI steps 6-26 timed
CLI_MEM_TIMED_FROM = 4
CLI_ARGS = ["--max_seq_length", "70", "--max_phrases", "5",   # LA 75
            "--max_tag_length", "20", "--max_img_seq_length", "50",
            "--dtype", "bfloat16", "--seed", "11"]
CLI_PLATFORM = []                    # a CPU rehearsal sets ["--platform", "cpu"]
CLI_EVAL_ARGS = ["--eval_batch_size", "500", "--rerank_batch_size", "1000",
                 "--num_captions_per_img_val", "20",
                 "--num_images_per_cap_val", "10"]
SCORE_TOL = 1e-6


def write_cli_root(root, seed=0):
    """A retrieval root at the real widths, written with the port's own
    `tsv_writer`: a 30,522-word vocab, CLI_IMAGES images of CLI_REGIONS
    regions x 2,054 fp32 features and CLI_TAGS tags each (predictions.tsv +
    imageid2idx.json), CLI_CAPS captions an image of CLI_WORDS_PER_CAP words
    (more than LA 75 holds) with phrases from id2phrase.json
    (captions.json). An image's first five tags also open each of its
    captions. Returns the paths and the bytes written."""
    import base64
    from mvp_pytorch_tpu_torch.data.tsv import tsv_writer
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    specials = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    words = [f"w{i}" for i in range(CLI_VOCAB - len(specials))]
    paths = {"vocab": os.path.join(root, "vocab.txt"),
             "features": os.path.join(root, "features", "predictions.tsv"),
             "captions": os.path.join(root, "captions.json"),
             "id2phrase": os.path.join(root, "id2phrase.json")}
    with open(paths["vocab"], "w") as f:
        f.write("\n".join(specials + words) + "\n")
    phrases = [[words[int(a)], words[int(b)]]
               for a, b in rng.integers(0, len(words), (CLI_PHRASES, 2))]
    with open(paths["id2phrase"], "w") as f:
        json.dump({str(CLI_VOCAB + i): p for i, p in enumerate(phrases)}, f)
    keys = [f"img_{i:05d}" for i in range(CLI_IMAGES)]
    tag_words = words[:2000]
    tags = {k: [tag_words[int(t)] for t in rng.integers(0, 2000, CLI_TAGS)]
            for k in keys}
    nbytes = [0]

    def rows():
        for k in keys:
            feats = rng.standard_normal((CLI_REGIONS, 2054), np.float32)
            nbytes[0] += feats.nbytes
            yield [k, json.dumps({
                "feature": base64.b64encode(feats.tobytes()).decode(),
                "predictions": tags[k]})]
    tsv_writer(rows(), paths["features"])
    with open(os.path.join(root, "features", "imageid2idx.json"), "w") as f:
        json.dump({k: i for i, k in enumerate(keys)}, f)
    caps = {}
    for k in keys:
        caps[k] = []
        for _ in range(CLI_CAPS):
            filler = rng.integers(0, len(words), CLI_WORDS_PER_CAP - 5)
            caps[k].append({
                "text": " ".join(tags[k][:5] + [words[int(w)] for w in filler]),
                "phrases": [phrases[int(j)]
                            for j in rng.integers(0, CLI_PHRASES, 8)]})
    with open(paths["captions"], "w") as f:
        json.dump(caps, f)
    return paths, nbytes[0], os.path.getsize(paths["features"])


@contextlib.contextmanager
def counted_steps(attn, per_step, what):
    """Every `Trainer.step` inside must launch the dropout kernel exactly
    `per_step` times and the plain attention never; yields the running
    launch total."""
    from mvp_pytorch_tpu_torch.training.trainer import Trainer
    real, total = Trainer.step, [0]

    def step(self, batch):
        reset_counts(attn)
        out = real(self, batch)
        check_counts(attn, per_step, what)
        total[0] += attn.masked_attention.launches
        return out
    Trainer.step = step
    try:
        yield total
    finally:
        Trainer.step = real


def mean(xs):
    return sum(xs) / len(xs)


def phase7_cli(torch, attn, sweep_pairs_per_s=None):
    """The retrieval command line (`tasks.retrieval.main`) at MVPTR-base on a
    generated root: in-memory baseline, CLI training through the process
    loader, CLI eval against `two_stage_scoring` in memory."""
    import gc
    import shutil
    from mvp_pytorch_tpu_torch import native
    from mvp_pytorch_tpu_torch.data.datasets import (FeatureStore,
                                                     RetrievalDataset,
                                                     load_phrase_vocab)
    from mvp_pytorch_tpu_torch.data.loader import BatchSampler
    from mvp_pytorch_tpu_torch.data.tokenization import FastBertTokenizer
    from mvp_pytorch_tpu_torch.models import ModelConfig, RetrievalModel
    from mvp_pytorch_tpu_torch.tasks import retrieval as ret
    from mvp_pytorch_tpu_torch.tasks.common import build_config, tensorize_cfg
    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_smoke",
                        "phase7")
    shutil.rmtree(root, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        paths, feat_bytes, tsv_bytes = write_cli_root(root)
        log(f"  root: {CLI_IMAGES} images x {CLI_CAPS} captions, "
            f"{CLI_REGIONS} regions x 2054 fp32 ({feat_bytes / 1e6:.1f} MB of "
            f"features, {tsv_bytes / 1e6:.1f} MB of TSV) written in "
            f"{time.perf_counter() - t0:.1f} s")
        data = ["--captions_json", paths["captions"],
                "--feature_tsv", paths["features"],
                "--id2phrase", paths["id2phrase"]]
        args = ret.get_args(["--output_dir", root] + data + CLI_ARGS
                            + CLI_PLATFORM)
        tokenizer = FastBertTokenizer(paths["vocab"])
        log(f"  native tokenizer and feature decode: {native.available()} "
            f"(tokenizer native_active={tokenizer.native_active})")

        dataset = RetrievalDataset(
            paths["captions"], FeatureStore(paths["features"]), tokenizer,
            sg2id=load_phrase_vocab(paths["id2phrase"]),
            cfg=tensorize_cfg(args))
        fetch = ret.RetrievalFetch(dataset, use_phrase=False)
        sampler = BatchSampler(len(dataset), TRAIN_B, seed=args.seed)

        # 2. in-memory baseline: the same batches, fetched first
        t0 = time.perf_counter()
        batches = [fetch(sampler.batch_at(s)) for s in range(CLI_MEM_STEPS)]
        fetch_ms = (time.perf_counter() - t0) * 1e3 / CLI_MEM_STEPS
        shapes = {k: v.shape for k, v in batches[0].items()}
        log(f"  a batch fetched on the main thread: {fetch_ms:.1f} ms; "
            f"shapes {shapes}")
        if (shapes["input_ids_a"] != (TRAIN_B, 75)
                or shapes["attention_mask_b"] != (TRAIN_B, 70)
                or shapes["img_feats"] != (TRAIN_B, CLI_REGIONS, 2054)):
            raise AssertionError(f"batch shapes {shapes}")
        cfg = build_config(args, tokenizer, num_labels=2)
        per_step = cfg.half_layers * 4
        model = RetrievalModel(cfg, device=DEVICE, seed=args.seed)
        with counted_steps(attn, per_step, "an in-memory step") as total:
            torch.cuda.reset_peak_memory_stats()
            mem = ret.train_retrieval(
                model, batches, CLI_MEM_STEPS, learning_rate=args.learning_rate,
                weight_decay=args.weight_decay, seed=args.seed,
                max_tag_length=args.max_tag_length, hn_mod="hard")
        mem_peak = torch.cuda.max_memory_allocated() / 1e9
        mem_first = mem[0]["loss"]
        mem_ms = mean([m["step_ms"] for m in mem[CLI_MEM_TIMED_FROM - 1:]])
        mem_sps = TRAIN_B / mem_ms * 1e3
        log(f"  in memory: {CLI_MEM_STEPS} steps, {total[0]} launches; steps "
            f"{CLI_MEM_TIMED_FROM}-{CLI_MEM_STEPS}: {mem_ms:.2f} ms/step "
            f"{mem_sps:.1f} samples/s, peak {mem_peak:.2f} GB; losses "
            + " ".join(f"{m['loss']:.4f}" for m in mem))
        del model, batches, mem
        gc.collect()
        torch.cuda.empty_cache()

        # 3. training through the CLI and the process loader
        out = os.path.join(root, "cli_train")
        argv = (["--output_dir", out, "--do_train", "--max_steps",
                 str(CLI_STEPS), "--train_batch_size", str(TRAIN_B),
                 "--log_period", "1", "--ckpt_period", str(CLI_STEPS),
                 "--num_workers", "4", "--worker_start_method", "fork",
                 "--data_dir", root] + data + CLI_ARGS + CLI_PLATFORM)
        log("  python -m mvp_pytorch_tpu_torch.tasks.retrieval "
            + " ".join(os.path.relpath(a, root) if a.startswith(root) else a
                       for a in argv))
        with counted_steps(attn, per_step, "a CLI training step") as total:
            torch.cuda.reset_peak_memory_stats()
            hist = ret.main(argv)["train"]
        cli_peak = torch.cuda.max_memory_allocated() / 1e9
        cli_launches = total[0]
        losses = [m["loss"] for m in hist]
        timed = hist[CLI_TIMED_FROM - 1:]
        cli_ms = mean([m["step_ms"] for m in timed])
        cli_sps = TRAIN_B / cli_ms * 1e3
        data_ms = mean([m["data_ms"] for m in timed])
        worker_ms = mean([m["worker_ms"] for m in timed])
        h2d_ms = mean([m.get("h2d_ms", float("nan")) for m in timed])
        # from seeded weights every caption and image starts with the same
        # [CLS], whose symmetry 26 steps do not break on real-format data:
        # the losses fall from their start to chance, ln B + ln 2, and stay
        # there (phase 5's batch, random ids at every position, learns)
        chance = math.log(TRAIN_B) + math.log(2)
        log("  CLI losses " + " ".join(f"{x:.4f}" for x in losses)
            + f" (chance {chance:.4f})")
        if (len(hist) != CLI_STEPS or not all(map(math.isfinite, losses))
                or mean(losses[-5:]) >= losses[0]):
            raise AssertionError(f"CLI training losses not finite and "
                                 f"falling: {losses}")
        # step 1 is the in-memory run's step 1 (same weights, batch, dropout
        # draws and learning rate): the loader delivered that batch intact
        log(f"  step 1 loss: CLI {losses[0]:.6f}, in memory {mem_first:.6f}")
        if abs(losses[0] - mem_first) > STEP_TOL["bfloat16"][0]:
            raise AssertionError("the CLI's first batch is not the sampler's")
        ratio = cli_sps / mem_sps
        log(f"  CLI: {CLI_STEPS} steps, {cli_launches} launches (24 a step, "
            f"all with dropout, plain 0); steps {CLI_TIMED_FROM}-{CLI_STEPS}: "
            f"{cli_ms:.2f} ms/step {cli_sps:.1f} samples/s, peak "
            f"{cli_peak:.2f} GB; main thread data {data_ms:.3f} ms/step, "
            f"worker {worker_ms:.1f} ms/batch, H2D {h2d_ms:.3f} ms/batch")
        log(f"  CLI samples/s / in-memory samples/s = {cli_sps:.1f} / "
            f"{mem_sps:.1f} = {ratio:.3f} (target 0.90)")
        gc.collect()
        torch.cuda.empty_cache()

        # 4. eval through the CLI from the trained checkpoint
        ckpt = os.path.join(out, f"checkpoint-{CLI_STEPS:07d}")
        shutil.copy(paths["vocab"], ckpt)
        argv = (["--output_dir", os.path.join(root, "cli_eval"),
                 "--model_name_or_path", ckpt, "--do_eval", "--dtype",
                 "bfloat16"] + data + CLI_EVAL_ARGS + CLI_PLATFORM)
        reset_counts(attn)
        res = ret.main(argv)["eval"]
        torch.cuda.synchronize()
        got = (attn.masked_attention.launches,
               attn.masked_attention.dropout_launches,
               attn.plain_attention.calls)
        sec = res["seconds"]
        sweep = sum(sec[s] for s in ("encode_text", "encode_image", "coarse",
                                     "rerank"))
        pairs_per_s = res["n_pairs"] / sweep
        log(f"  CLI eval: {got[0]} launches ({got[1]} with dropout, plain "
            f"{got[2]}), pairs={res['n_pairs']}  "
            + "  ".join(f"{k}={v:.4f}s" for k, v in sec.items())
            + f"  pairs/s={pairs_per_s:.1f}"
            + (f" (phase 3 bf16 sweep: {sweep_pairs_per_s:.1f})"
               if sweep_pairs_per_s else ""))
        log(f"    coarse {json.dumps(res['coarse'])}")
        log(f"    fine   {json.dumps(res['fine'])}")
        ek = dict(zip(CLI_EVAL_ARGS[::2], map(int, CLI_EVAL_ARGS[1::2])))
        n_cap = CLI_IMAGES * CLI_CAPS
        want = cfg.half_layers * (
            math.ceil(n_cap / ek["--eval_batch_size"])
            + math.ceil(CLI_IMAGES / ek["--eval_batch_size"])
            + math.ceil(res["n_pairs"] / ek["--rerank_batch_size"]))
        if got != (want, 0, 0) or (DEVICE == "cuda" and want != 492):
            raise AssertionError(f"CLI eval launched {got}, want "
                                 f"({want} = 492, 0, 0)")
        model = RetrievalModel(ModelConfig.from_pretrained(ckpt,
                                                           dtype="bfloat16"),
                               device=DEVICE)
        model.load_state_dict(torch.load(
            os.path.join(ckpt, "pytorch_model.bin"), map_location=DEVICE,
            weights_only=True))
        ref = ret.two_stage_scoring(
            model, ret.port_names(dataset.caption_arrays()),
            ret.port_names(dataset.image_arrays()), CLI_CAPS,
            ek["--num_captions_per_img_val"], ek["--num_images_per_cap_val"],
            ek["--eval_batch_size"], ek["--rerank_batch_size"],
            max_tag_length=args.max_tag_length)
        score_err = float(np.abs(ref["scores"] - res["scores"]).max())
        same = (ref["coarse"] == res["coarse"] and ref["fine"] == res["fine"]
                and np.array_equal(ref["i2t_cands"], res["i2t_cands"])
                and np.array_equal(ref["t2i_cands"], res["t2i_cands"]))
        log(f"  CLI eval against two_stage_scoring in memory: ranks and "
            f"candidates {'equal' if same else 'DIFFER'}, max|score diff| "
            f"{score_err:.3e} (tol {SCORE_TOL:g})")
        if not same or score_err > SCORE_TOL:
            raise AssertionError("CLI eval differs from two_stage_scoring")
        del model
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    log(f"  phase 7 took {seconds:.1f} s")
    return dict(native=native.available(), launches=cli_launches,
                launches_per_step=per_step, eval_launches=got[0],
                samples_per_s=cli_sps, step_ms=cli_ms, peak_gb=cli_peak,
                in_memory_samples_per_s=mem_sps, in_memory_step_ms=mem_ms,
                ratio=ratio, main_data_ms=data_ms, worker_ms=worker_ms,
                h2d_ms=h2d_ms, main_fetch_ms=fetch_ms,
                eval_pairs_per_s=pairs_per_s, eval_score_err=score_err,
                losses=losses, seconds=seconds)


def main(argv) -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--sweep", choices=("bfloat16", "float32"),
                        help="run phase 3 alone, in this dtype")
    parser.add_argument("--cli", action="store_true",
                        help="run phase 7 (the retrieval command line) alone")
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA card", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from mvp_pytorch_tpu_torch.models import ModelConfig, RetrievalModel
    from mvp_pytorch_tpu_torch.models import layers as layers_mod
    from mvp_pytorch_tpu_torch.ops import _kernels
    from mvp_pytorch_tpu_torch.ops import attention as attn
    from mvp_pytorch_tpu_torch.tasks.retrieval import two_stage_scoring

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()

    log("phase 1: card and build")
    card = card_line()
    log(card)
    log(f"  torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    lib_path = _kernels.build()
    _kernels.library()
    log(f"  built {os.path.relpath(lib_path, root)} in "
        f"{time.perf_counter() - t0:.1f} s")
    if args.sweep:
        log(f"phase 3 alone: two-stage retrieval scoring, {args.sweep}, "
            f"package at {root}")
        sweep = phase3_two_stage(torch, attn, ModelConfig, RetrievalModel,
                                 two_stage_scoring, args.sweep,
                                 reps=2 if args.sweep == "bfloat16" else 1)
        print(json.dumps({"sweep": args.sweep, "card": card, **sweep}),
              flush=True)
        return 0
    if args.cli:
        log("phase 7 alone: the retrieval command line, MVPTR-base, B 96")
        cli = phase7_cli(torch, attn)
        print(json.dumps({"cli": cli, "card": card}), flush=True)
        return 0
    phase1_kernel_report(torch, attn, _kernels, lib_path)
    torch.cuda.synchronize()

    log("phase 2: kernel against plain version")
    errors, timings = phase2_kernel_vs_plain(torch, attn)
    torch.cuda.synchronize()
    log("phase 2: attention backward against plain autograd, training shapes")
    bwd_timings = phase2_backward(torch, attn)
    torch.cuda.synchronize()
    log("phase 2: attention-prob dropout inside the kernel")
    drop_timings = phase2_dropout(torch, attn)
    torch.cuda.synchronize()

    log("phase 3: two-stage retrieval scoring, MVPTR-base, bench geometry")
    sweep = phase3_two_stage(torch, attn, ModelConfig, RetrievalModel,
                             two_stage_scoring, "bfloat16", reps=2)
    sweep32 = phase3_two_stage(torch, attn, ModelConfig, RetrievalModel,
                               two_stage_scoring, "float32", reps=1)
    torch.cuda.synchronize()

    log("phase 4: kernel path against plain path, end to end")
    phase4_end_to_end(torch, attn, layers_mod, ModelConfig, RetrievalModel)
    torch.cuda.synchronize()

    log("phase 5: retrieval training step, MVPTR-base, batch 96")
    train = phase5_training(torch, attn, layers_mod, ModelConfig,
                            RetrievalModel)
    torch.cuda.synchronize()

    log("phase 6: pretraining step, MVPTR-base, batch 96, dropouts 0.1")
    pre = phase6_pretraining(torch, attn, layers_mod, ModelConfig)
    torch.cuda.synchronize()

    log("phase 7: the retrieval command line, MVPTR-base, B 96, generated "
        "root")
    cli = phase7_cli(torch, attn, sweep["pairs_per_s"][-1])
    torch.cuda.synchronize()

    main_t = timings[("fused", "bfloat16")]
    main_err = errors[("fused 2-D padded keys", 1000, "bfloat16", "blhd")]
    train_t = bwd_timings[("fused", "bfloat16")]
    t32 = timings[("fused", "float32")]
    train32 = bwd_timings[("fused", "float32")]
    drop_t = drop_timings[("fused", "bfloat16")]
    drop32 = drop_timings[("fused", "float32")]
    kernels = {"kernels": [{
        "name": "masked_attention_fwd", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": REPLACES,
        "launches": sweep["launches"], "max_abs_err": main_err,
        "ms": main_t["ms"], "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"], "bound_by": main_t["bound_by"],
        "library_ms": main_t["library_ms"],
        "training": {
            "launches": train["launches"],
            "launches_per_step": train["launches_per_step"],
            "shape": f"B {TRAIN_B} L 125 bf16 blhd",
            "fwd_ms": train_t["fwd_ms"],
            "fwd_bound_ms": train_t["fwd_bound_ms"],
            "bwd_ms": train_t["bwd_ms"],
            "bwd_plain_ms": train_t["plain_bwd_ms"],
            "bwd_bound_ms": train_t["bwd_bound_ms"],
            "bwd_bound_by": train_t["bwd_bound_by"],
            "bwd_max_abs_err": train_t["grad_err"],
            "sdpa_fwd_ms": train_t["sdpa_fwd_ms"],
            "sdpa_fwd_bwd_ms": train_t["sdpa_fwd_bwd_ms"],
            "step_ms": train["step_ms"],
            "samples_per_s": train["samples_per_s"],
            "peak_gb": train["peak_gb"]},
        "pretraining": {
            "launches": pre["launches"],
            "launches_per_step": pre["launches_per_step"],
            "dropout_launches_per_step": pre["launches_per_step"],
            "step_ms": pre["step_ms"],
            "samples_per_s": pre["samples_per_s"],
            "peak_gb": pre["peak_gb"],
            "dropout_shape": f"B {TRAIN_B} L 125 bf16 blhd p {DROP_P}",
            "dropout_ms": drop_t["ms"], "p0_ms": drop_t["p0_ms"],
            "dropout_plain_ms": drop_t["plain_ms"],
            "dropout_max_abs_err": drop_t["max_abs_err"],
            "dropout_bound_ms": drop_t["bound_ms"],
            "dropout_bound_by": drop_t["bound_by"],
            "sdpa_dropout_ms": drop_t["sdpa_ms"],
            "dropout_bwd_ms": drop_t["bwd_ms"],
            "p0_bwd_ms": drop_t["bwd_p0_ms"],
            "seconds": pre["seconds"]},
        "cli": {k: v for k, v in cli.items() if k != "losses"}}, {
        # the fp32 kernels (3xTF32) behind the same entry point; launches
        # and pairs/s from the fp32 sweep of phase 3
        "name": "masked_attention_fwd fp32 (3xTF32)", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": REPLACES,
        "launches": sweep32["launches"],
        "max_abs_err": errors[("fused 2-D padded keys", 1000, "float32",
                               "blhd")],
        "ms": t32["ms"], "plain_ms": t32["plain_ms"],
        "bound_ms": t32["bound_ms"], "bound_by": t32["bound_by"],
        "library_ms": t32["library_ms"],
        "sweep_pairs_per_s": sweep32["pairs_per_s"][0],
        "sweep_peak_gb": sweep32["peak_gb"],
        "training": {
            "shape": f"B {TRAIN_B} L 125 fp32 blhd",
            "fwd_ms": train32["fwd_ms"],
            "fwd_bound_ms": train32["fwd_bound_ms"],
            "fwd_bound_by": train32["fwd_bound_by"],
            "sdpa_fwd_ms": train32["sdpa_fwd_ms"]},
        "dropout": {
            "shape": f"B {TRAIN_B} L 125 fp32 blhd p {DROP_P}",
            "ms": drop32["ms"], "p0_ms": drop32["p0_ms"],
            "plain_ms": drop32["plain_ms"],
            "max_abs_err": drop32["max_abs_err"],
            "bound_ms": drop32["bound_ms"], "bound_by": drop32["bound_by"],
            "sdpa_ms": drop32["sdpa_ms"]}}]}
    log(f"  total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
