#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mvp_pytorch_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --sweep float32   # phase 3 alone, in one dtype
    python3 chip_smoke.py --cli             # phase 7 alone
    python3 chip_smoke.py --pretrain_cli    # phase 8 alone
    python3 chip_smoke.py --finetune_cli    # phase 9 alone

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
8. the pretraining command line (`tasks.pretrain.main`) at MVPTR-base on
   phase 7's root plus a corpus of 5 rows an image (5,000 rows of 90-word
   captions with 8 phrases; every other row a QA pair whose answer is one
   of the image's tags) and a tag2id.json: LA 75, T 20, R 50, bf16, the
   config's dropouts 0.1 / 0.1, lr 1e-4, hard negatives, WRA 'sample',
   mask_prob 0.15. The first batch's masked shares of text tokens and of
   regions within 0.15 +- 0.02, the region labels on exactly the zeroed
   regions; the process loader's batch at the first step of epoch 1 equal
   to the fetch with epoch 1 and unlike epoch 0's masks of the same rows.
   13 masked batches fetched into memory and trained with `train_pretrain`;
   one dropout-0 step on the first of them, kernel path against plain path:
   in fp32 the six losses and five named gradients (phase 5's fp32
   tolerances), in bf16 the losses (0.02) with the gradients printed beside
   each path's distance from the fp32 gradient; 26 steps through
   the CLI and its process loader (4 forked workers), each launching the
   dropout kernel exactly 24 times and the plain attention never, finite
   losses, the last five below the first, step 1's loss equal to the
   in-memory run's; samples/s over steps 6-26 beside the in-memory steps
   4-13 (target ratio 0.90, not a failure), main-thread data ms, worker ms
   and H2D ms; then 3 CLI steps with `--use_qa --qa_answer_size 3129
   --use_qa_pairs`, finite QA losses. The root is deleted at the end;
9. VQA, SNLI-VE and referring-expression fine-tuning through their command
   lines (`tasks.vqa`, `tasks.ve`, `tasks.re_task`) at MVPTR-base, bf16 over
   fp32 weights, the config's dropouts 0.1 / 0.1, LA 40 (35 + 5 phrase
   slots), T 20, R 50, on a root written under `_smoke/` like phase 7's
   (1,000 images, region boxes in the last 6 feature dims) with 2,000 VQA
   questions over 3,129 answers (up to 10 soft scores each), 3,000 SNLI-VE
   hypotheses, 1,000 expressions whose gt box is a region's and up to 20
   detections an image, each following `data/synthetic.py`'s learnable rule.
   First the kernel at the fine-tuning shapes (fused L 90 and text L 40 at
   B 64 and 32, bf16, p 0.1 and 0): against the plain version (0.05) and
   timed beside the plain version and SDPA. (a) VQA (QA head, bce, B 32, lr
   5e-5): on the first real batch at dropout 0, kernel path against plain
   path (logits and loss fp32 1e-4; bf16 logits 4 bf16 ulps at the largest
   |logit|, bf16 loss 1e-4 of the loss, each path's distance from fp32
   printed; the relative error of five named gradients fp32 1e-3, bf16
   printed beside each path's distance from fp32); 13 steps in memory, then 26 through the CLI and its process loader
   (4 forked workers), each launching the dropout kernel exactly 18 times (6
   layers x text, vision, one fusion pass) and the plain attention never,
   finite losses, step 1's loss equal to the in-memory run's; the CLI's
   eval and `--test_jsonl` of the checkpoint over 1,000 questions: 18 p = 0
   launches a batch, logits within 1e-6 of the model's forward on the
   dataset's arrays in memory, the same VQA accuracy, one answer a question
   from label2ans; 3 CLI steps with `--loss_type kl --adjust_loss_step 2
   --adjust_dp_step 2`: kl before step 2 and bce from it, the hidden
   dropouts 0.1 then 0.3 while the kernel's p stays 0.1. (b) SNLI-VE
   (B 64, lr 4e-5, `--mask_training --freeze_steps 5`): 13 CLI steps of 18
   launches, every `bert.*` parameter bitwise unchanged through step 5 and
   changed after it, the classifier moving from step 1, the CLI's eval
   accuracy over 1,000 pairs equal to the forward in memory; 3 steps with
   `--use_single`. (c) RE (`REModel` mod 1, `--phrase_layer 2`, B 32,
   `--det_json`): 13 CLI steps of 18 launches, `re_accuracy` and the two
   detection-grounded accuracies equal to those of the forward in memory; 3
   steps at `--loss_mod 3`. Step ms, samples/s, peak memory, main-thread
   data ms, worker ms and the VQA feed ratio (target 0.90, not a failure)
   are reported. The root is deleted at the end;
10. one JSON line of kernel numbers (the bf16 kernel, then the fp32 one),
   then the result line.

With `--sweep DTYPE` only phase 3 runs, in that dtype (bf16: two sweeps,
fp32: one), and the last line is a JSON object of its numbers; run from a
copy of another tree, the script drives that tree's package. With `--cli`
only phases 1 (the build) and 7 run, the last line a JSON object of phase
7's numbers; with `--pretrain_cli`, phases 1 and 8; with `--finetune_cli`,
phases 1 and 9.

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


def write_cli_root(root, seed=0, corpus=False, finetune=False):
    """A retrieval root at the real widths, written with the port's own
    `tsv_writer`: a 30,522-word vocab, CLI_IMAGES images of CLI_REGIONS
    regions x 2,054 fp32 features and CLI_TAGS tags each (predictions.tsv +
    imageid2idx.json), CLI_CAPS captions an image of CLI_WORDS_PER_CAP words
    (more than LA 75 holds) with phrases from id2phrase.json
    (captions.json). An image's first five tags also open each of its
    captions. With `corpus`, also a pretraining corpus of CLI_CAPS rows an
    image, [image_id, caption, 8 phrases (JSON), answer id, answer]:
    captions as above, every other row a QA pair whose answer is one of the
    image's tags (corpus.tsv), and tag2id.json over the tag words. With
    `finetune`, each region's last 6 feature dims are a valid box [x1, y1,
    x2, y2, w, h] and `write_finetune_files` adds the VQA, SNLI-VE and RE
    files. Returns the paths and the bytes written."""
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
    nbytes, boxes = [0], {}

    def rows():
        for k in keys:
            feats = rng.standard_normal((CLI_REGIONS, 2054), np.float32)
            if finetune:
                xy = rng.uniform(0.0, 0.5, (CLI_REGIONS, 2))
                wh = rng.uniform(0.05, 0.5, (CLI_REGIONS, 2))
                feats[:, -6:] = np.concatenate([xy, xy + wh, wh], 1)
                boxes[k] = feats[:, -6:-2].copy()
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
    if corpus:
        paths["corpus"] = os.path.join(root, "corpus.tsv")
        paths["tag2id"] = os.path.join(root, "tag2id.json")
        rows = []
        for k in keys:
            for j in range(CLI_CAPS):
                filler = rng.integers(0, len(words), CLI_WORDS_PER_CAP - 5)
                answer = (tags[k][int(rng.integers(0, CLI_TAGS))]
                          if len(rows) % 2 else "")
                rows.append([
                    k, " ".join(tags[k][:5] + [words[int(w)] for w in filler]),
                    json.dumps([phrases[int(p)] for p in
                                rng.integers(0, CLI_PHRASES, 8)]),
                    int(rng.integers(0, QA_ANSWERS)), answer])
        tsv_writer(rows, paths["corpus"])
        with open(paths["tag2id"], "w") as f:
            json.dump({t: i for i, t in enumerate(tag_words)}, f)
    if finetune:
        paths.update(write_finetune_files(root, rng, words, phrases, tags,
                                          boxes))
    return paths, nbytes[0], os.path.getsize(paths["features"])


@contextlib.contextmanager
def around_steps(before=None, after=None):
    """`before(trainer)` and `after(trainer, metrics)` around every
    `Trainer.step` inside (nested: the inner one runs inside the outer)."""
    from mvp_pytorch_tpu_torch.training.trainer import Trainer
    real = Trainer.step

    def step(self, batch):
        if before is not None:
            before(self)
        out = real(self, batch)
        if after is not None:
            after(self, out)
        return out
    Trainer.step = step
    try:
        yield
    finally:
        Trainer.step = real


@contextlib.contextmanager
def counted_steps(attn, per_step, what):
    """Every `Trainer.step` inside must launch the dropout kernel exactly
    `per_step` times and the plain attention never; yields the running
    launch total."""
    total = [0]

    def after(trainer, metrics):
        check_counts(attn, per_step, what)
        total[0] += attn.masked_attention.launches
    with around_steps(lambda trainer: reset_counts(attn), after):
        yield total


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
    from mvp_pytorch_tpu_torch.models import RetrievalModel
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
        model = load_checkpoint(torch, RetrievalModel, ckpt)
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


# phase 8: the pretraining command line on a generated corpus at the real
# widths (phase 7's root plus a corpus.tsv and a tag2id.json)
PRE_ARGS = ["--max_seq_length", "70", "--max_phrases", "5",   # LA 75
            "--max_tag_length", "20", "--max_img_seq_length", "50",
            "--dtype", "bfloat16", "--seed", "11",
            "--hidden_dropout_prob", str(DROP_P),
            "--attention_dropout_prob", str(DROP_P), "--learning_rate", "1e-4"]
PRE_QA_STEPS = 3
MASK_SHARE, MASK_SHARE_TOL = 0.15, 0.02     # --mask_prob's default


def mask_shares(batch, max_tag_length):
    """The masked share of the real text tokens (labelled positions over the
    tokens before the phrase span) and of the regions (rows whose features
    masking zeroed, geometry kept); also whether the region labels sit
    exactly on the zeroed rows."""
    lab_a = np.asarray(batch["lm_label_ids_a"])
    text = int((np.asarray(batch["phrase_index"])[:, 0] - 1).sum())
    zeroed = (np.asarray(batch["img_feats"])[:, :, :-6] == 0).all(-1)
    region_labels = np.asarray(batch["lm_label_ids_b"])[:, max_tag_length:] >= 0
    return (float((lab_a >= 0).sum()) / text, float(zeroed.mean()),
            bool(np.array_equal(zeroed, region_labels)))


def phase8_pretrain_cli(torch, attn, layers_mod):
    """The pretraining command line (`tasks.pretrain.main`) at MVPTR-base on
    a generated corpus: the masks made in the workers, an in-memory
    baseline, one kernel-vs-plain step on the first real batch, CLI training
    through the process loader, and a short QA run."""
    import dataclasses
    import gc
    import shutil
    from mvp_pytorch_tpu_torch.data.loader import BatchSampler, ProcessLoader
    from mvp_pytorch_tpu_torch.data.tokenization import FastBertTokenizer
    from mvp_pytorch_tpu_torch.models import BiPretrainModel
    from mvp_pytorch_tpu_torch.tasks import pretrain as pre
    from mvp_pytorch_tpu_torch.tasks.common import build_config
    from mvp_pytorch_tpu_torch.training.loop import batch_on
    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_smoke",
                        "phase8")
    shutil.rmtree(root, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        paths, feat_bytes, tsv_bytes = write_cli_root(root, corpus=True)
        n_rows = CLI_IMAGES * CLI_CAPS
        log(f"  root: {CLI_IMAGES} images, {n_rows} corpus rows (every other "
            f"a QA pair), {CLI_REGIONS} regions x 2054 fp32 "
            f"({feat_bytes / 1e6:.1f} MB of features, {tsv_bytes / 1e6:.1f} "
            f"MB of TSV) written in {time.perf_counter() - t0:.1f} s")
        data = ["--corpus_tsv", paths["corpus"],
                "--feature_tsv", paths["features"],
                "--id2phrase", paths["id2phrase"], "--tag2id", paths["tag2id"]]
        args = pre.get_args(["--output_dir", root] + data + PRE_ARGS
                            + CLI_PLATFORM)
        tokenizer = FastBertTokenizer(paths["vocab"])
        cfg = build_config(args, tokenizer, qa_answer_size=0)
        dataset = pre.build_dataset(args, tokenizer, cfg)
        fetch = pre.PretrainFetch(dataset)
        sampler = BatchSampler(len(dataset), TRAIN_B, seed=args.seed)
        step_kw = dict(max_tag_length=args.max_tag_length,
                       hn_mod=args.hn_mod, phrase_mod=args.phrase_mod,
                       max_pred_a=args.max_pred_a, max_pred_b=args.max_pred_b)

        # 1. the masks: the shares in the first batch; epochs differ, and the
        # loader's worker masks a step of epoch 1 as epoch 1
        t0 = time.perf_counter()
        batches = [fetch(sampler.batch_at(s), sampler.epoch_at(s))
                   for s in range(CLI_MEM_STEPS)]
        fetch_ms = (time.perf_counter() - t0) * 1e3 / CLI_MEM_STEPS
        shapes = {k: v.shape for k, v in batches[0].items()}
        log(f"  a batch fetched and masked on the main thread: "
            f"{fetch_ms:.1f} ms; shapes {shapes}")
        la = args.max_seq_length + args.max_phrases
        if (shapes["input_ids_a"] != (TRAIN_B, la)
                or shapes["lm_label_ids_b"] != (TRAIN_B, 70)
                or shapes["img_feats"] != (TRAIN_B, CLI_REGIONS, 2054)
                or {"is_next", "is_img_match", "qa_ans"} & set(shapes)):
            raise AssertionError(f"batch shapes {shapes}")
        text_share, region_share, labels_on_regions = mask_shares(
            batches[0], args.max_tag_length)
        log(f"  first batch: masked share of text tokens {text_share:.4f}, "
            f"of regions {region_share:.4f} (want {MASK_SHARE} +- "
            f"{MASK_SHARE_TOL}); tag labels on exactly the masked regions: "
            f"{labels_on_regions}")
        if (abs(text_share - MASK_SHARE) > MASK_SHARE_TOL
                or abs(region_share - MASK_SHARE) > MASK_SHARE_TOL
                or not labels_on_regions):
            raise AssertionError("the first batch's masks are off")
        spe = sampler.epoch_len // TRAIN_B
        idx = sampler.batch_at(spe)
        loader = ProcessLoader(fetch, sampler, start_step=spe, num_workers=1,
                               device=DEVICE, multiprocessing_context="fork")
        for step, got in loader:
            got = {k: v.cpu().numpy() for k, v in got.items()}
            break
        loader.close()
        want1, want0 = fetch(idx, 1), fetch(idx, 0)
        same1 = all(np.array_equal(got[k], want1[k]) for k in want1)
        differ0 = not np.array_equal(got["lm_label_ids_a"],
                                     want0["lm_label_ids_a"])
        log(f"  loader at step {step} (epoch {sampler.epoch_at(step)}): "
            f"equal to fetch(indices, 1): {same1}; text masks differ from "
            f"epoch 0's on the same rows: {differ0}")
        if step != spe or sampler.epoch_at(step) != 1 or not (same1 and differ0):
            raise AssertionError("the loader did not mask by epoch")
        del loader, got, want0, want1

        # 2. in-memory baseline on the same batches
        per_step = cfg.half_layers * 4
        model = BiPretrainModel(cfg, device=DEVICE, seed=args.seed)
        with counted_steps(attn, per_step, "an in-memory step") as total:
            torch.cuda.reset_peak_memory_stats()
            mem = pre.train_pretrain(
                model, batches, CLI_MEM_STEPS, learning_rate=args.learning_rate,
                weight_decay=args.weight_decay, seed=args.seed, **step_kw)
        mem_peak = torch.cuda.max_memory_allocated() / 1e9
        mem_first = mem[0]["loss"]
        mem_ms = mean([m["step_ms"] for m in mem[CLI_MEM_TIMED_FROM - 1:]])
        mem_sps = TRAIN_B / mem_ms * 1e3
        log(f"  in memory: {CLI_MEM_STEPS} steps, {total[0]} launches; steps "
            f"{CLI_MEM_TIMED_FROM}-{CLI_MEM_STEPS}: {mem_ms:.2f} ms/step "
            f"{mem_sps:.1f} samples/s, peak {mem_peak:.2f} GB; losses "
            + " ".join(f"{m['loss']:.4f}" for m in mem))
        del model, mem
        gc.collect()
        torch.cuda.empty_cache()

        # 3. one step at dropouts 0 on the first real batch, kernel path
        # against plain path, the draws and the hard pairs pinned: in fp32
        # every loss and gradient is held; in bf16 the losses are held and
        # the gradients printed beside each path's distance from the fp32
        # gradient (on real masks both bf16 paths sit about 0.06 from it, so
        # their gap is bf16 rounding, not the kernel)
        batch = batch_on(DEVICE, batches[0])
        dice = torch.randperm(TRAIN_B, device=DEVICE, generator=torch.Generator(
            device=DEVICE).manual_seed(9))
        ref = None
        for dn in ("float32", "bfloat16"):
            cfg0 = dataclasses.replace(cfg, dtype=dn, hidden_dropout_prob=0.0,
                                       attention_probs_dropout_prob=0.0)
            model = BiPretrainModel(cfg0, device=DEVICE, seed=args.seed)
            model.train()

            def step():
                model.zero_grad(set_to_none=True)
                out = model.train_step(
                    *(batch.get(k) for k in pre.PRETRAIN_KEYS), hn_dice=dice,
                    wra_pick=1, wra_neg_offset=1,
                    generator=torch.Generator(device=DEVICE).manual_seed(0),
                    **step_kw)
                out.total_loss.backward()
                params = dict(model.named_parameters())
                return out, {n: params[n].grad.detach().float().clone()
                             for n in PRETRAIN_GRAD_PARAMS}

            reset_counts(attn)
            with hard_pairs(model) as mined:
                k_out, k_grads = step()
            torch.cuda.synchronize()
            if (attn.masked_attention.launches != per_step
                    or attn.masked_attention.dropout_launches != 0):
                raise AssertionError("kernel path did not launch the p = 0 "
                                     "kernel")
            with plain_attention_path(layers_mod, attn), hard_pairs(
                    model, pinned=mined[0]):
                p_out, p_grads = step()
            torch.cuda.synchronize()
            if attn.masked_attention.launches != per_step:
                raise AssertionError("plain path launched the kernel")
            losses_held = [n for n in PRETRAIN_LOSSES if n != "qa_loss"]
            if ref is None:
                compare_step(torch, "real batch", dn, k_out, p_out,
                             losses_held, k_grads, p_grads)
                ref = p_grads
            else:
                compare_step(torch, "real batch", dn, k_out, p_out,
                             losses_held, {}, {})
                def rel(a, b):
                    return ((a - b).norm() / b.norm()).item()
                for n in PRETRAIN_GRAD_PARAMS:
                    log(f"  real batch {dn:9s} grad {n}: kernel vs plain "
                        f"{rel(k_grads[n], p_grads[n]):.3e}; from the fp32 "
                        f"gradient: kernel {rel(k_grads[n], ref[n]):.3e}, "
                        f"plain {rel(p_grads[n], ref[n]):.3e} (printed)")
            del model, k_out, p_out, k_grads, p_grads
            gc.collect()
            torch.cuda.empty_cache()
        del batch, batches, ref
        gc.collect()
        torch.cuda.empty_cache()

        # 4. training through the CLI and the process loader
        out = os.path.join(root, "cli_train")
        common = ["--train_batch_size", str(TRAIN_B), "--log_period", "1",
                  "--num_workers", "4", "--worker_start_method", "fork",
                  "--data_dir", root] + data + PRE_ARGS + CLI_PLATFORM
        argv = (["--output_dir", out, "--max_steps", str(CLI_STEPS),
                 "--ckpt_period", str(CLI_STEPS)] + common)
        log("  python -m mvp_pytorch_tpu_torch.tasks.pretrain "
            + " ".join(os.path.relpath(a, root) if a.startswith(root) else a
                       for a in argv))
        with counted_steps(attn, per_step, "a CLI pretraining step") as total:
            torch.cuda.reset_peak_memory_stats()
            hist = pre.main(argv)["train"]
        cli_peak = torch.cuda.max_memory_allocated() / 1e9
        cli_launches = total[0]
        losses = [m["loss"] for m in hist]
        timed = hist[CLI_TIMED_FROM - 1:]
        cli_ms = mean([m["step_ms"] for m in timed])
        cli_sps = TRAIN_B / cli_ms * 1e3
        data_ms = mean([m["data_ms"] for m in timed])
        worker_ms = mean([m["worker_ms"] for m in timed])
        h2d_ms = mean([m.get("h2d_ms", float("nan")) for m in timed])
        log("  CLI losses " + " ".join(f"{x:.4f}" for x in losses))
        names = ("vis_mlm", "clip", "mlm", "itm", "wra")
        for when, m in (("first", hist[0]), ("last", hist[-1])):
            log(f"  {when} step: " + " ".join(f"{k}={m[k]:.4f}"
                                              for k in names))
        if (len(hist) != CLI_STEPS or not all(map(math.isfinite, losses))
                or mean(losses[-5:]) >= losses[0]):
            raise AssertionError(f"CLI pretraining losses not finite and "
                                 f"falling: {losses}")
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

        # 5. the QA heads through the CLI: a few steps
        argv = (["--output_dir", os.path.join(root, "cli_qa"), "--max_steps",
                 str(PRE_QA_STEPS), "--ckpt_period", "0", "--use_qa",
                 "--qa_answer_size", str(QA_ANSWERS), "--use_qa_pairs"]
                + common)
        with counted_steps(attn, per_step, "a CLI QA step") as qa_total:
            qa_hist = pre.main(argv)["train"]
        qa = [m.get("qa", float("nan")) for m in qa_hist]
        log(f"  CLI with --use_qa --use_qa_pairs: {len(qa_hist)} steps, "
            f"{qa_total[0]} launches; qa losses "
            + " ".join(f"{x:.4f}" for x in qa))
        if len(qa_hist) != PRE_QA_STEPS or not all(map(math.isfinite, qa)):
            raise AssertionError(f"the QA run's qa losses: {qa}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    log(f"  phase 8 took {seconds:.1f} s")
    return dict(launches=cli_launches, launches_per_step=per_step,
                qa_launches=qa_total[0], samples_per_s=cli_sps,
                step_ms=cli_ms, peak_gb=cli_peak,
                in_memory_samples_per_s=mem_sps, in_memory_step_ms=mem_ms,
                in_memory_peak_gb=mem_peak, ratio=ratio, main_data_ms=data_ms,
                worker_ms=worker_ms, h2d_ms=h2d_ms, main_fetch_ms=fetch_ms,
                text_mask_share=text_share, region_mask_share=region_share,
                first_step={k: hist[0][k] for k in ("loss",) + names},
                last_step={k: hist[-1][k] for k in ("loss",) + names},
                qa_losses=qa, seconds=seconds)


# phase 9: VQA, SNLI-VE and referring-expression fine-tuning through their
# command lines on phase 7's features with task files at the real widths
FT_QUESTIONS, FT_EVAL, FT_VE_PAIRS, FT_MAX_DET = 2000, 1000, 3000, 20
FT_B = {"vqa": 32, "ve": 64, "re": 32}
FT_LR = {"vqa": "5e-5", "ve": "4e-5", "re": "4e-5"}
FT_STEPS, FT_SHORT = 13, 3                  # VE / RE CLI steps; short runs
FT_ARGS = ["--max_seq_length", "35", "--max_phrases", "5",   # LA 40
           "--max_tag_length", "20", "--max_img_seq_length", "50",
           "--dtype", "bfloat16", "--seed", "11",
           "--hidden_dropout_prob", str(DROP_P),
           "--attention_dropout_prob", str(DROP_P)]
FT_EVAL_B = 64
# the VQA real batch in bf16, kernel path against plain path: the logits
# leave the QA decoder in bf16, so their gap is held in bf16 ulps at the
# batch's largest |logit|; the loss sums the BCE of 3,129 answers (about
# 2,300 at init), so its gap is held relative to the loss
FT_BF16_LOGIT_ULPS, FT_BF16_LOSS_REL = 4, 1e-4
FT_GRAD_PARAMS = ("cls.predictions.decoder.weight",
                  "cls.predictions.transform.dense.weight",
                  "bert.txt_encoder.layer.0.attention.self.query.weight",
                  "bert.vis_encoder.layer.0.attention.self.query.weight",
                  "bert.mul_encoder.layer.0.attention.self.query.weight")
# attention shapes of the fine-tuning steps: (name, B, L)
FT_SHAPES = (("fused", 64, 90), ("fused", 32, 90), ("text", 64, 40),
             ("text", 32, 40))


def write_finetune_files(root, rng, words, phrases, tags, boxes):
    """The task files over `write_cli_root`'s images, by the learnable rules
    of the port's `data/synthetic.py`: FT_QUESTIONS VQA questions whose
    answer (of QA_ANSWERS) is set by the image's first tag, each with up to
    10 soft scores (`vqa.jsonl`; the first FT_EVAL in `vqa_val.jsonl`) and
    `label2ans.json`; FT_VE_PAIRS SNLI-VE hypotheses, entailment naming one
    of the image's tags, contradiction a tag word it lacks, neutral a word
    that is no tag (`ve.jsonl`; the first FT_EVAL in `ve_val.jsonl`); one
    expression an image whose gt box is its largest region's (`re.json`),
    and up to FT_MAX_DET detections an image, one of them near the gt box
    (`re_dets.json`)."""
    keys = sorted(tags)
    tag_words = words[:2000]
    tag_index = {t: i for i, t in enumerate(tag_words)}
    plain_words = words[2000:]

    def text(n):
        return " ".join(plain_words[int(w)]
                        for w in rng.integers(0, len(plain_words), n))

    def some_phrases():
        return [phrases[int(j)] for j in rng.integers(0, len(phrases), 4)]

    out = {k: os.path.join(root, f) for k, f in (
        ("vqa", "vqa.jsonl"), ("vqa_val", "vqa_val.jsonl"),
        ("label2ans", "label2ans.json"), ("ve", "ve.jsonl"),
        ("ve_val", "ve_val.jsonl"), ("re", "re.json"),
        ("re_dets", "re_dets.json"))}
    lines = []
    for q in range(FT_QUESTIONS):
        k = keys[q % len(keys)]
        ans = [tag_index[tags[k][0]] % QA_ANSWERS]
        for a in rng.integers(0, QA_ANSWERS, int(rng.integers(0, 10))):
            if int(a) not in ans:
                ans.append(int(a))
        scores = [1.0] + [float(s) for s in rng.choice([0.3, 0.6, 0.9],
                                                         len(ans) - 1)]
        lines.append(json.dumps({"question_id": q, "image_id": k,
                                 "question": text(12), "labels": ans,
                                 "scores": scores,
                                 "phrases": some_phrases()}))
    for name, n in (("vqa", FT_QUESTIONS), ("vqa_val", FT_EVAL)):
        with open(out[name], "w") as f:
            f.write("\n".join(lines[:n]) + "\n")
    with open(out["label2ans"], "w") as f:
        json.dump([f"answer_{i}" for i in range(QA_ANSWERS)], f)
    lines = []
    labels = ("contradiction", "neutral", "entailment")
    for i in range(FT_VE_PAIRS):
        k, lab = keys[i % len(keys)], labels[i % 3]
        if lab == "entailment":
            word = tags[k][int(rng.integers(0, len(tags[k])))]
        elif lab == "contradiction":
            absent = sorted(set(tag_words) - set(tags[k]))
            word = absent[int(rng.integers(0, len(absent)))]
        else:
            word = text(1)
        lines.append(json.dumps({
            "pairID": f"p{i}", "Flickr30K_ID": k,
            "sentence2": f"{text(3)} {word} {text(2)}", "gold_label": lab,
            "phrases": some_phrases()}))
    for name, n in (("ve", FT_VE_PAIRS), ("ve_val", FT_EVAL)):
        with open(out[name], "w") as f:
            f.write("\n".join(lines[:n]) + "\n")
    items, dets = [], {}
    expression = text(6)
    for k in keys:
        b = boxes[k]
        gt = b[int(((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])).argmax())]
        items.append({"image_id": k, "expression": expression,
                      "gt_box": [float(v) for v in gt],
                      "phrases": some_phrases()})
        w, h = gt[2] - gt[0], gt[3] - gt[1]
        near = [gt[0] + 0.05 * w, gt[1] + 0.05 * h, gt[2] - 0.05 * w,
                gt[3] - 0.05 * h]
        n = int(rng.integers(4, FT_MAX_DET + 1))
        xy = rng.uniform(0.0, 0.5, (n - 1, 2))
        wh = rng.uniform(0.05, 0.5, (n - 1, 2))
        boxes_k = np.concatenate([xy, xy + wh], 1).tolist()
        boxes_k.insert(int(rng.integers(0, n)), [float(v) for v in near])
        dets[k] = boxes_k
    with open(out["re"], "w") as f:
        json.dump(items, f)
    with open(out["re_dets"], "w") as f:
        json.dump(dets, f)
    return out


def bf16_ulp(x: float) -> float:
    """The spacing of bfloat16 values (8 significant bits) at |x|."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 2.0 ** -133


def padded_forward(model, arrays, batch_size, **kw):
    """The drivers' padded eval (`tasks.common.predict`) over a dataset's
    arrays fetched at once, not chunk by chunk as the drivers fetch them;
    fp32 numpy."""
    from mvp_pytorch_tpu_torch.tasks.common import INPUT_NAMES, predict

    class InMemory:
        def __len__(self):
            return len(arrays["input_ids_a"])

        def fetch(self, idx):
            return {k: arrays[k][idx] for k in INPUT_NAMES}
    return predict(model, InMemory(), batch_size,
                   lambda m, *x: m(*x, **kw))[0]


def finetune_attention_times(torch, attn):
    """The kernel at the fine-tuning steps' attention shapes (bf16, blhd,
    padded 2-D key masks), at p 0.1 and p 0: its max abs error against the
    plain version on the same inputs and seed, its ms, the plain version's
    ms, SDPA's ms with the same mask and dropout, and the bound."""
    import torch.nn.functional as F
    gen = torch.Generator(device=DEVICE).manual_seed(9)
    out = {}
    for name, b, l in FT_SHAPES:
        q, k, v = (torch.randn(b, l, H, D, device=DEVICE, generator=gen)
                   .to(torch.bfloat16) for _ in range(3))
        lens = torch.randint(l // 2, l + 1, (b,), device=DEVICE,
                             generator=gen)
        bias = attn.mask_to_bias((torch.arange(l, device=DEVICE)[None, :]
                                  < lens[:, None]).to(torch.int32))
        seed = torch.randint(-2 ** 63, 2 ** 63 - 1, (1,), dtype=torch.int64,
                             device=DEVICE, generator=gen)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        bound, by = attention_bound_ms(b, l, l, "bfloat16", bias)
        for p in (DROP_P, 0.0):
            s = seed if p else None
            got = attn.masked_attention(q, k, v, bias, layout="blhd",
                                        dropout_p=p, seed=s)
            want = attn.plain_attention_blhd(q, k, v, bias, p, s)
            err = (got.float() - want.float()).abs().max().item()
            if not err <= TOL["bfloat16"]:
                raise AssertionError(f"kernel vs plain {name} B {b} L {l} "
                                     f"p {p}: {err}")
            row = dict(
                max_abs_err=err, bound_ms=bound, bound_by=by,
                ms=cuda_ms(lambda: attn.masked_attention(
                    q, k, v, bias, layout="blhd", dropout_p=p, seed=s)),
                plain_ms=cuda_ms(lambda: attn.plain_attention_blhd(
                    q, k, v, bias, p, s), iters=5),
                sdpa_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=bias.to(torch.bfloat16),
                    dropout_p=p)))
            out[f"{name} B {b} L {l} p {p:g}"] = row
            log(f"  kernel {name:5s} B={b} L={l} bf16 p={p:g}: max|err| "
                f"{err:.3e}  kernel {row['ms']:.4f} ms  plain "
                f"{row['plain_ms']:.4f} ms  sdpa {row['sdpa_ms']:.4f} ms  "
                f"bound {bound:.4f} ms ({by})")
        del q, k, v, qh, kh, vh, bias, got, want
    torch.cuda.synchronize()
    return out


def cli_numbers(hist, b, peak, timed_from=CLI_TIMED_FROM):
    """step ms, samples/s, main-thread data ms and, through the loader,
    worker ms and H2D ms over the steps from `timed_from` on."""
    timed = hist[timed_from - 1:]
    ms = mean([m["step_ms"] for m in timed])
    out = dict(step_ms=ms, samples_per_s=b / ms * 1e3, peak_gb=peak,
               main_data_ms=mean([m["data_ms"] for m in timed]))
    for k in ("worker_ms", "h2d_ms"):
        if k in timed[0]:
            out[k] = mean([m[k] for m in timed])
    return out


def check_losses(hist, steps, what):
    losses = [m["loss"] for m in hist]
    log(f"  {what} losses " + " ".join(f"{x:.4f}" for x in losses))
    if len(hist) != steps or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{what}: losses {losses}")
    return losses


def phase9_vqa(torch, attn, layers_mod, paths, root):
    """(a) VQA: kernel path against plain path on the first real batch,
    13 steps in memory, 26 through the CLI, the CLI's eval and test output
    against the model's forward in memory, and the kl -> bce and dropout
    schedules."""
    import dataclasses
    import gc
    import shutil
    from mvp_pytorch_tpu_torch.data.datasets import VQADataset
    from mvp_pytorch_tpu_torch.data.loader import BatchSampler
    from mvp_pytorch_tpu_torch.data.tokenization import FastBertTokenizer
    from mvp_pytorch_tpu_torch.models import VQAModel
    from mvp_pytorch_tpu_torch.models.layers import hidden_dropouts
    from mvp_pytorch_tpu_torch.tasks import vqa
    from mvp_pytorch_tpu_torch.tasks.common import (MODEL_KEYS, TaskFetch,
                                                    build_config,
                                                    tensorize_cfg)
    from mvp_pytorch_tpu_torch.data.datasets import (FeatureStore,
                                                     load_phrase_vocab)
    from mvp_pytorch_tpu_torch.training.loop import batch_on, train_on_batches
    b = FT_B["vqa"]
    data = ["--train_jsonl", paths["vqa"], "--feature_tsv", paths["features"],
            "--id2phrase", paths["id2phrase"], "--label2ans",
            paths["label2ans"], "--data_dir", root]
    common = (data + FT_ARGS + CLI_PLATFORM
              + ["--learning_rate", FT_LR["vqa"], "--train_batch_size", str(b),
                 "--log_period", "1", "--num_workers", "4",
                 "--worker_start_method", "fork"])
    args = vqa.get_args(["--output_dir", root] + common)
    tokenizer = FastBertTokenizer(paths["vocab"])
    cfg = build_config(args, tokenizer, num_labels=QA_ANSWERS,
                       loss_type="bce")
    per_step = cfg.half_layers * 3           # text, vision, one fusion pass
    dataset = VQADataset(paths["vqa"], FeatureStore(paths["features"]),
                         tokenizer, QA_ANSWERS,
                         sg2id=load_phrase_vocab(paths["id2phrase"]),
                         cfg=tensorize_cfg(args))
    fetch = TaskFetch(dataset)
    sampler = BatchSampler(len(dataset), b, seed=args.seed)
    t0 = time.perf_counter()
    batches = [fetch(sampler.batch_at(s)) for s in range(CLI_MEM_STEPS)]
    fetch_ms = (time.perf_counter() - t0) * 1e3 / CLI_MEM_STEPS
    shapes = {k: v.shape for k, v in batches[0].items()}
    log(f"  vqa: a batch fetched on the main thread: {fetch_ms:.1f} ms; "
        f"shapes {shapes}")
    if (shapes["input_ids_a"] != (b, 40) or shapes["attention_mask_b"]
            != (b, 70) or shapes["img_feats"] != (b, CLI_REGIONS, 2054)
            or shapes["label"] != (b, QA_ANSWERS)):
        raise AssertionError(f"vqa batch shapes {shapes}")

    # 1. the first real batch at dropout 0: kernel path against plain path
    batch = batch_on(DEVICE, batches[0])
    ref = None
    for dn in ("float32", "bfloat16"):
        model = VQAModel(dataclasses.replace(
            cfg, dtype=dn, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0), device=DEVICE, seed=args.seed)
        model.train()

        def step():
            model.zero_grad(set_to_none=True)
            loss, logits = model(*(batch[k] for k in MODEL_KEYS),
                                 labels=batch["label"], max_tag_length=20)
            loss.backward()
            params = dict(model.named_parameters())
            return ((loss.detach(), logits.detach()),
                    {n: params[n].grad.detach().float().clone()
                     for n in FT_GRAD_PARAMS})

        reset_counts(attn)
        (k_loss, k_logits), k_grads = step()
        torch.cuda.synchronize()
        if (attn.masked_attention.launches != per_step
                or attn.masked_attention.dropout_launches != 0):
            raise AssertionError("vqa kernel path did not launch the p = 0 "
                                 "kernel")
        with plain_attention_path(layers_mod, attn):
            (p_loss, p_logits), p_grads = step()
        torch.cuda.synchronize()
        if attn.masked_attention.launches != per_step:
            raise AssertionError("vqa plain path launched the kernel")
        tol = E2E_TOL[dn]
        for name, a, c in (("logits", k_logits, p_logits),
                           ("loss", k_loss, p_loss)):
            gap = (a - c).abs().max().item()
            if ref is None:
                ok = bool(torch.isfinite(a).all()) and gap <= tol
                log(f"  vqa real batch {dn:9s} {name}: max|kernel-plain| "
                    f"{gap:.3e} tol {tol:g} {'ok' if ok else 'FAIL'}")
            else:
                scale = c.abs().max().item()
                if name == "logits":
                    lim = FT_BF16_LOGIT_ULPS * bf16_ulp(scale)
                    rule = (f"{FT_BF16_LOGIT_ULPS} bf16 ulps at max|logit| "
                            f"{scale:.3f}")
                else:
                    lim = FT_BF16_LOSS_REL * scale
                    rule = f"{FT_BF16_LOSS_REL:g} of the loss {scale:.3f}"
                ok = bool(torch.isfinite(a).all()) and gap <= lim
                log(f"  vqa real batch {dn:9s} {name}: max|kernel-plain| "
                    f"{gap:.3e} tol {lim:.3e} ({rule}) "
                    f"{'ok' if ok else 'FAIL'}; from fp32 (printed): kernel "
                    f"{(a - ref[name]).abs().max().item():.3e}, plain "
                    f"{(c - ref[name]).abs().max().item():.3e}")
            if not ok:
                raise AssertionError(f"vqa real batch {dn} {name}")

        def rel(a, c):
            return ((a - c).norm() / c.norm()).item()
        for n in FT_GRAD_PARAMS:
            r = rel(k_grads[n], p_grads[n])
            if ref is None:
                ok = bool(torch.isfinite(k_grads[n]).all()) and r <= 1e-3
                log(f"  vqa real batch {dn:9s} grad {n}: rel err {r:.3e} "
                    f"tol 0.001 {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"vqa real batch {dn} grad {n}: {r}")
            else:
                log(f"  vqa real batch {dn:9s} grad {n}: kernel vs plain "
                    f"{r:.3e}; from the fp32 gradient: kernel "
                    f"{rel(k_grads[n], ref[n]):.3e}, plain "
                    f"{rel(p_grads[n], ref[n]):.3e} (printed)")
        ref = ref or dict(p_grads, logits=p_logits, loss=p_loss)
        del model, k_grads, p_grads, k_logits, p_logits
        gc.collect()
        torch.cuda.empty_cache()
    del batch, ref

    # 2. in memory: the same batches
    model = VQAModel(cfg, device=DEVICE, seed=args.seed)
    with counted_steps(attn, per_step, "a vqa in-memory step") as total:
        torch.cuda.reset_peak_memory_stats()
        mem = train_on_batches(model, vqa.vqa_loss_fn(args, cfg), batches,
                               CLI_MEM_STEPS, learning_rate=args.learning_rate,
                               weight_decay=args.weight_decay, seed=args.seed)
    mem_n = cli_numbers(mem, b, torch.cuda.max_memory_allocated() / 1e9,
                        CLI_MEM_TIMED_FROM)
    check_losses(mem, CLI_MEM_STEPS, "vqa in memory")
    log(f"  vqa in memory: {total[0]} launches; {mem_n['step_ms']:.2f} "
        f"ms/step {mem_n['samples_per_s']:.1f} samples/s, peak "
        f"{mem_n['peak_gb']:.2f} GB")
    del model, batches
    gc.collect()
    torch.cuda.empty_cache()

    # 3. the CLI and its process loader
    out = os.path.join(root, "vqa_train")
    argv = (["--output_dir", out, "--do_train", "--max_steps",
             str(CLI_STEPS), "--ckpt_period", str(CLI_STEPS)] + common)
    log("  python -m mvp_pytorch_tpu_torch.tasks.vqa " + " ".join(
        os.path.relpath(a, root) if a.startswith(root) else a for a in argv))
    with counted_steps(attn, per_step, "a vqa CLI step") as total:
        torch.cuda.reset_peak_memory_stats()
        hist = vqa.main(argv)["train"]
    cli_n = cli_numbers(hist, b, torch.cuda.max_memory_allocated() / 1e9)
    losses = check_losses(hist, CLI_STEPS, "vqa CLI")
    log(f"  vqa step 1 loss: CLI {losses[0]:.6f}, in memory "
        f"{mem[0]['loss']:.6f}")
    if abs(losses[0] - mem[0]["loss"]) > STEP_TOL["bfloat16"][0]:
        raise AssertionError("the vqa CLI's first batch is not the sampler's")
    ratio = cli_n["samples_per_s"] / mem_n["samples_per_s"]
    log(f"  vqa CLI: {total[0]} launches ({per_step} a step, all with "
        f"dropout, plain 0); {cli_n['step_ms']:.2f} ms/step "
        f"{cli_n['samples_per_s']:.1f} samples/s, peak {cli_n['peak_gb']:.2f} "
        f"GB; main thread data {cli_n['main_data_ms']:.3f} ms/step, worker "
        f"{cli_n['worker_ms']:.1f} ms/batch, H2D "
        f"{cli_n.get('h2d_ms', float('nan')):.3f} ms/batch; ratio to memory "
        f"{ratio:.3f} (target 0.90)")
    gc.collect()
    torch.cuda.empty_cache()

    # 4. the CLI's eval and test output from the checkpoint
    ckpt = os.path.join(out, f"checkpoint-{CLI_STEPS:07d}")
    shutil.copy(paths["vocab"], ckpt)
    argv = (["--output_dir", os.path.join(root, "vqa_eval"),
             "--model_name_or_path", ckpt, "--do_eval", "--eval_jsonl",
             paths["vqa_val"], "--test_jsonl", paths["vqa_val"],
             "--eval_batch_size", str(FT_EVAL_B)] + data + FT_ARGS
            + CLI_PLATFORM)
    reset_counts(attn)
    res = vqa.main(argv)
    torch.cuda.synchronize()
    n_batches = 2 * math.ceil(FT_EVAL / FT_EVAL_B)
    got = (attn.masked_attention.launches,
           attn.masked_attention.dropout_launches, attn.plain_attention.calls)
    log(f"  vqa CLI eval + test: {got[0]} launches ({got[1]} with dropout, "
        f"plain {got[2]}) over {n_batches} batches of {FT_EVAL_B}; "
        f"vqa_accuracy {res['eval']['vqa_accuracy']:.4f}")
    if got != (per_step * n_batches, 0, 0):
        raise AssertionError(f"vqa eval launched {got}")
    val = VQADataset(paths["vqa_val"], FeatureStore(paths["features"]),
                     tokenizer, QA_ANSWERS,
                     sg2id=load_phrase_vocab(paths["id2phrase"]),
                     cfg=tensorize_cfg(args))
    arrays = val.fetch(np.arange(len(val)))
    model = load_checkpoint(torch, VQAModel, ckpt)
    logits = padded_forward(model, arrays, FT_EVAL_B,
                            max_tag_length=20)
    err = float(np.abs(logits - res["eval"]["logits"]).max())
    acc = vqa.vqa_accuracy(logits, arrays["label"])
    with open(os.path.join(root, "vqa_eval", "vqa_val_results.json")) as f:
        results = json.load(f)
    with open(paths["label2ans"]) as f:
        label2ans = json.load(f)
    answers_ok = (len(results) == FT_EVAL and [r["question_id"] for r in
                                               results]
                  == [int(q) for q in arrays["question_id"]]
                  and [r["answer"] for r in results]
                  == [label2ans[int(a)] for a in logits.argmax(1)])
    log(f"  vqa eval against the forward in memory: max|logit diff| "
        f"{err:.3e} (tol {SCORE_TOL:g}), accuracy {acc:.4f} vs CLI "
        f"{res['eval']['vqa_accuracy']:.4f}; test output: {len(results)} "
        f"answers from label2ans {'ok' if answers_ok else 'WRONG'}")
    if err > SCORE_TOL or acc != res["eval"]["vqa_accuracy"] or not answers_ok:
        raise AssertionError("vqa CLI eval differs from the forward in memory")
    del model, arrays, res
    gc.collect()
    torch.cuda.empty_cache()

    # 5. the schedules: kl -> bce and the hidden dropouts at step 2
    kinds, kernel_p, seen = [], [], []
    real_kl, real_bce = vqa.kl_div_loss, vqa.instance_bce_with_logits
    real_attn = layers_mod.masked_attention

    def kl(*a):
        kinds.append("kl")
        return real_kl(*a)

    def bce(*a):
        kinds.append("bce")
        return real_bce(*a)

    def attention(*a, **kw):
        kernel_p.append(kw.get("dropout_p", 0.0))
        return real_attn(*a, **kw)

    def before(trainer):
        kinds.clear()
        kernel_p.clear()

    def after(trainer, metrics):
        seen.append((trainer.step_count - 1, tuple(kinds),
                     sorted({m.p for m in hidden_dropouts(trainer.model)}),
                     sorted(set(kernel_p))))
    argv = (["--output_dir", os.path.join(root, "vqa_sched"), "--do_train",
             "--max_steps", str(FT_SHORT), "--ckpt_period", "0",
             "--loss_type", "kl", "--adjust_loss_step", "2",
             "--adjust_dp_step", "2"] + common)
    vqa.kl_div_loss, vqa.instance_bce_with_logits = kl, bce
    layers_mod.masked_attention = attention
    try:
        with counted_steps(attn, per_step, "a vqa schedule step"), \
                around_steps(before, after):
            sched = vqa.main(argv)["train"]
    finally:
        vqa.kl_div_loss, vqa.instance_bce_with_logits = real_kl, real_bce
        layers_mod.masked_attention = real_attn
    check_losses(sched, FT_SHORT, "vqa kl -> bce")
    want = [(s, ("kl",) if s < 2 else ("bce",),
             [DROP_P if s < 2 else 0.3], [DROP_P]) for s in range(FT_SHORT)]
    for s in seen:
        log(f"  vqa schedule: step {s[0]} loss {s[1]} hidden dropouts {s[2]} "
            f"kernel p {s[3]}")
    if seen != want:
        raise AssertionError(f"vqa schedules: {seen}, want {want}")
    return dict(launches_per_step=per_step, launches=total[0],
                in_memory=mem_n, cli=cli_n, ratio=ratio,
                main_fetch_ms=fetch_ms, eval_logit_err=err,
                vqa_accuracy=acc, losses=losses)


def load_checkpoint(torch, model_cls, ckpt):
    """A bf16 `model_cls` on the card with a CLI checkpoint's weights."""
    from mvp_pytorch_tpu_torch.models import ModelConfig
    model = model_cls(ModelConfig.from_pretrained(ckpt, dtype="bfloat16"),
                      device=DEVICE)
    model.load_state_dict(torch.load(os.path.join(ckpt, "pytorch_model.bin"),
                                     map_location=DEVICE, weights_only=True))
    return model


def phase9_ve(torch, attn, paths, root):
    """(b) SNLI-VE: 13 CLI steps with --mask_training --freeze_steps 5, the
    freeze read off the parameters after every step, the eval against the
    forward in memory; 3 steps with --use_single."""
    import gc
    from mvp_pytorch_tpu_torch.data.datasets import (FeatureStore, VEDataset,
                                                     load_phrase_vocab)
    from mvp_pytorch_tpu_torch.data.tokenization import FastBertTokenizer
    from mvp_pytorch_tpu_torch.models import ClassificationModel
    from mvp_pytorch_tpu_torch.tasks import ve
    from mvp_pytorch_tpu_torch.tasks.common import build_config, tensorize_cfg
    b, freeze = FT_B["ve"], 5
    common = (["--train_jsonl", paths["ve"], "--feature_tsv",
               paths["features"], "--id2phrase", paths["id2phrase"],
               "--data_dir", root] + FT_ARGS + CLI_PLATFORM
              + ["--learning_rate", FT_LR["ve"], "--train_batch_size",
                 str(b), "--log_period", "1", "--num_workers", "4",
                 "--worker_start_method", "fork"])
    bert0, cls_prev, seen = {}, [], []

    def classifier(model):
        return [p for n, p in model.named_parameters()
                if n.startswith("classifier.")]

    def before(trainer):
        if not bert0:
            bert0.update({n: p.detach().clone() for n, p in
                          trainer.model.named_parameters()
                          if n.startswith("bert.")})
        cls_prev[:] = [p.detach().clone() for p in classifier(trainer.model)]

    def after(trainer, metrics):
        params = dict(trainer.model.named_parameters())
        seen.append((trainer.step_count,
                     all(torch.equal(params[n], p) for n, p in bert0.items()),
                     any(not torch.equal(a, c) for a, c in
                         zip(cls_prev, classifier(trainer.model)))))

    out = os.path.join(root, "ve_train")
    argv = (["--output_dir", out, "--do_train", "--do_eval", "--max_steps",
             str(FT_STEPS), "--ckpt_period", str(FT_STEPS), "--eval_jsonl",
             paths["ve_val"], "--eval_batch_size", str(FT_EVAL_B),
             "--mask_training", "--freeze_steps", str(freeze)] + common)
    log("  python -m mvp_pytorch_tpu_torch.tasks.ve " + " ".join(
        os.path.relpath(a, root) if a.startswith(root) else a for a in argv))
    args = ve.get_args(argv)
    tokenizer = FastBertTokenizer(paths["vocab"])
    per_step = 3 * build_config(args, tokenizer, num_labels=3).half_layers
    with counted_steps(attn, per_step, "a ve CLI step") as total, \
            around_steps(before, after):
        torch.cuda.reset_peak_memory_stats()
        res = ve.main(argv)
    cli_n = cli_numbers(res["train"], b,
                        torch.cuda.max_memory_allocated() / 1e9)
    losses = check_losses(res["train"], FT_STEPS, "ve CLI")
    want = [(s, s <= freeze, True) for s in range(1, FT_STEPS + 1)]
    log("  ve freeze: (step, bert.* bitwise unchanged, classifier moved) "
        + " ".join(f"{s}:{int(u)}{int(c)}" for s, u, c in seen))
    if seen != want:
        raise AssertionError(f"ve freeze {seen}, want {want}")
    log(f"  ve CLI: {total[0]} launches ({per_step} a step, all with "
        f"dropout, plain 0); {cli_n['step_ms']:.2f} ms/step "
        f"{cli_n['samples_per_s']:.1f} samples/s, peak {cli_n['peak_gb']:.2f} "
        f"GB; main thread data {cli_n['main_data_ms']:.3f} ms/step, worker "
        f"{cli_n['worker_ms']:.1f} ms/batch; acc (train) "
        + " ".join(f"{m['acc']:.3f}" for m in res["train"]))
    bert0.clear()
    gc.collect()
    torch.cuda.empty_cache()
    val = VEDataset(paths["ve_val"], FeatureStore(paths["features"]),
                    tokenizer, sg2id=load_phrase_vocab(paths["id2phrase"]),
                    cfg=tensorize_cfg(args))
    arrays = val.fetch(np.arange(len(val)))
    model = load_checkpoint(torch, ClassificationModel,
                            os.path.join(out, f"checkpoint-{FT_STEPS:07d}"))
    logits = padded_forward(model, arrays, FT_EVAL_B,
                            max_tag_length=20)
    acc = float((logits.argmax(1) == arrays["label"]).sum()) / len(val)
    with open(os.path.join(out, "eval_logs.json")) as f:
        logged = json.load(f)[-1]["ve_accuracy"]
    log(f"  ve eval: CLI ve_accuracy {logged:.4f}, in memory {acc:.4f} "
        f"({len(val)} pairs)")
    if acc != logged:
        raise AssertionError("ve CLI eval differs from the forward in memory")
    del model, arrays
    gc.collect()
    torch.cuda.empty_cache()
    argv = (["--output_dir", os.path.join(root, "ve_single"), "--do_train",
             "--max_steps", str(FT_SHORT), "--ckpt_period", "0",
             "--use_single"] + common)
    with counted_steps(attn, per_step, "a ve --use_single step") as stotal:
        single = ve.main(argv)["train"]
    check_losses(single, FT_SHORT, "ve --use_single")
    log(f"  ve --use_single: {stotal[0]} launches")
    return dict(launches_per_step=per_step, launches=total[0], cli=cli_n,
                ve_accuracy=acc, losses=losses,
                single_losses=[m["loss"] for m in single])


def phase9_re(torch, attn, paths, root):
    """(c) RE: 13 CLI steps of `REModel` mod 1 reading fusion layer 2, with
    the detections, the three accuracies against the forward in memory; 3
    steps at --loss_mod 3."""
    import gc
    from mvp_pytorch_tpu_torch.data.datasets import (FeatureStore, REDataset,
                                                     load_phrase_vocab,
                                                     re_score, re_score_det1,
                                                     re_score_det2)
    from mvp_pytorch_tpu_torch.data.tokenization import FastBertTokenizer
    from mvp_pytorch_tpu_torch.models import REModel
    from mvp_pytorch_tpu_torch.tasks import re_task
    from mvp_pytorch_tpu_torch.tasks.common import build_config, tensorize_cfg
    b = FT_B["re"]
    phrase_layer = "2" if DEVICE == "cuda" else "0"
    common = (["--train_json", paths["re"], "--feature_tsv",
               paths["features"], "--id2phrase", paths["id2phrase"],
               "--data_dir", root] + FT_ARGS + CLI_PLATFORM
              + ["--learning_rate", FT_LR["re"], "--train_batch_size",
                 str(b), "--log_period", "1", "--num_workers", "4",
                 "--worker_start_method", "fork"])
    out = os.path.join(root, "re_train")
    argv = (["--output_dir", out, "--do_train", "--do_eval", "--max_steps",
             str(FT_STEPS), "--ckpt_period", str(FT_STEPS), "--eval_json",
             paths["re"], "--det_json", paths["re_dets"], "--max_det",
             str(FT_MAX_DET), "--eval_batch_size", str(FT_EVAL_B),
             "--loss_mod", "1", "--phrase_layer", phrase_layer] + common)
    log("  python -m mvp_pytorch_tpu_torch.tasks.re_task " + " ".join(
        os.path.relpath(a, root) if a.startswith(root) else a for a in argv))
    args = re_task.get_args(argv)
    tokenizer = FastBertTokenizer(paths["vocab"])
    per_step = 3 * build_config(args, tokenizer, num_labels=1).half_layers
    with counted_steps(attn, per_step, "an re CLI step") as total:
        torch.cuda.reset_peak_memory_stats()
        res = re_task.main(argv)
    cli_n = cli_numbers(res["train"], b,
                        torch.cuda.max_memory_allocated() / 1e9)
    losses = check_losses(res["train"], FT_STEPS, "re CLI")
    log(f"  re CLI: {total[0]} launches ({per_step} a step, all with "
        f"dropout, plain 0); {cli_n['step_ms']:.2f} ms/step "
        f"{cli_n['samples_per_s']:.1f} samples/s, peak {cli_n['peak_gb']:.2f} "
        f"GB; main thread data {cli_n['main_data_ms']:.3f} ms/step, worker "
        f"{cli_n['worker_ms']:.1f} ms/batch")
    gc.collect()
    torch.cuda.empty_cache()
    val = REDataset(paths["re"], FeatureStore(paths["features"]), tokenizer,
                    sg2id=load_phrase_vocab(paths["id2phrase"]),
                    cfg=tensorize_cfg(args), det_json=paths["re_dets"],
                    max_det=FT_MAX_DET)
    arrays = val.fetch(np.arange(len(val)))
    model = load_checkpoint(torch, REModel,
                            os.path.join(out, f"checkpoint-{FT_STEPS:07d}"))
    logits = padded_forward(model, arrays, FT_EVAL_B,
                            max_tag_length=20, mod=1,
                            phrase_layer=int(phrase_layer))
    det = (logits, arrays["label"], arrays["det_label"], arrays["iou_mat"])
    mine = {"re_accuracy": re_score(*det[:2]),
            "re_accuracy_det1": re_score_det1(*det),
            "re_accuracy_det2": re_score_det2(*det)}
    with open(os.path.join(out, "eval_logs.json")) as f:
        logged = {k: v for k, v in json.load(f)[-1].items() if k != "step"}
    log(f"  re eval: CLI {json.dumps(logged)}; in memory {json.dumps(mine)}")
    if logged != mine:
        raise AssertionError("re CLI eval differs from the forward in memory")
    del model, arrays
    gc.collect()
    torch.cuda.empty_cache()
    argv = (["--output_dir", os.path.join(root, "re_mod3"), "--do_train",
             "--max_steps", str(FT_SHORT), "--ckpt_period", "0",
             "--loss_mod", "3"] + common)
    with counted_steps(attn, per_step, "an re --loss_mod 3 step") as mtotal:
        mod3 = re_task.main(argv)["train"]
    check_losses(mod3, FT_SHORT, "re --loss_mod 3")
    log(f"  re --loss_mod 3: {mtotal[0]} launches")
    return dict(launches_per_step=per_step, launches=total[0], cli=cli_n,
                scores=mine, losses=losses,
                mod3_losses=[m["loss"] for m in mod3])


def finetune_summary(ft):
    """Phase 9's numbers for the kernels line: each task's launches a step,
    step ms, samples/s and peak GB, and the kernel's ms, bound ms, plain
    ms and SDPA ms at each of FT_SHAPES (fused L 90, B 64 first) at p 0.1
    and 0."""
    out = {task: {"launches_per_step": r["launches_per_step"],
                  "launches": r["launches"], **r["cli"]}
           for task, r in ft["tasks"].items()}
    out["vqa"].update(ratio=ft["tasks"]["vqa"]["ratio"],
                      in_memory=ft["tasks"]["vqa"]["in_memory"])
    out["attention"] = ft["attention"]
    out["seconds"] = ft["seconds"]
    return out


def phase9_finetune_cli(torch, attn, layers_mod):
    """The VQA, SNLI-VE and RE command lines at MVPTR-base on a generated
    root, and the kernel at their attention shapes."""
    import gc
    import shutil
    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_smoke",
                        "phase9")
    shutil.rmtree(root, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        paths, feat_bytes, tsv_bytes = write_cli_root(root, finetune=True)
        log(f"  root: {CLI_IMAGES} images, {CLI_REGIONS} regions x 2054 fp32 "
            f"({feat_bytes / 1e6:.1f} MB of features, {tsv_bytes / 1e6:.1f} "
            f"MB of TSV), {FT_QUESTIONS} questions over {QA_ANSWERS} answers, "
            f"{FT_VE_PAIRS} hypotheses, {CLI_IMAGES} expressions written in "
            f"{time.perf_counter() - t0:.1f} s")
        times = finetune_attention_times(torch, attn)
        res = {"vqa": phase9_vqa(torch, attn, layers_mod, paths, root)}
        gc.collect()
        torch.cuda.empty_cache()
        res["ve"] = phase9_ve(torch, attn, paths, root)
        gc.collect()
        torch.cuda.empty_cache()
        res["re"] = phase9_re(torch, attn, paths, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    log(f"  phase 9 took {seconds:.1f} s")
    return dict(tasks=res, attention=times, seconds=seconds)


def main(argv) -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--sweep", choices=("bfloat16", "float32"),
                        help="run phase 3 alone, in this dtype")
    parser.add_argument("--cli", action="store_true",
                        help="run phase 7 (the retrieval command line) alone")
    parser.add_argument("--pretrain_cli", action="store_true",
                        help="run phase 8 (the pretraining command line) "
                             "alone")
    parser.add_argument("--finetune_cli", action="store_true",
                        help="run phase 9 (the VQA, SNLI-VE and RE command "
                             "lines) alone")
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
    if args.pretrain_cli:
        log("phase 8 alone: the pretraining command line, MVPTR-base, B 96")
        pcli = phase8_pretrain_cli(torch, attn, layers_mod)
        print(json.dumps({"pretrain_cli": pcli, "card": card}), flush=True)
        return 0
    if args.finetune_cli:
        log("phase 9 alone: the VQA, SNLI-VE and RE command lines, "
            "MVPTR-base")
        ft = phase9_finetune_cli(torch, attn, layers_mod)
        print(json.dumps({"finetune": finetune_summary(ft), "card": card}),
              flush=True)
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

    log("phase 8: the pretraining command line, MVPTR-base, B 96, generated "
        "corpus")
    pcli = phase8_pretrain_cli(torch, attn, layers_mod)
    torch.cuda.synchronize()

    log("phase 9: the VQA, SNLI-VE and RE command lines, MVPTR-base, "
        "generated root")
    ft = phase9_finetune_cli(torch, attn, layers_mod)
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
        "cli": {k: v for k, v in cli.items() if k != "losses"},
        "pretrain_cli": pcli,
        "finetune": finetune_summary(ft)}, {
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
