#!/usr/bin/env python3
"""Where the time of the port's training step goes, on the card.

    python3 profile_train_step.py                    # retrieval, dropouts 0
    python3 profile_train_step.py --model pretrain   # pretraining, dropouts 0.1
    python3 profile_train_step.py --model retrieval --dropout 0.1
    python3 profile_train_step.py --model vqa        # VQA fine-tuning, 0.1

Builds MVPTR-base (bf16 over fp32 weights, seeded random weights) as
chip_smoke.py phase 5 (`RetrievalModel`), phase 6 (`BiPretrainModel`) or
phase 9 (`VQAModel`, 3,129 answers, bce) does, both dropouts at `--dropout`
(default 0 for retrieval, the setting of its earlier profiles, and the
config's 0.1 for pretraining and VQA), takes 3 warm-up steps on one batch of
96 (LA 75, T 20, R 50, hard negatives; pretraining: bench.py's labels and
spans; VQA: B 32, LA 40, T 20, R 50, half padded, soft scores), then
profiles 3 steps with torch.profiler. Each step runs the forward, the backward and the optimizer
under their own record_function labels. Prints, as one JSON object: the step
time with and without the profiler, the device time of each part of the
step and of the attention's recompute backward (`MaskedAttentionFnBackward`),
the device time by kernel class (the attention forward is the kernel's own
class), the top kernels, and the device's busy and idle share of the
profiled window.
"""

from __future__ import annotations

import json
import os
import sys
import time

STEPS_WARM, STEPS_PROF = 3, 3
PARTS = ("forward", "backward", "optimizer")


def device_us(event) -> float:
    """Device time of the kernels an op (and its children) launched."""
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(event, attr):
            return getattr(event, attr)
    return 0.0


def main(argv) -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model", choices=("retrieval", "pretrain", "vqa"),
                        default="retrieval")
    parser.add_argument("--dropout", type=float, default=None,
                        help="both dropouts (default: 0 retrieval, 0.1 "
                             "pretrain and vqa)")
    args = parser.parse_args(argv)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    if not torch.cuda.is_available():
        print("profile_train_step: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from chip_smoke import (FT_B, QA_ANSWERS, TRAIN_B, base_config,
                            bench_inputs, card_line, pretrain_batch,
                            train_batch)
    from profile_two_stage import busy_us, classify
    from mvp_pytorch_tpu_torch.models import (BiPretrainModel, ModelConfig,
                                              RetrievalModel, VQAModel)
    from mvp_pytorch_tpu_torch.tasks.pretrain import pretrain_loss_fn
    from mvp_pytorch_tpu_torch.tasks.retrieval import retrieval_loss_fn
    from mvp_pytorch_tpu_torch.training.optim import make_optimizer

    card = card_line()
    print(card, flush=True)
    pretrain = args.model == "pretrain"
    dropout = args.dropout if args.dropout is not None else (
        0.0 if args.model == "retrieval" else 0.1)
    cfg = base_config(ModelConfig, "bfloat16", dropout)
    batch_size = TRAIN_B
    if args.model == "vqa":
        cfg = base_config(ModelConfig, "bfloat16", dropout,
                          num_labels=QA_ANSWERS, loss_type="bce")
        model = VQAModel(cfg, device="cuda", seed=0)
        batch_size = FT_B["vqa"]
        caps, imgs = bench_inputs(torch, cfg, batch_size, 1, 40, 20, 50,
                                  seed=5)
        caps["attention_mask_a"][1::2, 30:] = 0      # padded questions
        imgs["attention_mask_b"][1::2, 60:] = 0      # padded regions
        batch = {**caps, **imgs}
        g = torch.Generator(device="cuda").manual_seed(6)
        batch["label"] = (torch.rand(batch_size, QA_ANSWERS, device="cuda",
                                     generator=g) < 2e-3).float()

        def loss_fn(model, batch, gen):
            return model(*(batch[k] for k in (
                "input_ids_a", "attention_mask_a", "token_type_ids_a",
                "input_ids_b", "attention_mask_b", "token_type_ids_b",
                "img_feats")), labels=batch["label"], max_tag_length=20,
                generator=gen)
        lr = 5e-5
    elif pretrain:
        model = BiPretrainModel(cfg, device="cuda", seed=0)
        batch = pretrain_batch(torch, cfg, seed=7)
        loss_fn = pretrain_loss_fn(max_tag_length=20, hn_mod="hard",
                                   phrase_mod="sample")
        lr = 1e-4
    else:
        model = RetrievalModel(cfg, device="cuda", seed=0)
        batch = train_batch(torch, cfg, seed=5)
        loss_fn = retrieval_loss_fn(max_tag_length=20, hn_mod="hard")
        lr = 4e-5
    model.train()
    opt = make_optimizer(model, lr, schedule="constant", max_grad_norm=1.0)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def step():
        model.zero_grad(set_to_none=True)
        with record_function("forward"):
            loss, _ = loss_fn(model, batch, gen)
        with record_function("backward"):
            loss.backward()
        with record_function("optimizer"):
            opt.step()
        return loss

    for _ in range(STEPS_WARM):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS_PROF):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / STEPS_PROF * 1e3

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS_PROF):
            step()
        torch.cuda.synchronize()
        step_ms_prof = (time.perf_counter() - t0) / STEPS_PROF * 1e3
    # device events, without the ranges that mark the parts of the step
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and e.name not in PARTS]
    if not kernels:
        raise RuntimeError("torch.profiler recorded no device events")
    by_class, by_name = {}, {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        by_class[classify(e.name)] = by_class.get(classify(e.name), 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    # device time of the kernels launched under each host-side range; the
    # backward runs on autograd's threads, outside the "backward" range, so
    # it is what the forward and the optimizer leave of the kernels' total
    per_op = dict.fromkeys(("forward", "optimizer",
                            "attention backward (recompute)"), 0.0)
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        if e.name in ("forward", "optimizer"):
            per_op[e.name] += device_us(e)
        elif e.name == "MaskedAttentionFnBackward":
            per_op["attention backward (recompute)"] += device_us(e)
    start = min(e.time_range.start for e in prof.events())
    end = max(e.time_range.end for e in prof.events())
    window = end - start
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
    total_kernel = sum(by_class.values())
    per_op["backward"] = total_kernel - per_op["forward"] - per_op["optimizer"]
    n = STEPS_PROF
    out = {
        "card": card, "model": args.model, "dropout": dropout,
        "batch": batch_size, "steps_profiled": n,
        "step_ms_unprofiled": step_ms, "step_ms_profiled": step_ms_prof,
        "window_ms": window / 1e3, "device_busy_ms": busy / 1e3,
        "device_idle_share": 1.0 - busy / window,
        "device_ms_per_step_by_part": {k: v / 1e3 / n for k, v in
                                       per_op.items()},
        "kernel_ms_per_step_by_class": {k: v / 1e3 / n for k, v in sorted(
            by_class.items(), key=lambda kv: -kv[1])},
        "kernel_share_by_class": {k: v / total_kernel for k, v in sorted(
            by_class.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms_per_step": {k[:120]: v / 1e3 / n for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:15]},
    }
    print(json.dumps(out, indent=1), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
