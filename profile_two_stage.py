#!/usr/bin/env python3
"""Where the time of the port's two-stage retrieval sweep goes, on the card.

    python3 profile_two_stage.py

Builds MVPTR-base (bf16, seeded random weights) as chip_smoke.py does, warms
up, then runs `two_stage_scoring` once at the bench geometry under
torch.profiler. Prints the device time by kernel class (the attention kernel,
matrix products, LayerNorm, other elementwise, gathers and copies, the rest),
the top kernels, and the device's busy and idle share of the profiled window,
as one JSON object.
"""

from __future__ import annotations

import json
import os
import sys
import time

CLASSES = (   # first match wins, on the lower-cased kernel name
    ("attention (masked_attention_fwd)", ("masked_attention",)),
    ("matmul", ("gemm", "nvjet", "cutlass", "xmma", "sm90_")),
    ("layer_norm", ("layer_norm",)),
    ("gather / cat / copy", ("index", "gather", "catarray", "copy",
                             "embedding")),
    ("elementwise", ("elementwise", "gelu", "tanh")),
)


def classify(name: str) -> str:
    low = name.lower()
    for label, keys in CLASSES:
        if any(k in low for k in keys):
            return label
    return "other"


def busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("profile_two_stage: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from chip_smoke import base_config, bench_inputs, card_line
    from mvp_pytorch_tpu_torch.models import ModelConfig, RetrievalModel
    from mvp_pytorch_tpu_torch.tasks.retrieval import two_stage_scoring

    card = card_line()
    print(card, flush=True)
    cpi, la, t, r = 5, 75, 20, 50
    cfg = base_config(ModelConfig, "bfloat16")
    model = RetrievalModel(cfg, device="cuda", seed=0)
    caps, imgs = bench_inputs(torch, cfg, 1000, cpi, la, t, r)
    run = lambda: two_stage_scoring(model, caps, imgs, cpi, 20, 10, 500, 1000,  # noqa: E731
                                    max_tag_length=t)
    run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    plain_res = run()
    wall_plain = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run()
        wall_prof = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("torch.profiler recorded no device events")
    by_class, by_name = {}, {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        by_class[classify(e.name)] = by_class.get(classify(e.name), 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    start = min(e.time_range.start for e in prof.events())
    end = max(e.time_range.end for e in prof.events())
    window = end - start
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
    total_kernel = sum(by_class.values())
    out = {
        "card": card, "n_pairs": res["n_pairs"],
        "stage_seconds_unprofiled": plain_res["seconds"],
        "wall_s_unprofiled": wall_plain, "wall_s_profiled": wall_prof,
        "peak_memory_gb": peak_gb,
        "window_ms": window / 1e3, "device_busy_ms": busy / 1e3,
        "device_idle_share": 1.0 - busy / window,
        "kernel_ms_by_class": {k: v / 1e3 for k, v in sorted(
            by_class.items(), key=lambda kv: -kv[1])},
        "kernel_share_by_class": {k: v / total_kernel for k, v in sorted(
            by_class.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms": {k[:120]: v / 1e3 for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:15]},
    }
    print(json.dumps(out, indent=1), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
