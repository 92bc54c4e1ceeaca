"""The attention kernel's least time on the card, from a call's shapes:
q, k, v and the output read or written once, the bias tensor read once
(as the caller passes it, before any broadcast), against 4 B H Lq Lk D
operations a pass at the type's tensor-core peak; the larger of the two
bounds it. The dropout mask's hash is left out."""

from __future__ import annotations

import json
import os

PEAKS = json.load(open(os.path.join(os.path.dirname(__file__),
                                    "peaks.json")))


def bound_s(b: int, h: int, lq: int, lk: int, d: int, dtype: str,
            bias_bytes: int) -> float:
    elem = 2 if dtype == "bfloat16" else 4
    nbytes = elem * h * d * b * (2 * lq + 2 * lk) + bias_bytes
    t_bytes = nbytes / PEAKS["hbm_bytes_per_s"]
    t_ops = (PEAKS["passes"][dtype] * 4.0 * b * h * lq * lk * d
             / PEAKS["flops_per_s"][dtype])
    return max(t_bytes, t_ops)
