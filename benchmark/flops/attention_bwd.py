"""The attention backward kernel's least time on the card, from a call's
shapes: q, k, v, the output, its gradient dO and the gradients dq, dk, dv
read or written once each, the bias tensor read once (as the caller passes
it), against 10 B H Lq Lk D operations (the recomputed q.k^T, dO.v^T, and
the products of dv, dq and dk) at the type's tensor-core peak, counted at
the head dim D itself; the larger of the two bounds it."""

from __future__ import annotations

from benchmark.flops.attention import PEAKS


def bound_s(b: int, h: int, lq: int, lk: int, d: int, dtype: str,
            bias_bytes: int) -> float:
    elem = 2 if dtype == "bfloat16" else 4
    nbytes = elem * b * h * d * (4 * lq + 4 * lk) + bias_bytes
    t_bytes = nbytes / PEAKS["hbm_bytes_per_s"]
    t_ops = (PEAKS["passes"][dtype] * 10.0 * b * h * lq * lk * d
             / PEAKS["flops_per_s"][dtype])
    return max(t_bytes, t_ops)
