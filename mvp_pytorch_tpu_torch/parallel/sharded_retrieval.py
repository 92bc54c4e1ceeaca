"""Corpus-scale coarse retrieval, row-sharded over the ranks: the JAX
package's `parallel/sharded_retrieval.py` in PyTorch.

The dense coarse stage (`tasks/retrieval.py` `two_stage_scoring`) builds the
whole [n_img, n_cap] similarity matrix, which is fine at Flickr scale and
impossible at corpus scale (100,000 x 500,000 in fp32 is 200 GB). This
module computes the same shortlists and coarse ranks with
- the gallery read in `block`-row tiles with a running top-k, so no more
  than [query_block, k + block] scores exist at once;
- the query rows split over the ranks (`sequential_shards`), each rank
  scoring its rows against the whole gallery; only the [rows, k] results
  are all-gathered.

Every score is the dot product the dense path computes (blocks tile the
gallery, not the contraction), so shortlists and ranks are exact on
tie-free inputs; ties at the k boundary go to the lowest gallery index, as
`lax.top_k` (and `models.cbs.top_k_lower_index`) orders them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..models.cbs import top_k_lower_index

QUERY_BLOCK = 8192


def streaming_topk(q: torch.Tensor, g: torch.Tensor, k: int, block: int,
                   query_block: int = QUERY_BLOCK
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top-k gallery scores of each query row without the whole
    similarity matrix: q [Nq, D], g [Ng, D], k <= Ng -> (scores [Nq, k],
    int64 ids [Nq, k]), descending, equal scores by the lower id."""
    ng = g.shape[0]
    if not 0 < k <= ng:
        raise ValueError(f"k {k} outside [1, {ng}]")
    vals_out, ids_out = [], []
    for r0 in range(0, q.shape[0], query_block):
        qb = q[r0:r0 + query_block]
        vals = ids = None
        for base in range(0, ng, block):
            s = (qb @ g[base:base + block].T).float()
            col = torch.arange(base, base + s.shape[1], device=q.device)
            col = col.expand(s.shape[0], -1)
            if vals is not None:     # carried ids are all below this block
                s = torch.cat([vals, s], 1)
                col = torch.cat([ids, col], 1)
            kk = min(k, s.shape[1])
            vals, pos = top_k_lower_index(s, kk)
            ids = col.gather(1, pos)
        vals_out.append(vals)
        ids_out.append(ids)
    return torch.cat(vals_out), torch.cat(ids_out)


def streaming_rank(q: torch.Tensor, g: torch.Tensor,
                   correct_ids: torch.Tensor, block: int,
                   query_block: int = QUERY_BLOCK) -> torch.Tensor:
    """0-based coarse rank of each query's best correct gallery item:
    #{incorrect j : s_j > max correct score}. `correct_ids` [Nq, C] are the
    gallery ids a query owns (C = captions per image for i2t, 1 for t2i).
    Equal to the first-correct position of `coarse_ranks` on tie-free
    scores; ties resolve optimistically. The correct items are excluded by
    id (the threshold comes from an einsum, the sweep from a block matmul:
    one dot product two ways can differ in the last bit): each block's
    count drops the correct ids that fall in it, read from the block's own
    scores, so no [rows, block, C] comparison is built. A query's correct
    ids are distinct."""
    ng = g.shape[0]
    out = []
    for r0 in range(0, q.shape[0], query_block):
        qb = q[r0:r0 + query_block]
        own_ids = correct_ids[r0:r0 + query_block]
        own = g[own_ids]                                    # [n, C, D]
        best = torch.einsum("nd,ncd->nc", qb, own).float().max(1).values
        count = torch.zeros(qb.shape[0], dtype=torch.int64, device=q.device)
        for base in range(0, ng, block):
            s = (qb @ g[base:base + block].T).float()
            above = s > best[:, None]
            # the correct items of this block, read from the same scores
            inside = (own_ids >= base) & (own_ids < base + s.shape[1])
            own_above = above.gather(
                1, (own_ids - base).clamp(0, s.shape[1] - 1)) & inside
            count += above.sum(1) - own_above.sum(1)
        out.append(count)
    return torch.cat(out)


def _ranks(group) -> Tuple[int, int]:
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _gather_rows(x: torch.Tensor, total: int, group) -> torch.Tensor:
    _, world = _ranks(group)
    if world == 1:
        return x[:total]
    out = x.new_empty((world * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out[:total]


def sharded_coarse_eval(img_glob, txt_glob, caps_per_img: int, k_i2t: int,
                        k_t2i: int, block: int = 4096, group=None,
                        query_block: int = QUERY_BLOCK):
    """The corpus-scale coarse stage: rerank shortlists and coarse ranks in
    both directions, query rows split over the ranks of `group` (default:
    every rank), the gallery read in `block`-row tiles. img_glob [n_img, D]
    and txt_glob [n_cap, D] are tensors on the rank's device (every rank
    holds both). Returns numpy (i2t_cands [n_img, k_i2t], t2i_cands [n_cap,
    k_t2i], i2t_ranks [n_img], t2i_ranks [n_cap]): `coarse_candidates` and
    `coarse_ranks` of `tasks/retrieval_eval.py` up to tie order."""
    img_glob = torch.as_tensor(img_glob)
    txt_glob = torch.as_tensor(txt_glob, device=img_glob.device)
    dev = img_glob.device
    n_img, n_cap = img_glob.shape[0], txt_glob.shape[0]
    rank, world = _ranks(group)

    def rows(n):             # this rank's query rows, wrap-padded
        per = -(-n // world)
        return torch.arange(rank * per, (rank + 1) * per, device=dev) % n

    ri, rc = rows(n_img), rows(n_cap)
    own_caps = (ri[:, None] * caps_per_img
                + torch.arange(caps_per_img, device=dev)[None, :])
    own_img = (rc // caps_per_img)[:, None]
    _, i2t = streaming_topk(img_glob[ri], txt_glob, k_i2t, block,
                            query_block)
    _, t2i = streaming_topk(txt_glob[rc], img_glob, k_t2i, block,
                            query_block)
    i2t_r = streaming_rank(img_glob[ri], txt_glob, own_caps, block,
                           query_block)
    t2i_r = streaming_rank(txt_glob[rc], img_glob, own_img, block,
                           query_block)
    return tuple(_gather_rows(x, n, group).cpu().numpy()
                 for x, n in ((i2t, n_img), (t2i, n_cap), (i2t_r, n_img),
                              (t2i_r, n_cap)))


__all__ = ["streaming_topk", "streaming_rank", "sharded_coarse_eval"]
