"""Two-stage retrieval sweeps through the program's `two_stage_scoring`.

Set-up loads the benchmark's seeded weights into the program's
`RetrievalModel` and draws a pool of `pool` test splits (galleries) on the
card; one sweep of the first is the warm-up. The window sweeps the pool in
turn until `--seconds` have passed; every sweep's candidate lists and
rerank scores are kept.

The check draws, from the seed, `check_pairs` of the window's scored pairs
and `check_rows` of its images and of its captions, and recomputes them
with the plain reference's own encoders:
- `cand_gap`: for each drawn image (caption), how far the reference's
  similarity of the worst caption (image) the program shortlisted lies below
  the reference's own k-th best, as a share of the row's range of
  similarities;
- `score_gap`: for each drawn pair, the gap between the program's rerank
  score, P(match) of the ITM head, and the reference's.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import generate, weights
from benchmark.reference import family as ref_family
from benchmark.reference.common import Numerics, Stream, no_tf32


class Driver:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed = cell, seed
        self.device = torch.device(device)
        self.cfg, self.tr = cell.config, cell.traffic
        self.notes: List[str] = []
        self.extra: dict = {}
        self.detail: dict = {}

    def setup(self) -> None:
        from mvp_pytorch_tpu_torch.models.config import ModelConfig
        from mvp_pytorch_tpu_torch.models.tasks import RetrievalModel
        cfg, tr, dev = self.cfg, self.tr, self.device
        no_tf32()
        self.ref = ref_family(cfg["family"])
        self.W = weights.make(self.ref.param_spec(cfg, "retrieval"), cfg,
                              self.seed, dev)
        self.model = RetrievalModel(ModelConfig.from_dict(cfg), device=dev)
        self.model.load_state_dict(self.W, strict=True)
        g = torch.Generator(device=dev).manual_seed(self.seed + 1)
        self.galleries = [generate.gallery(cfg, tr, g, dev)
                          for _ in range(tr["pool"])]
        self.sweeps: list = []
        self._sweep(0)
        self.sweeps.clear()

    def _sweep(self, gi: int) -> dict:
        from mvp_pytorch_tpu_torch.tasks.retrieval import two_stage_scoring
        tr = self.tr
        caps, imgs = self.galleries[gi]
        res = two_stage_scoring(
            self.model, caps, imgs, tr["captions_per_image"], tr["k_i2t"],
            tr["k_t2i"], tr["enc_batch"], tr["pair_batch"],
            max_tag_length=tr["tag_len"])
        self.sweeps.append((gi, res))
        return res

    def window(self, seconds: float):
        n, failed, pairs = 0, 0, 0
        t0 = time.perf_counter()
        while True:
            res = self._sweep(n % len(self.galleries))
            n += 1
            pairs += res["n_pairs"]
            failed += not bool(np.isfinite(res["scores"]).all())
            if time.perf_counter() - t0 >= seconds:
                break
        dt = time.perf_counter() - t0
        each = " ".join(f"{sum(r['seconds'].values()):.3f}"
                        for _, r in self.sweeps)
        self.notes.append(f"window {n} sweeps in {dt:.3f} s; sweep s {each}")
        self.extra.update(
            flops_per_sweep=self.cell.flops().score_sweep(self.cfg, self.tr),
            rerank_s=[r["seconds"]["rerank"] for _, r in self.sweeps])
        return ({"score_pairs_per_s": pairs / dt},
                {"seconds": dt, "units": n, "attempted": n,
                 "failed": failed})

    def traced(self):
        from benchmark.trace import Tracer
        n = self.tr["trace_sweeps"]
        done = len(self.sweeps)
        with Tracer() as tr:
            for i in range(n):
                self._sweep((done + i) % len(self.galleries))
        return tr.summary(n)

    def memory_peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def free(self) -> None:
        del self.model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # --------------------------------------------------------------- check
    def _draws(self):
        """(pairs, image rows, caption rows) drawn from the seed: lists of
        (sweep index, row)."""
        tr = self.tr
        rng = np.random.default_rng(self.seed)
        n_img = tr["images"]
        n_cap = n_img * tr["captions_per_image"]
        n_pairs = self.sweeps[0][1]["n_pairs"]
        s = len(self.sweeps)

        def draw(n_rows, k):
            flat = rng.choice(s * n_rows, size=min(k, s * n_rows),
                              replace=False)
            return [(int(f // n_rows), int(f % n_rows)) for f in flat]
        return (draw(n_pairs, tr["check_pairs"]),
                draw(n_img, tr["check_rows"]), draw(n_cap, tr["check_rows"]))

    def _pair(self, res, j):
        tr = self.tr
        n_img, ki, kt = tr["images"], tr["k_i2t"], tr["k_t2i"]
        if j < n_img * ki:
            img = j // ki
            return int(res["i2t_cands"][img, j % ki]), img
        j -= n_img * ki
        cap = j // kt
        return cap, int(res["t2i_cands"][cap, j % kt])

    @torch.no_grad()
    def _encode(self, model, gi, num_need):
        """The reference's globals of every caption and image of gallery
        `gi`, and the sequences of the rows in `num_need` (caption ids,
        image ids)."""
        tr, bs = self.tr, self.tr["enc_batch"]
        caps, imgs = self.galleries[gi]
        st = Stream(None, 0.0, 0.0, torch.float32)
        need_c, need_i = num_need
        t_glob, t_seq = [], {}
        for i in range(0, caps["input_ids_a"].shape[0], bs):
            seq, g = model.encode_text(caps["input_ids_a"][i:i + bs],
                                       caps["attention_mask_a"][i:i + bs],
                                       caps["token_type_ids_a"][i:i + bs], st)
            t_glob.append(g)
            for c in need_c:
                if i <= c < i + bs:
                    t_seq[c] = seq[c - i]
        v_glob, v_seq = [], {}
        t = tr["tag_len"]
        for i in range(0, imgs["input_ids_b"].shape[0], bs):
            seq, g = model.encode_image(imgs["input_ids_b"][i:i + bs],
                                        imgs["attention_mask_b"][i:i + bs],
                                        imgs["token_type_ids_b"][i:i + bs],
                                        imgs["img_feats"][i:i + bs], st)
            v_glob.append(g)
            for c in need_i:
                if i <= c < i + bs:
                    v_seq[c] = seq[c - i, t:]
        return torch.cat(t_glob), torch.cat(v_glob), t_seq, v_seq

    def _outputs(self, precision: str):
        """The reference's similarities of the drawn rows and its scores of
        the drawn pairs, computed in `precision`."""
        cfg, tr = self.cfg, self.tr
        model = self.ref.TwoStream(self.W, cfg, Numerics(precision))
        pairs, img_rows, cap_rows = self._draws()
        k_i2t, k_t2i = tr["k_i2t"], tr["k_t2i"]
        per_gallery: Dict[int, tuple] = {}
        for si, _ in pairs + img_rows + cap_rows:
            gi = self.sweeps[si][0]
            per_gallery.setdefault(gi, (set(), set()))
        for si, j in pairs:
            gi, res = self.sweeps[si]
            c, i = self._pair(res, j)
            per_gallery[gi][0].add(c)
            per_gallery[gi][1].add(i)
        enc = {gi: self._encode(model, gi, need)
               for gi, need in per_gallery.items()}
        t = tr["tag_len"]
        out = {"i2t": {}, "t2i": {}, "score": {}}
        for si, row in img_rows:
            gi = self.sweeps[si][0]
            sims = enc[gi][1][row] @ enc[gi][0].t()
            out["i2t"][(si, row)] = sims
        for si, row in cap_rows:
            gi = self.sweeps[si][0]
            out["t2i"][(si, row)] = enc[gi][0][row] @ enc[gi][1].t()
        for si, j in pairs:
            gi, res = self.sweeps[si]
            c, i = self._pair(res, j)
            caps, imgs = self.galleries[gi]
            out["score"][(si, j)] = (
                enc[gi][2][c], caps["attention_mask_a"][c],
                enc[gi][3][i], imgs["attention_mask_b"][i, t:])
        keys = list(out["score"])
        scores = {}
        for a in range(0, len(keys), tr["pair_batch"]):
            chunk = keys[a:a + tr["pair_batch"]]
            cols = list(zip(*(out["score"][k] for k in chunk)))
            s = model.itm_scores(*(torch.stack(c) for c in cols))
            scores.update(zip(chunk, s.float().cpu().tolist()))
        out["score"] = scores
        out["k"] = (k_i2t, k_t2i)
        return out

    @staticmethod
    def _cand_gap(sims: torch.Tensor, cands, k: int) -> float:
        """How far the worst shortlisted item's reference similarity lies
        below the reference's k-th best, as a share of the row's range of
        similarities (0: the shortlist is the reference's top k)."""
        kth = torch.topk(sims, k).values[-1]
        worst = sims[torch.as_tensor(cands, device=sims.device)].min()
        span = (sims.max() - sims.min()).clamp(min=1e-30)
        return max(0.0, float((kth - worst) / span))

    def numbers(self, ref, answers) -> Dict[str, float]:
        """Gaps of `answers` ({"i2t": {(sweep, image): cands}, "t2i": ...,
        "score": {(sweep, pair): score}}) against the reference's `ref`."""
        k_i2t, k_t2i = ref["k"]
        gaps = [self._cand_gap(ref["i2t"][key], answers["i2t"][key], k_i2t)
                for key in ref["i2t"]]
        gaps += [self._cand_gap(ref["t2i"][key], answers["t2i"][key], k_t2i)
                 for key in ref["t2i"]]
        score = max(abs(answers["score"][key] - v)
                    for key, v in ref["score"].items())
        return {"cand_gap": max(gaps), "score_gap": score}

    def program_answers(self, ref) -> dict:
        ans = {"i2t": {}, "t2i": {}, "score": {}}
        for si, row in ref["i2t"]:
            ans["i2t"][(si, row)] = self.sweeps[si][1]["i2t_cands"][row]
        for si, row in ref["t2i"]:
            ans["t2i"][(si, row)] = self.sweeps[si][1]["t2i_cands"][row]
        for si, j in ref["score"]:
            ans["score"][(si, j)] = float(self.sweeps[si][1]["scores"][j])
        return ans

    @staticmethod
    def own_answers(out) -> dict:
        """A reference's own shortlists and scores, as answers."""
        k_i2t, k_t2i = out["k"]
        return {"i2t": {key: torch.topk(s, k_i2t).indices.cpu().numpy()
                        for key, s in out["i2t"].items()},
                "t2i": {key: torch.topk(s, k_t2i).indices.cpu().numpy()
                        for key, s in out["t2i"].items()},
                "score": dict(out["score"])}

    def check(self) -> Dict[str, float]:
        self.ref32 = self._outputs("float32")
        return self.numbers(self.ref32, self.program_answers(self.ref32))

    def control(self) -> Dict[str, float]:
        """The same numbers with the reference in float8 in the program's
        place (after `check`): its own shortlists, and its scores of the
        drawn pairs."""
        return self.numbers(self.ref32,
                            self.own_answers(self._outputs("float8")))
