"""Corpus-scale ingest rehearsal: the JAX package's
`tools_tpu/scale_ingest.py` on this package's data plane and its process
loader.

The reference's operating regime is multi-dataset chunked feature TSVs at
millions of pairs (`oscar/oscar_datasets_ml/oscar_tsv4.py:44-100`: chunk
selection over ~0.5 MB base64 feature rows). `generate` writes a synthetic
chunked corpus of that row size at any scale, byte for byte the JAX tool's
from the same arguments; `rehearse` streams it through the real ingest
stack (`MultiCorpusPretrainDataset.from_yaml` -> tensorize and mask ->
`ProcessLoader` -> tensors on the device) and checks four things:

(a) partition: the chunks tile the pair space exactly once
    (`len(ds) == n_images * caps_per_img`);
(b) chunk selection: each chunk's first pair is served from that chunk (the
    fingerprint `img_feat[0, 0] == chunk index` planted by `generate`);
(c) memory: the resident memory of the loader (this process and its worker
    processes) grows by less than `rss_bound_mb` while it streams;
(d) resume: a loader restarted with `start_step=resume_at` yields the
    straight run's next 4 batches bit for bit.

It reports ingest examples/s and, against a device's measured demand in
examples/s when one is given, the feed ratio.

    python -m mvp_pytorch_tpu_torch.tools.scale_ingest --gb 4 --chunks 4 \
        --steps 40 [--workers 4] [--device_demand_ex_s N] [--platform cpu]

Batches go to the card unless `--platform cpu`.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import random
import shutil
import tempfile
import time
from typing import Optional

import numpy as np
import torch

# (c)'s allowance beyond the loader's slots: the JAX package's test bound
# (tests/test_scale_ingest.py) for what a loader holds besides its batches
# in flight (tokenizer, corpus index, allocator slack), none of it scaling
# with the bytes streamed
RSS_ALLOWANCE_MB = 400.0
RESUME_BATCHES = 4


def _status_kb(pid: int, key: str) -> int:
    with open(f"/proc/{pid}/status") as f:
        for line in f:
            if line.startswith(key + ":"):
                return int(line.split()[1])
    return 0


def loader_rss_mb(worker_pids) -> float:
    """The resident memory of this process and its loader's workers, in MB.
    A worker's shared-memory slots are mapped by this process too, so they
    are counted once, here: a worker adds its RSS outside shared memory."""
    kb = _status_kb(os.getpid(), "VmRSS")
    for pid in worker_pids:
        try:
            kb += _status_kb(pid, "VmRSS") - _status_kb(pid, "RssShmem")
        except FileNotFoundError:   # a worker that has exited
            pass
    return kb / 1024.0


def generate(root: str, total_gb: float = 4.0, chunks: int = 4,
             regions: int = 50, feature_dim: int = 2054,
             caps_per_img: int = 5, seed: int = 0) -> dict:
    """Write a chunked pretraining corpus of about `total_gb` feature bytes.

    The layout of the reference's multi-corpus yaml: one corpus TSV
    (caption and QA rows) over all images, and `chunks` feature TSVs over
    disjoint image subsets, rows of `regions` x `feature_dim` fp32 in base64
    (~0.5 MB at the defaults). Chunk c's rows carry c at `feature[0, 0]` and
    the row's index at `feature[0, 1]`. Returns the paths (yaml, corpus,
    chunks, vocab), `n_images`, `caps_per_img`, `feature_gb` and the
    seconds taken."""
    from ..data.synthetic import TAGS, random_caption, write_vocab
    from ..data.tsv import tsv_writer

    os.makedirs(root, exist_ok=True)
    row_bytes = regions * feature_dim * 4 * 4 // 3      # base64 expansion
    n_images = max(chunks, int(total_gb * (1 << 30)) // row_bytes)
    n_images -= n_images % chunks
    image_ids = [f"big_{i:07d}" for i in range(n_images)]
    vocab_path = os.path.join(root, "vocab.txt")
    write_vocab(vocab_path)
    rng = np.random.RandomState(seed)
    prng = random.Random(seed)

    # one base feature block a chunk, the fingerprints the only per-row
    # change: rows stay distinct without drawing every row anew
    chunk_paths = []
    per_chunk = n_images // chunks
    t0 = time.time()
    for c in range(chunks):
        cdir = os.path.join(root, f"features_chunk{c}")
        os.makedirs(cdir, exist_ok=True)
        ids = image_ids[c * per_chunk:(c + 1) * per_chunk]
        base = rng.randn(regions, feature_dim).astype(np.float32)
        # a valid box in the trailing 6 dims
        x1 = rng.uniform(0, 0.5, (regions, 1))
        y1 = rng.uniform(0, 0.5, (regions, 1))
        x2 = x1 + rng.uniform(0.1, 0.5, (regions, 1))
        y2 = y1 + rng.uniform(0.1, 0.5, (regions, 1))
        base[:, -6:] = np.concatenate(
            [x1, y1, x2, y2, x2 - x1, y2 - y1], 1).astype(np.float32)

        def rows(ids=ids, base=base, c=c):
            feats = base.copy()
            for j, img in enumerate(ids):
                feats[0, 0] = float(c)          # chunk fingerprint
                feats[0, 1] = float(j)          # row fingerprint
                tags = [TAGS[(j + k) % len(TAGS)] for k in range(3)]
                yield [img, json.dumps({
                    "feature": base64.b64encode(feats.tobytes()).decode(),
                    "predictions": tags})]

        path = os.path.join(cdir, "predictions.tsv")
        tsv_writer(rows(), path)
        with open(os.path.join(cdir, "imageid2idx.json"), "w") as f:
            json.dump({img: i for i, img in enumerate(ids)}, f)
        chunk_paths.append(path)

    corpus_path = os.path.join(root, "corpus.tsv")

    def corpus_rows():
        for img in image_ids:
            for j in range(caps_per_img):
                if j % 2 == 1:
                    yield [img, "the picture shows a", "[]",
                           prng.randrange(7), prng.choice(TAGS)]
                else:
                    yield [img, random_caption(prng), "[]",
                           prng.randrange(7), ""]

    tsv_writer(corpus_rows(), corpus_path)

    yaml_path = os.path.join(root, "corpus.yaml")
    with open(yaml_path, "w") as f:
        f.write("corpora:\n  - name: big\n"
                f"    corpus_tsv: {corpus_path}\n"
                "    feature_tsv:\n")
        for p in chunk_paths:
            f.write(f"      - {p}\n")
    gb = sum(os.path.getsize(p) for p in chunk_paths) / (1 << 30)
    return {"yaml": yaml_path, "corpus": corpus_path, "vocab": vocab_path,
            "chunks": chunk_paths, "n_images": n_images,
            "caps_per_img": caps_per_img, "feature_gb": round(gb, 2),
            "gen_s": round(time.time() - t0, 1)}


def _host(batch) -> dict:
    return {k: v.to("cpu", copy=True) for k, v in batch.items()}


def _bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().view(torch.uint8),
                            b.contiguous().view(torch.uint8)))


def rehearse(paths: dict, batch: int = 96, steps: int = 40,
             resume_at: Optional[int] = None, workers: int = 2,
             device="cuda", device_demand_ex_s: Optional[float] = None
             ) -> dict:
    """Stream `steps` batches of `batch` pairs from `generate`'s corpus
    through `ProcessLoader` with `workers` forked workers onto `device`,
    after one warm batch a worker, and check (a)-(c) of the module's
    docstring, and (d) when `resume_at` is given. A failed check raises
    `AssertionError`. Returns the measurements; `feed_ratio` is the ingest
    rate over `device_demand_ex_s`, None without a demand."""
    from ..data.datasets import MultiCorpusPretrainDataset
    from ..data.loader import SLOTS_PER_WORKER, BatchSampler, ProcessLoader
    from ..data.tokenization import FastBertTokenizer
    from ..models.layers import resolve_device

    device = resolve_device(device)
    tok = FastBertTokenizer(paths["vocab"])
    # mask_visual off: (b) reads feature [0, 0], which the random visual
    # masking would sometimes zero
    ds = MultiCorpusPretrainDataset.from_yaml(paths["yaml"], tok, seed=0,
                                              qa_pairs=True,
                                              mask_visual=False)
    total_pairs = paths["n_images"] * paths["caps_per_img"]
    # (a) N chunks over one corpus tile the pair space once: a chunk that
    # took every corpus row would multiply len()
    if len(ds) != total_pairs:
        raise AssertionError(f"(a) partition: {len(ds)} pairs, want "
                             f"{total_pairs}")
    # (b) the first pair of chunk c carries chunk c's fingerprint
    per_chunk_pairs = total_pairs // len(paths["chunks"])
    for c in range(len(paths["chunks"])):
        got = float(ds[c * per_chunk_pairs]["img_feat"][0, 0])
        if got != float(c):
            raise AssertionError(f"(b) chunk selection: chunk {c}'s first "
                                 f"pair has fingerprint {got}")

    def loader(start_step=0):
        return ProcessLoader(ds.fetch, BatchSampler(len(ds), batch, seed=0),
                             device=device, start_step=start_step,
                             num_workers=workers)

    # streaming: RSS and throughput, keeping nothing (the resume check below
    # holds batches, which would read as growth)
    rss0 = loader_rss_mb(())
    stream = loader()
    it = iter(stream)
    try:
        for _ in range(workers):           # every worker's first batch
            _, first = next(it)
        pids = stream.worker_pids()
        batch_bytes = sum(v.numel() * v.element_size()
                          for v in first.values())
        del first
        rss_start = rss_peak = loader_rss_mb(pids)
        t0 = time.perf_counter()
        for i in range(steps):
            next(it)
            if (i + 1) % 10 == 0:
                rss_peak = max(rss_peak, loader_rss_mb(pids))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        rss_end = loader_rss_mb(pids)
    finally:
        it.close()
    rss_peak = max(rss_peak, rss_end)
    # (c) the loader's fixed memory is its slots: SLOTS_PER_WORKER shared
    # buffers of one batch for each worker; beyond them RSS_ALLOWANCE_MB
    slot_mb = SLOTS_PER_WORKER * workers * batch_bytes / (1 << 20)
    bound_mb = slot_mb + RSS_ALLOWANCE_MB
    if rss_peak - rss_start >= bound_mb:
        raise AssertionError(f"(c) memory: RSS grew {rss_peak - rss_start:.1f}"
                             f" MB while streaming, bound {bound_mb:.1f} MB")
    row_mb = (os.path.getsize(paths["chunks"][0]) / (1 << 20)
              / (paths["n_images"] / len(paths["chunks"])))
    ex_s = steps * batch / dt
    out = {
        "steps": steps, "batch": batch, "workers": workers,
        "device": str(device),
        "ingest_ex_s": round(ex_s, 1),
        "streamed_gb": round(steps * batch * row_mb / 1024, 2),
        "batch_bytes": batch_bytes,
        "rss_before_mb": round(rss0, 1),
        "rss_start_mb": round(rss_start, 1),
        "rss_end_mb": round(rss_end, 1),
        "rss_peak_mb": round(rss_peak, 1),
        "rss_growth_mb": round(rss_peak - rss_start, 1),
        "slot_mb": round(slot_mb, 1),
        "rss_bound_mb": round(bound_mb, 1),
        "device_demand_ex_s": device_demand_ex_s,
        "feed_ratio": (None if device_demand_ex_s is None
                       else round(ex_s / device_demand_ex_s, 2)),
    }

    if resume_at is not None:
        # (d) a straight run to resume_at + RESUME_BATCHES keeps its last
        # batches; a fresh loader from resume_at must repeat them
        kept = {}
        it = iter(loader())
        try:
            for step, b in it:
                if step >= resume_at:
                    kept[step] = _host(b)
                if len(kept) == RESUME_BATCHES:
                    break
        finally:
            it.close()
        checked = 0
        it = iter(loader(start_step=resume_at))
        try:
            for step, b in it:
                want = kept.get(step)
                if want is None or sorted(b) != sorted(want):
                    raise AssertionError(f"(d) resume: step {step} is not "
                                         f"one of {sorted(kept)}")
                got = _host(b)
                bad = [k for k in got if not _bit_equal(got[k], want[k])]
                if bad:
                    raise AssertionError(f"(d) resume: step {step} differs "
                                         f"in {bad}")
                checked += 1
                if checked == RESUME_BATCHES:
                    break
        finally:
            it.close()
        out["resume_bit_exact_steps"] = checked
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="generate a chunked corpus and rehearse its ingest")
    p.add_argument("--root",
                   default=os.path.join(tempfile.gettempdir(), "scale_ingest"))
    p.add_argument("--gb", type=float, default=4.0)
    p.add_argument("--chunks", type=int, default=4)
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--batch", type=int, default=96)
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--keep", action="store_true",
                   help="keep the generated corpus on disk")
    p.add_argument("--platform", choices=("cpu",), default=None,
                   help="cpu: batches stay on the CPU (default: the card)")
    p.add_argument("--device_demand_ex_s", type=float, default=None,
                   help="the device's measured demand in examples/s (e.g. "
                        "the pretraining step's samples/s); feed_ratio is "
                        "null without it")
    args = p.parse_args(argv)
    device = "cpu" if args.platform == "cpu" else "cuda"
    try:
        paths = generate(args.root, total_gb=args.gb, chunks=args.chunks)
        print(json.dumps({"generated": paths["feature_gb"],
                          "n_images": paths["n_images"],
                          "gen_s": paths["gen_s"]}), flush=True)
        res = rehearse(paths, batch=args.batch, steps=args.steps,
                       resume_at=args.steps // 2, workers=args.workers,
                       device=device,
                       device_demand_ex_s=args.device_demand_ex_s)
        print(json.dumps(res), flush=True)
    finally:
        if not args.keep:
            shutil.rmtree(args.root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
