"""Concurrent load test of the serving endpoint: the port's counterpart of
`tools_tpu/load_test_serve.py`.

Builds a synthetic MLM serving checkpoint and feature store
(`build_assets`), starts `tasks/serve.py`'s server in-process on them, fires
concurrent single-pair /v1/mlm requests from T client threads
(`run_load`), and reports throughput, p50/p99 latency and the server's
batching stats, with micro-batching on (`--max_batch`, `--batch_wait_ms`)
and then off (`max_batch` 1).

    python -m mvp_pytorch_tpu_torch.tools.load_test_serve [--requests 200] \\
        [--threads 16] [--device cuda|cpu] [--hidden 32] [--layers 4]

It runs on the card unless `--device cpu`, and raises without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import threading
import time
import urllib.request
from typing import List, Optional

import torch

CHECKED = 16        # requests whose answers `main` keeps, by request index
TEXT = "two [MASK] are playing"     # every request's text


def build_assets(tmp, *, hidden=32, layers=4, dtype="float32",
                 store_bf16=False, vocab_extra=20,
                 max_position_embeddings=128, vocab_rows=None, seed=0):
    """A synthetic MLM serving checkpoint (`config.json`,
    `pytorch_model.bin`, `vocab.txt` under `tmp/model`) and the synthetic
    root's feature store, with the JAX tool's knobs. `store_bf16` saves the
    fp32 weights as bf16 (half the file and the upload; compute follows
    `dtype` either way). `vocab_rows` pads the vocab file to N rows (30,522:
    the BERT wordpiece vocabulary; the synthetic words keep their ids) so
    that the embedding table and the tied LM head are the flagship's size;
    the model has `vocab_extra` rows past the vocabulary. The weights are
    drawn from a `torch.Generator` seeded with `seed` (the JAX tool's
    `host_init` has no counterpart: torch initialises on the host, then
    moves the model). Returns (model dir, the synthetic root's paths, the
    vocabulary size)."""
    from ..data.synthetic import make_synthetic_root
    from ..data.tokenization import FastBertTokenizer
    from ..models import MLMModel, ModelConfig
    from ..training.checkpoint import WEIGHTS_NAME

    paths = make_synthetic_root(os.path.join(tmp, "synth"))
    vocab_path = paths["vocab"]
    if vocab_rows:
        with open(vocab_path) as f:
            lines = f.read().splitlines()
        if len(lines) < vocab_rows:
            lines += [f"unused{i:05d}"
                      for i in range(vocab_rows - len(lines))]
        vocab_path = os.path.join(tmp, "vocab_flagship.txt")
        with open(vocab_path, "w") as f:
            f.write("\n".join(lines) + "\n")
    tok = FastBertTokenizer(vocab_path)
    # 64-wide heads (at least 4), rounded down to a divisor of `hidden`
    heads = max(4, hidden // 64)
    while hidden % heads:
        heads -= 1
    cfg = ModelConfig(vocab_size=tok.vocab_size + vocab_extra,
                      only_word_size=tok.vocab_size, hidden_size=hidden,
                      num_hidden_layers=layers, num_attention_heads=heads,
                      intermediate_size=hidden * 4,
                      max_position_embeddings=max_position_embeddings,
                      img_feature_dim=2054, hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0, dtype=dtype)
    model = MLMModel(cfg, device="cpu", seed=seed)
    state = {k: (v.to(torch.bfloat16) if store_bf16 and v.dtype ==
                 torch.float32 else v) for k, v in model.state_dict().items()}
    mdir = os.path.join(tmp, "model")
    os.makedirs(mdir, exist_ok=True)
    cfg.save_pretrained(mdir)
    torch.save(state, os.path.join(mdir, WEIGHTS_NAME))
    tok.save_pretrained(mdir)
    return mdir, paths, tok.vocab_size


def request_image(i: int) -> str:
    """The image of request `i`."""
    return f"img_{i % 8:04d}"


def serving_args(mdir, paths, device) -> argparse.Namespace:
    """`tasks/serve.py`'s settings for the mlm mode over `build_assets`'
    model dir and synthetic paths."""
    return argparse.Namespace(
        model_dir=mdir, modes="mlm", feature_tsv=paths["features"],
        od_model=None, id2phrase=paths["id2phrase"], img_feature_dim=2054,
        max_seq_length=30, max_img_seq_length=50, max_tag_length=20,
        max_phrases=5, device=device)


def run_load(base, n, threads, answers: Optional[List] = None):
    """`n` single-pair /v1/mlm requests (`request_image(i)`, `TEXT`) from
    `threads` client threads; throughput and latency percentiles. With
    `answers` (a list of n entries) each request's answer lands at its
    index."""
    lat = []
    lock = threading.Lock()
    idx = [0]
    errors = []

    def worker():
        while True:
            with lock:
                if idx[0] >= n:
                    return
                i = idx[0]
                idx[0] += 1
            t0 = time.perf_counter()
            try:
                req = urllib.request.Request(
                    f"{base}/v1/mlm",
                    data=json.dumps({"image": request_image(i),
                                     "text": TEXT}).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=120) as r:
                    got = json.loads(r.read())
            except Exception as e:  # noqa: BLE001 - counted, and reported
                errors.append(str(e))
                continue
            with lock:
                lat.append(time.perf_counter() - t0)
                if answers is not None:
                    answers[i] = got.get("result")

    t0 = time.perf_counter()
    ts = [threading.Thread(target=worker) for _ in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    wall = time.perf_counter() - t0
    lat.sort()
    return dict(requests=len(lat), errors=len(errors), wall_s=round(wall, 2),
                rps=round(len(lat) / wall, 1),
                p50_ms=round(lat[len(lat) // 2] * 1e3, 1),
                p99_ms=round(lat[int(len(lat) * 0.99) - 1] * 1e3, 1))


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--requests", type=int, default=200)
    p.add_argument("--threads", type=int, default=16)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cpu runs the plain PyTorch path; cuda raises "
                        "without a card")
    p.add_argument("--hidden", type=int, default=32)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--max_batch", type=int, default=16)
    p.add_argument("--batch_wait_ms", type=float, default=5.0)
    return p.parse_args(argv)


def main(argv=None, assets=None) -> dict:
    """Batched, then unbatched, load over `assets` ((model dir, synthetic
    paths) of `build_assets`; built at --hidden / --layers in a temporary
    dir when None, bf16 on the card and fp32 on the CPU). Prints and returns
    {mode: run_load's numbers + batches, max_batch_seen and the answers of
    the first CHECKED requests}."""
    from ..models.layers import resolve_device
    from ..tasks import serve
    args = get_args(argv)
    resolve_device(args.device)         # no card for cuda raises here
    with tempfile.TemporaryDirectory() as tmp:
        if assets is None:
            mdir, paths, _ = build_assets(
                tmp, hidden=args.hidden, layers=args.layers,
                dtype="bfloat16" if args.device == "cuda" else "float32")
        else:
            mdir, paths = assets
        pipes, _ = serve.build_pipelines(
            serving_args(mdir, paths, args.device))
        pipes["mlm"].inference("img_0000", "warm [MASK]")
        out = {}
        for label, mb in [("batched", args.max_batch), ("unbatched", 1)]:
            lock = threading.Lock()
            batchers = serve.make_batchers(pipes, lock, max_batch=mb,
                                           wait_ms=args.batch_wait_ms)
            pipes["mlm"].inference_batch(
                [("img_0000", "warm [MASK]")] * mb, batch_size=mb)
            httpd = serve.DrainingServer(
                ("127.0.0.1", 0), serve.make_handler(pipes, batchers, lock,
                                                     max_batch=mb))
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            base = f"http://127.0.0.1:{httpd.server_address[1]}"
            answers = [None] * args.requests
            try:
                res = run_load(base, args.requests, args.threads, answers)
            finally:
                httpd.shutdown()
                httpd.server_close()
            res["batches"] = batchers["mlm"].stats["batches"]
            res["max_batch_seen"] = batchers["mlm"].stats["max_batch_seen"]
            res["answers"] = answers[:CHECKED]
            out[label] = res
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
