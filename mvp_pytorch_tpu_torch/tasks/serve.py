"""The serving endpoint over `InferencePipeline`: the JAX package's
`tasks/serve.py` on one device, an HTTP surface on the standard library:

  POST /v1/mlm        {"image": <path or id>, "text": "two [MASK] ..."}
  POST /v1/embedding  {"image": <path or id>, "text": "..."}
  POST /v1/batch      {"mode": "mlm", "pairs": [[img, text], ...]}
  GET  /healthz       (with the batching stats)

Cross-request micro-batching: single-pair requests wait in a queue per mode;
one worker thread takes up to --max_batch of them (waiting at most
--batch_wait_ms after the first) and runs one batched forward, padded to
--max_batch, for all of them. The request thread does the host work
(features, tokenization, decoding) outside the device lock. The batched
forward is warmed at startup. SIGTERM stops accepting, finishes the requests
in flight and exits 0.

  python -m mvp_pytorch_tpu_torch.tasks.serve --model_dir out/model \
      --feature_tsv data/predictions.tsv --port 8799

Without a feature TSV, `--od_model` detects the regions of each image file:
'torch' (the port's detector, seeded), 'torch:<ckpt_dir>' (a
`detection.train_cli` checkpoint) or a TorchScript detector's path.

It runs on the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import logging
import queue
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class MicroBatcher:
    """Collects concurrent single requests into batched forwards.

    `submit` blocks the calling (HTTP) thread until its result is ready; one
    worker thread takes the first waiting item, then whatever else arrives
    within `wait_ms`, up to `max_batch`, and calls `infer_batch(items)` once
    for the group. When a group fails, each of its items is retried alone,
    so that only the failing ones error."""

    def __init__(self, infer_batch, max_batch: int = 16,
                 wait_ms: float = 5.0, name: str = ""):
        self.infer_batch = infer_batch
        self.max_batch = max_batch
        self.wait_s = wait_ms / 1000.0
        self.q: "queue.Queue" = queue.Queue()
        self._stats_lock = threading.Lock()
        self._stats = {"requests": 0, "batches": 0, "max_batch_seen": 0}
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name=f"batcher-{name}")
        self._worker.start()

    @property
    def stats(self):
        with self._stats_lock:
            return dict(self._stats)

    def submit(self, item):
        done = threading.Event()
        holder = {}
        self.q.put((item, done, holder))
        # bounded waits and a liveness check: a dead worker fails the
        # request instead of holding the HTTP thread forever
        while not done.wait(timeout=1.0):
            if not self._worker.is_alive():
                raise RuntimeError("the batcher's worker for this mode died; "
                                   "request dropped")
        if "error" in holder:
            raise holder["error"]
        return holder["result"]

    def _run_one(self, item, holder):
        try:
            res = self.infer_batch([item])
            if len(res) != 1:
                raise RuntimeError(f"infer_batch returned {len(res)} results "
                                   f"for 1")
            holder["result"] = res[0]
        except Exception as e:  # noqa: BLE001 - the request's own error
            holder["error"] = e

    def _run(self):
        while True:
            group = [self.q.get()]
            t_end = time.monotonic() + self.wait_s
            while len(group) < self.max_batch:
                timeout = t_end - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    group.append(self.q.get(timeout=timeout))
                except queue.Empty:
                    break
            with self._stats_lock:
                self._stats["requests"] += len(group)
                self._stats["batches"] += 1
                self._stats["max_batch_seen"] = max(
                    self._stats["max_batch_seen"], len(group))
            try:
                results = self.infer_batch([g[0] for g in group])
                if len(results) != len(group):
                    raise RuntimeError(
                        f"infer_batch returned {len(results)} results for "
                        f"{len(group)} items")
                for (_, _, holder), res in zip(group, results):
                    holder["result"] = res
            except Exception:  # noqa: BLE001 - isolate the failing request
                for item, _, holder in group:
                    self._run_one(item, holder)
            for _, done, _ in group:
                done.set()


class DrainingServer(ThreadingHTTPServer):
    # non-daemon handler threads: server_close() joins them, so a shutdown
    # finishes every request in flight
    daemon_threads = False
    # socketserver's listen backlog of 5 drops or resets the connections of
    # a burst of clients; this one holds many micro-batches of them
    request_queue_size = 128


def build_pipelines(args):
    """{mode: InferencePipeline} over --model_dir, and the FeatureStore of
    --feature_tsv (None without one). Without a TSV, --od_model's detector
    ('torch[:<ckpt_dir>]' or a TorchScript path) is built once and serves
    every mode."""
    from ..data.datasets import FeatureStore
    from ..pipeline import InferencePipeline, make_object_detector
    device = getattr(args, "device", "cuda")
    od = store = None
    if args.feature_tsv:
        od = store = FeatureStore(args.feature_tsv,
                                  feature_dim=args.img_feature_dim)
    elif getattr(args, "od_model", None):
        od = make_object_detector(args.od_model, args.od_config_dir, device)
    pipes = {}
    for mode in args.modes.split(","):
        pipes[mode] = InferencePipeline(
            mode, args.model_dir, object_detector=od,
            id2phrase=args.id2phrase, max_seq_length=args.max_seq_length,
            max_img_seq_length=args.max_img_seq_length,
            max_tag_length=args.max_tag_length,
            max_phrases=args.max_phrases, device=device)
    return pipes, store


def _mlm_text(pipe, ex, ids) -> str:
    return f"recovered [MASK] tokens: {pipe.decode_mlm(ex, ids)}"


def make_handler(pipes, batchers, device_lock, max_batch: int = 16):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok", "modes": list(pipes),
                                 "batching": {m: b.stats
                                              for m, b in batchers.items()}})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            # host work (features, tokenization, decoding) runs here, on
            # the request thread; the lock holds only the device forward
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/v1/batch":
                    mode = req.get("mode", "mlm")
                    pipe = pipes[mode]
                    exs = pipe.prepare_batch([(p[0], p[1])
                                              for p in req["pairs"]])
                    with device_lock:
                        # the batcher's batch size: the warmed shape
                        raw = pipe.infer_prepared(exs, batch_size=max_batch)
                    if mode == "embedding":
                        out = [{k: v.tolist() for k, v in r.items()}
                               for r in raw]
                    else:
                        out = [_mlm_text(pipe, ex, r)
                               for ex, r in zip(exs, raw)]
                    self._send(200, {"results": out})
                    return
                mode = self.path.rsplit("/", 1)[-1]
                if mode not in pipes:
                    self._send(404, {"error": f"unknown mode {mode}"})
                    return
                ex = pipes[mode].prepare_example(req["image"], req["text"])
                raw = batchers[mode].submit(ex)
                if mode == "mlm":
                    res = _mlm_text(pipes[mode], ex, raw)
                else:
                    res = {k: v.tolist() for k, v in raw.items()}
                self._send(200, {"result": res})
            except Exception as e:  # noqa: BLE001 - the serving surface
                self._send(500, {"error": f"{type(e).__name__}: {e}"})
    return Handler


def make_batchers(pipes, device_lock, max_batch: int, wait_ms: float):
    """A MicroBatcher per mode over pre-tensorized examples; the device lock
    is held only around the batched forward, padded to `max_batch`."""
    batchers = {}
    for mode, pipe in pipes.items():
        def infer_batch(items, _pipe=pipe):
            with device_lock:   # one device user at a time across modes
                return _pipe.infer_prepared(list(items),
                                            batch_size=max_batch)
        batchers[mode] = MicroBatcher(infer_batch, max_batch=max_batch,
                                      wait_ms=wait_ms, name=mode)
    return batchers


def get_args(argv=None):
    p = argparse.ArgumentParser(description="HTTP serving of the mlm and "
                                "embedding pipelines")
    p.add_argument("--model_dir", required=True)
    p.add_argument("--modes", default="mlm,embedding")
    p.add_argument("--feature_tsv", default=None,
                   help="precomputed-features backend")
    p.add_argument("--od_model", default=None,
                   help="a detector: 'torch' (seeded), 'torch:<ckpt_dir>' "
                        "or a TorchScript path (with --od_config_dir)")
    p.add_argument("--od_config_dir", default="tools_tpu/configs/",
                   help="vinvl_transform.json and the label map")
    p.add_argument("--id2phrase", default=None)
    p.add_argument("--img_feature_dim", type=int, default=2054)
    p.add_argument("--max_seq_length", type=int, default=30)
    p.add_argument("--max_img_seq_length", type=int, default=50)
    p.add_argument("--max_tag_length", type=int, default=20)
    p.add_argument("--max_phrases", type=int, default=5)
    p.add_argument("--max_batch", type=int, default=16,
                   help="micro-batch size for cross-request batching")
    p.add_argument("--batch_wait_ms", type=float, default=5.0,
                   help="max wait after the first queued request")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8799)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cpu runs the plain PyTorch path; cuda raises "
                        "without a card")
    return p.parse_args(argv)


def main(argv=None, ready=None):
    """Serve until SIGTERM (or `server.shutdown()`), then drain and return.
    `ready(server, pipes, batchers)`, when given, is called once the server
    listens (for in-process use); `server.startup` holds the seconds the
    load and the warm-up took."""
    args = get_args(argv)
    # the pipeline names the checkpoint keys it drops in an INFO line
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    t0 = time.perf_counter()
    pipes, store = build_pipelines(args)
    startup = {"load_s": time.perf_counter() - t0, "warmup_s": 0.0}
    print(f"serve: loaded {list(pipes)} in {startup['load_s']:.2f} s",
          flush=True)
    # warm the batched forward at the serving batch size, on any stored
    # image (only the precomputed-features backend has one to hand)
    if store is not None:
        first_img = next(iter(store.keys()))
        t0 = time.perf_counter()
        for pipe in pipes.values():
            pipe.inference_batch([(first_img, "warmup [MASK]")]
                                 * args.max_batch, batch_size=args.max_batch)
        startup["warmup_s"] = time.perf_counter() - t0
        print(f"serve: warmed {list(pipes)} at batch {args.max_batch} in "
              f"{startup['warmup_s']:.2f} s", flush=True)
    device_lock = threading.Lock()
    batchers = make_batchers(pipes, device_lock, args.max_batch,
                             args.batch_wait_ms)

    server = DrainingServer(
        (args.host, args.port),
        make_handler(pipes, batchers, device_lock, args.max_batch))
    server.startup = startup

    def _term(signum, frame):
        print("serve: SIGTERM - draining in-flight requests", flush=True)
        threading.Thread(target=server.shutdown, daemon=True).start()

    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, _term)
    print(f"serving {list(pipes)} on http://{args.host}:"
          f"{server.server_address[1]} (micro-batch <= {args.max_batch}, "
          f"wait {args.batch_wait_ms} ms)", flush=True)
    if ready is not None:
        ready(server, pipes, batchers)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        print("serve: drained, exiting cleanly", flush=True)


if __name__ == "__main__":
    main()
