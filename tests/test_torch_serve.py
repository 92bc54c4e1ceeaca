"""The port's serving path against the JAX package's, on the CPU:
`InferencePipeline` (`mlm` and `embedding`), its load rule for pretraining
checkpoints, `MicroBatcher` and the HTTP server of `tasks.serve`.

The model is `tests/test_pipeline.py`'s (hidden 32, 2+2+2 layers over the
synthetic root's vocabulary), its JAX init plus seeded noise saved twice: as
the JAX package's model directory and, through the port's converter, as the
port's (`config.json`, `pytorch_model.bin`, `vocab.txt`). Both pipelines read
the root's features through their `FeatureStore`:
- `mlm`: the recovered [MASK] tokens equal, single and batched (batch 2 over
  3 pairs: a padded last chunk);
- `embedding`: the four outputs within 1e-5.
A pretraining tree (`BiPretrainModel`'s heads beside the same backbone and
LM head) serves in both packages with the same answers: the JAX pipeline
ignores the heads its model lacks, the port drops them and names them in
one log line. A tree without the LM head raises in both. The task CLIs'
`load_params_or_init` stays strict.

Detector backends: the JAX package's specs ('jax', 'jax:<ckpt>') raise,
naming the port's 'torch[:<ckpt_dir>]' and the converter; a 'torch:<ckpt>'
pipeline answers from an image file, single and batched (its detector's
`batch_call`); a scripted module with the reference artifact's contract
serves as a TorchScript detector path; `tasks.serve --od_model` builds one
detector for both modes.

The server: the four `MicroBatcher` behaviours of `tests/test_serve.py`;
`tasks.serve.main` on a thread with concurrent single requests (fewer
batches than requests, every answer equal to the pipeline's), `/v1/batch`
and `/healthz`; SIGTERM to `python -m mvp_pytorch_tpu_torch.tasks.serve` in
a subprocess that imports only the port: it drains and exits 0. Every wait
has its own deadline and every server is shut down in a `finally`.
"""

import dataclasses
import functools
import json
import logging
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvp_pytorch_tpu.data.datasets import FeatureStore as JaxFeatureStore
from mvp_pytorch_tpu.data.synthetic import make_synthetic_root
from mvp_pytorch_tpu.data.tokenization import BertTokenizer as JaxTokenizer
from mvp_pytorch_tpu.models import MLMModel as JaxMLM
from mvp_pytorch_tpu.models import ModelConfig as JaxConfig
from mvp_pytorch_tpu.pipeline import InferencePipeline as JaxPipeline
from mvp_pytorch_tpu.training.checkpoint import save_pretrained
from mvp_pytorch_tpu_torch.convert import jax_params_to_state_dict
from mvp_pytorch_tpu_torch.data.datasets import FeatureStore
from mvp_pytorch_tpu_torch.models import BiPretrainModel, ModelConfig
from mvp_pytorch_tpu_torch.models import NLVRModel
from mvp_pytorch_tpu_torch.pipeline import InferencePipeline
from mvp_pytorch_tpu_torch.tasks import serve
from mvp_pytorch_tpu_torch.tasks.common import load_params_or_init

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EMB_TOL = 1e-5
LENGTHS = dict(max_seq_length=30, max_img_seq_length=50, max_tag_length=20,
               max_phrases=5)
PAIRS = [("img_0001", "two [MASK] are playing"),
         ("img_0002", "a [MASK] rides a [MASK]"),
         ("img_0003", "the [MASK] is red")]
DEADLINE_S = 60


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    """torch single-threaded in this process: no intra-op thread pool is left
    behind for a later test in the same worker that forks."""
    torch.set_num_threads(1)


def save_port_dir(directory, params, cfg, tok):
    """The port's model directory for a flax tree."""
    os.makedirs(directory, exist_ok=True)
    ModelConfig.from_dict(dataclasses.asdict(cfg)).save_pretrained(directory)
    torch.save(jax_params_to_state_dict(params),
               os.path.join(directory, "pytorch_model.bin"))
    tok.save_pretrained(directory)
    return directory


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """{name: (JAX model dir, port model dir)} for the MLM tree, the
    pretraining tree and a tree without the LM head; and the root."""
    base = tmp_path_factory.mktemp("serve")
    paths = make_synthetic_root(str(base / "synth"))
    tok = JaxTokenizer(paths["vocab"])
    cfg = JaxConfig(vocab_size=tok.vocab_size + 20,
                    only_word_size=tok.vocab_size, hidden_size=32,
                    num_hidden_layers=4, num_attention_heads=4,
                    intermediate_size=64, max_position_embeddings=128,
                    img_feature_dim=2054, hidden_dropout_prob=0.0,
                    attention_probs_dropout_prob=0.0, qa_answer_size=7)
    z = functools.partial(jnp.zeros, dtype=jnp.int32)
    o = functools.partial(jnp.ones, dtype=jnp.int32)
    params = jax.jit(lambda: JaxMLM(cfg).init(
        jax.random.PRNGKey(0), z((1, 35)), o((1, 35)), z((1, 35)),
        z((1, 20)), o((1, 70)), o((1, 20)), jnp.zeros((1, 50, 2054)),
        max_tag_length=20))()["params"]
    rs = np.random.RandomState(5)
    params = jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + 0.05 * rs.randn(*v.shape)).astype(
            np.float32), params)
    h = cfg.hidden_size

    def dense(n_in, n_out):
        return {"kernel": (0.1 * rs.randn(n_in, n_out)).astype(np.float32),
                "bias": np.zeros(n_out, np.float32)}
    # BiPretrainModel's tree: its heads beside the same backbone and LM head
    pretrain = dict(params,
                    half_mlm=jax.tree_util.tree_map(
                        lambda v: v + 0.01, params["cls_predictions"]),
                    cls_seq_relationship={"seq_relationship": dense(h, 2)},
                    qa_head=dense(h, 7), qa_seq_relation=dense(h, 2),
                    logit_scale=np.asarray(np.log(1 / 0.07), np.float32))
    trees = {"mlm": params, "pretrain": pretrain,
             "no_lm_head": {"bert": params["bert"]}}
    out = {}
    for name, tree in trees.items():
        jdir = str(base / name / "jax")
        save_pretrained(jdir, tree, cfg)
        tok.save_pretrained(jdir)
        out[name] = (jdir, save_port_dir(str(base / name / "port"), tree,
                                         cfg, tok))
    return out, paths


def jax_pipe(mode, d, paths):
    return JaxPipeline(mode, d, object_detector=JaxFeatureStore(
        paths["features"]), id2phrase=paths["id2phrase"], **LENGTHS)


def port_pipe(mode, d, paths):
    return InferencePipeline(mode, d, object_detector=FeatureStore(
        paths["features"]), id2phrase=paths["id2phrase"], device="cpu",
        **LENGTHS)


@pytest.fixture(scope="module")
def jax_answers(dirs):
    """The JAX pipelines' answers on the MLM tree."""
    d, paths = dirs
    mlm = jax_pipe("mlm", d["mlm"][0], paths)
    emb = jax_pipe("embedding", d["mlm"][0], paths)
    return dict(single=[mlm.inference(*p) for p in PAIRS],
                batched=mlm.inference_batch(PAIRS, batch_size=2),
                emb=[emb.inference(*p) for p in PAIRS],
                emb_batched=emb.inference_batch(PAIRS, batch_size=2))


def test_mlm_pipeline_matches_jax(dirs, jax_answers):
    d, paths = dirs
    pipe = port_pipe("mlm", d["mlm"][1], paths)
    single = [pipe.inference(*p) for p in PAIRS]
    assert single == jax_answers["single"]
    assert single[1].startswith("recovered [MASK] tokens")
    assert single[1].count("'") == 4            # two [MASK]s, two tokens
    batched = pipe.inference_batch(PAIRS, batch_size=2)
    assert batched == jax_answers["batched"]
    assert [len(r) for r in batched] == [1, 2, 1]
    # the weights live on the pipeline's device; the argmax ids come back
    exs = pipe.prepare_batch(PAIRS)
    ids = pipe.infer_prepared(exs, batch_size=4)
    assert [r.shape for r in ids] == [(30 + 5,)] * 3
    assert all(r.dtype == np.int64 for r in ids)


def test_embedding_pipeline_matches_jax(dirs, jax_answers):
    d, paths = dirs
    pipe = port_pipe("embedding", d["mlm"][1], paths)
    for got_all, want_all in (
            ([pipe.inference(*p) for p in PAIRS], jax_answers["emb"]),
            (pipe.inference_batch(PAIRS, batch_size=2),
             jax_answers["emb_batched"])):
        for got, want in zip(got_all, want_all):
            assert set(got) == set(want) == {
                "cross_modal_output", "pooled_output", "txt_encoder_output",
                "vis_encoder_output"}
            for k in want:
                np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                           atol=EMB_TOL, rtol=0, err_msg=k)
    assert got_all[0]["cross_modal_output"].shape == (35 + 50, 32)


def test_pretraining_checkpoint_serves_as_in_jax(dirs, jax_answers, caplog):
    """The JAX pipeline serves a BiPretrainModel tree, ignoring its other
    heads; the port serves it the same, naming the dropped keys once."""
    d, paths = dirs
    jdir, pdir = d["pretrain"]
    # the tree is a whole BiPretrainModel's: it loads strictly into one
    pcfg = ModelConfig.from_pretrained(pdir)
    BiPretrainModel(pcfg, qa_pairs=True, device="cpu").load_state_dict(
        torch.load(os.path.join(pdir, "pytorch_model.bin"),
                   weights_only=True), strict=True)
    assert [jax_pipe("mlm", jdir, paths).inference(*p)
            for p in PAIRS] == jax_answers["single"]
    with caplog.at_level(logging.INFO, logger="mvp_pytorch_tpu_torch"):
        pipe = port_pipe("mlm", pdir, paths)
    dropped = [r.getMessage() for r in caplog.records if "dropped" in
               r.getMessage()]
    assert len(dropped) == 1
    for key in ("cls.seq_relationship.weight", "half_mlm.bias",
                "qa_head.weight", "qa_seq_relation.bias", "logit_scale"):
        assert key in dropped[0], key
    assert [pipe.inference(*p) for p in PAIRS] == jax_answers["single"]
    emb = port_pipe("embedding", pdir, paths).inference(*PAIRS[0])
    np.testing.assert_allclose(emb["pooled_output"],
                               np.asarray(jax_answers["emb"][0]
                                          ["pooled_output"]), atol=EMB_TOL)


def test_a_checkpoint_without_the_lm_head_raises(dirs):
    d, paths = dirs
    jdir, pdir = d["no_lm_head"]
    with pytest.raises(Exception, match="cls_predictions"):
        jax_pipe("mlm", jdir, paths).inference(*PAIRS[0])
    with pytest.raises(RuntimeError, match="cls.predictions"):
        port_pipe("mlm", pdir, paths)
    port_pipe("embedding", pdir, paths)     # the backbone alone serves it


def test_task_loads_stay_strict(dirs):
    """`load_params_or_init` (the task CLIs) still refuses a checkpoint
    whose keys are not the model's."""
    d, _ = dirs
    pdir = d["pretrain"][1]
    model = NLVRModel(ModelConfig.from_pretrained(pdir), device="cpu")

    class Args:
        model_name_or_path = pdir
    with pytest.raises(RuntimeError, match="Missing key|Unexpected key"):
        load_params_or_init(Args, model)


DET = dict(canvas=64, num_classes=6, pre_nms_topk=32, max_regions=8,
           stage_channels=(64, 64, 64), stage_blocks=(1, 1, 1),
           head_channels=64, feat_dim=2048)


@pytest.fixture(scope="module")
def detector_files(tmp_path_factory):
    """A port detector checkpoint (2,048-d features, the served model's
    2,054-d regions), an od_config_dir with a label map and the reference's
    transform json, and two PNGs."""
    from PIL import Image
    from mvp_pytorch_tpu_torch.detection import (Detector, DetectorConfig,
                                                 save_detector)
    base = tmp_path_factory.mktemp("detector")
    ckpt = str(base / "ckpt")
    save_detector(ckpt, DetectorConfig(**DET),
                  Detector(DetectorConfig(**DET), device="cpu", seed=2))
    od_dir = base / "od_config"
    od_dir.mkdir()
    with open(od_dir / "VG-SGG-dicts-vgoi6-clipped.json", "w") as f:
        json.dump({"label_to_idx": {w: i for i, w in enumerate(
            ["dog", "man", "ball", "tree", "sky", "grass"])}}, f)
    with open(os.path.join(ROOT, "tools_tpu", "configs",
                           "vinvl_transform.json")) as f:
        tcfg = json.load(f)
    tcfg.update(MIN_SIZE_TEST=40, MAX_SIZE_TEST=64)
    with open(od_dir / "vinvl_transform.json", "w") as f:
        json.dump(tcfg, f)
    rs = np.random.RandomState(0)
    images = []
    for i, (h, w) in enumerate([(64, 80), (50, 60)]):
        path = str(base / f"img{i}.png")
        Image.fromarray((rs.rand(h, w, 3) * 255).astype(np.uint8)).save(path)
        images.append(path)
    return dict(ckpt=ckpt, od_dir=str(od_dir), images=images, base=base)


def test_detector_backends_of_later_items_raise(dirs, detector_files):
    """The JAX package's detector specs raise, naming the port's spec and
    the converter; `'torch:<ckpt>'` serves a request from an image file."""
    d, paths = dirs
    for od in ("jax", "jax:/some/ckpt"):
        with pytest.raises(ValueError,
                           match=r"'torch\[:<ckpt_dir>\]'.*detector_state_dict"):
            InferencePipeline("mlm", d["mlm"][1], object_detector=od,
                              device="cpu")
    with pytest.raises(ValueError, match="valid names"):
        InferencePipeline("nope", d["mlm"][1], device="cpu")
    f = detector_files
    pipe = InferencePipeline("mlm", d["mlm"][1],
                             object_detector="torch:" + f["ckpt"],
                             od_config_dir=f["od_dir"], device="cpu",
                             **LENGTHS)
    res = pipe.inference(f["images"][0], "two [MASK] are playing")
    assert res.startswith("recovered [MASK] tokens")
    feats, tags = pipe.preprocess_img(f["images"][0])
    assert feats.shape[1] == 2054 and 0 < feats.shape[0] <= DET["max_regions"]
    assert set(tags) <= {"dog", "man", "ball", "tree", "sky", "grass"}
    pairs = [(f["images"][0], "two [MASK] are playing"),
             (f["images"][1], "a [MASK] on the grass"),
             (f["images"][0], "two [MASK] are playing")]
    batched = pipe.inference_batch(pairs, batch_size=2)
    assert " ".join(batched[0]) in res and batched[0] == batched[2]


def test_torchscript_detector_backend(dirs, detector_files):
    """A scripted module with the reference artifact's contract (a CHW
    image batch -> bboxes in pixels, tag ids, 2,048-d features) serves as
    a detector path, on the pipeline's device; its boxes are normalised by
    the transformed image's size."""
    class TinyOD(torch.nn.Module):
        def forward(self, x: torch.Tensor):
            h, w = float(x.shape[-2]), float(x.shape[-1])
            boxes = torch.tensor([[0.0, 0.0, w / 2, h / 2],
                                  [w / 4, h / 4, w, h],
                                  [0.0, h / 2, w, h]])[None]
            tags = torch.tensor([[0, 4, 2]])
            feats = x.mean() + torch.arange(3 * 2048.0).reshape(1, 3, 2048)
            return boxes, tags, feats / 2048.0
    f = detector_files
    od_path = str(f["base"] / "od_model.pt")
    torch.jit.script(TinyOD()).save(od_path)
    d, _ = dirs
    pipe = InferencePipeline("mlm", d["mlm"][1], object_detector=od_path,
                             od_config_dir=f["od_dir"], device="cpu",
                             **LENGTHS)
    feats, tags = pipe.preprocess_img(f["images"][0])
    assert tags == ["dog", "sky", "ball"]
    assert feats.shape == (3, 2054) and feats.dtype == np.float32
    np.testing.assert_allclose(feats[:, 2048:], [
        [0, 0, 0.5, 0.5, 0.5, 0.5], [0.25, 0.25, 1, 1, 0.75, 0.75],
        [0, 0.5, 1, 1, 1, 0.5]], atol=1e-6)
    assert pipe.inference(f["images"][1], "a [MASK] runs").startswith(
        "recovered [MASK] tokens")


def test_serve_builds_one_detector_for_every_mode(dirs, detector_files):
    """`--od_model torch:<ckpt>` (without a feature TSV) builds the
    detector once; both modes' pipelines answer from an image file."""
    d, _ = dirs
    f = detector_files
    args = serve.get_args(["--model_dir", d["mlm"][1], "--od_model",
                           "torch:" + f["ckpt"], "--od_config_dir",
                           f["od_dir"], "--device", "cpu"])
    pipes, store = serve.build_pipelines(args)
    assert store is None and set(pipes) == {"mlm", "embedding"}
    assert pipes["mlm"]._od is pipes["embedding"]._od
    out = pipes["embedding"].inference(f["images"][1], "a dog")
    assert out["pooled_output"].shape == (32,)
    with pytest.raises(ValueError, match="torch"):
        serve.build_pipelines(serve.get_args(
            ["--model_dir", d["mlm"][1], "--od_model", "jax", "--device",
             "cpu"]))


def test_phrases_are_skipped_without_the_spice_jar(dirs, tmp_path):
    d, paths = dirs
    pipe = InferencePipeline("mlm", d["mlm"][1], id2phrase=paths["id2phrase"],
                             parser_path=str(tmp_path), device="cpu")
    assert pipe.sg2id
    assert pipe.phrase_extract_batch(["a man", "two dogs"]) == [[], []]
    assert not os.path.exists(pipe.phrase_cache_dir) or not os.listdir(
        pipe.phrase_cache_dir)


def test_pipeline_runs_on_cuda_unless_asked_for_the_cpu(dirs):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the pipeline would run on it")
    d, _ = dirs
    with pytest.raises(RuntimeError, match="CUDA"):
        InferencePipeline("mlm", d["mlm"][1])


# ---------------------------------------------------------------------------
# MicroBatcher (tests/test_serve.py's behaviours, on the port's)
# ---------------------------------------------------------------------------

def join_all(threads):
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=DEADLINE_S)
        assert not t.is_alive(), "a request did not return in time"


def test_microbatcher_batches_concurrent_requests():
    def infer(items):
        time.sleep(0.01)                      # the device's latency
        return [f"r:{x}" for x in items]

    mb = serve.MicroBatcher(infer, max_batch=8, wait_ms=30)
    results = {}

    def worker(i):
        results[i] = mb.submit(f"item{i}")
    join_all([threading.Thread(target=worker, args=(i,)) for i in range(16)])
    assert results == {i: f"r:item{i}" for i in range(16)}
    assert mb.stats["requests"] == 16
    assert mb.stats["batches"] <= 6, mb.stats
    assert mb.stats["max_batch_seen"] >= 4, mb.stats


def test_microbatcher_propagates_errors():
    def infer(items):
        raise ValueError("boom")

    mb = serve.MicroBatcher(infer, max_batch=4, wait_ms=1)
    with pytest.raises(ValueError, match="boom"):
        mb.submit("x")


def test_microbatcher_isolates_failing_request():
    def infer(items):
        if any(x == "bad" for x in items):
            raise ValueError("bad item")
        return [f"r:{x}" for x in items]

    mb = serve.MicroBatcher(infer, max_batch=8, wait_ms=40)
    results, errors = {}, {}

    def worker(i, item):
        try:
            results[i] = mb.submit(item)
        except Exception as e:  # noqa: BLE001
            errors[i] = e
    join_all([threading.Thread(target=worker, args=(i, it))
              for i, it in enumerate(["a", "b", "bad", "c"])])
    assert results == {0: "r:a", 1: "r:b", 3: "r:c"}, (results, errors)
    assert list(errors) == [2] and "bad item" in str(errors[2])


def test_microbatcher_short_results_do_not_hang():
    def infer(items):
        return items[:-1] if len(items) > 1 else ["only"]

    mb = serve.MicroBatcher(infer, max_batch=4, wait_ms=30)
    results = []

    def worker(item):
        try:
            results.append(mb.submit(item))
        except Exception as e:  # noqa: BLE001
            results.append(e)
    join_all([threading.Thread(target=worker, args=(f"x{i}",))
              for i in range(3)])
    assert len(results) == 3


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_microbatcher_fails_requests_when_its_worker_dies():
    """A worker killed by what it does not catch fails the waiting request
    within its bounded wait instead of holding it forever."""
    def infer(items):
        raise SystemExit("the worker thread ends here")

    mb = serve.MicroBatcher(infer, max_batch=4, wait_ms=1)
    with pytest.raises(RuntimeError, match="worker .* died"):
        mb.submit("x")
    assert not mb._worker.is_alive()


# ---------------------------------------------------------------------------
# the HTTP server
# ---------------------------------------------------------------------------

def post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=DEADLINE_S) as r:
        return json.loads(r.read())


def serve_argv(d, paths, port=0, max_batch=8):
    return ["--model_dir", d, "--feature_tsv", paths["features"],
            "--id2phrase", paths["id2phrase"], "--device", "cpu",
            "--max_batch", str(max_batch), "--batch_wait_ms", "20",
            "--port", str(port)]


def test_server_batches_concurrent_requests(dirs, jax_answers):
    d, paths = dirs
    up = {}
    ready = threading.Event()

    def on_ready(server, pipes, batchers):
        up.update(server=server, pipes=pipes, batchers=batchers)
        ready.set()
    t = threading.Thread(target=serve.main, args=(serve_argv(d["mlm"][1],
                                                             paths),),
                         kwargs=dict(ready=on_ready), daemon=True)
    t.start()
    try:
        assert ready.wait(DEADLINE_S), "the server did not come up"
        base = f"http://127.0.0.1:{up['server'].server_address[1]}"
        before = {m: b.stats for m, b in up["batchers"].items()}
        n = 12
        results, errors = [None] * n, []

        def worker(i):
            mode = "mlm" if i % 2 == 0 else "embedding"
            try:
                results[i] = post(f"{base}/v1/{mode}",
                                  {"image": PAIRS[i % 3][0],
                                   "text": PAIRS[i % 3][1]})
            except Exception as e:  # noqa: BLE001
                errors.append(e)
        join_all([threading.Thread(target=worker, args=(i,))
                  for i in range(n)])
        assert not errors, errors
        for i, r in enumerate(results):
            if i % 2 == 0:
                assert r["result"] == jax_answers["single"][i % 3]
            else:
                want = jax_answers["emb"][i % 3]
                np.testing.assert_allclose(
                    np.asarray(r["result"]["pooled_output"]),
                    np.asarray(want["pooled_output"]), atol=EMB_TOL)
        for mode, b in up["batchers"].items():
            served = b.stats["requests"] - before[mode]["requests"]
            batches = b.stats["batches"] - before[mode]["batches"]
            assert served == n // 2 and batches < served, b.stats
        got = post(f"{base}/v1/batch", {"mode": "mlm",
                                        "pairs": [list(p) for p in PAIRS]})
        assert got["results"] == jax_answers["single"]
        with urllib.request.urlopen(f"{base}/healthz",
                                    timeout=DEADLINE_S) as r:
            health = json.loads(r.read())
        assert health["modes"] == ["mlm", "embedding"]
        assert health["batching"]["mlm"]["requests"] >= n // 2
        with pytest.raises(urllib.error.HTTPError, match="404"):
            post(f"{base}/v1/nope", {"image": "img_0001", "text": "a"})
    finally:
        if "server" in up:
            up["server"].shutdown()
        t.join(timeout=DEADLINE_S)
    assert not t.is_alive(), "the server did not drain"


def test_server_holds_a_burst_of_connections():
    """64 clients connect before the server accepts any: each is held in the
    listen queue and answered, none dropped or reset."""
    server = serve.DrainingServer(("127.0.0.1", 0), serve.make_handler(
        {}, {}, threading.Lock()))
    n, port = 64, server.server_address[1]
    socks, t = [], None
    try:
        for _ in range(n):
            s = socket.create_connection(("127.0.0.1", port), timeout=5)
            s.sendall(b"GET /healthz HTTP/1.0\r\n\r\n")
            socks.append(s)
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        for s in socks:
            with s.makefile("rb") as f:
                assert f.readline().split()[1] == b"200"
    finally:
        for s in socks:
            s.close()
        if t is not None:
            server.shutdown()
        server.server_close()


def test_server_subprocess_drains_on_sigterm(dirs):
    """SIGTERM: stop accepting, finish the requests in flight, exit 0; the
    process imported neither JAX nor the JAX package."""
    d, paths = dirs
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    code = ("import runpy, sys\n"
            "sys.argv = ['serve'] + sys.argv[1:]\n"
            "try:\n"
            "    runpy.run_module('mvp_pytorch_tpu_torch.tasks.serve',"
            " run_name='__main__')\n"
            "finally:\n"
            "    bad = sorted(m for m in sys.modules if m.split('.')[0] in"
            " ('jax', 'flax', 'mvp_pytorch_tpu'))\n"
            "    print('foreign modules:', bad, flush=True)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.Popen(
        [sys.executable, "-c", code] + serve_argv(d["mlm"][1], paths, port,
                                                  max_batch=4),
        cwd=ROOT, env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    try:
        deadline = time.time() + DEADLINE_S
        base = f"http://127.0.0.1:{port}"
        up = False
        while time.time() < deadline and not up:
            if p.poll() is not None:
                raise AssertionError(p.stdout.read())
            try:
                with urllib.request.urlopen(f"{base}/healthz", timeout=2):
                    up = True
            except OSError:
                time.sleep(0.2)
        assert up, "the server never came up"
        r = post(f"{base}/v1/mlm", {"image": "img_0001",
                                    "text": "a [MASK] here"})
        assert r["result"].startswith("recovered [MASK] tokens")
        p.send_signal(signal.SIGTERM)
        out, _ = p.communicate(timeout=DEADLINE_S)
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate(timeout=DEADLINE_S)
    assert p.returncode == 0, out
    assert "draining in-flight requests" in out, out
    assert "drained, exiting cleanly" in out, out
    assert "foreign modules: []" in out, out
