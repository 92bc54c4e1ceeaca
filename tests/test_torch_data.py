"""The port's data plane against the JAX package's, on the CPU: every check
is an exact equality.

- token ids of `BertTokenizer` and `FastBertTokenizer` (its native path and
  its pure-Python path) on the synthetic vocab, a wordpiece vocab and edge
  strings;
- `TSVFile` rows and `tsv_writer` bytes; `FeatureStore.get` arrays and tags,
  native and pure-Python decode;
- `tensorize_example` / `collate` array by array;
- `RetrievalDataset.fetch`, `caption_arrays` and `image_arrays`;
- `BatchSampler.batch_at` over 3 epochs, resumed at step 7, on 2 ranks;
- `make_synthetic_root` byte for byte;
- `ProcessLoader`: its batches equal `dataset.fetch(sampler.batch_at(step))`
  in step order (spawned workers); a worker's error, death or silence
  past the timeout reaches the consumer as an error. Workers are spawned, or
  forked in a subprocess that imports only the port, never forked from this
  process (it holds JAX); every such test has its own time limit.
"""

import base64
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mvp_pytorch_tpu.data import datasets as jds
from mvp_pytorch_tpu.data import loader as jloader
from mvp_pytorch_tpu.data import synthetic as jsyn
from mvp_pytorch_tpu.data import tensorize as jtz
from mvp_pytorch_tpu.data import tokenization as jtok
from mvp_pytorch_tpu.data import tsv as jtsv
from mvp_pytorch_tpu_torch import native
from mvp_pytorch_tpu_torch.data import datasets as pds
from mvp_pytorch_tpu_torch.data import loader as ploader
from mvp_pytorch_tpu_torch.data import synthetic as psyn
from mvp_pytorch_tpu_torch.data import tensorize as ptz
from mvp_pytorch_tpu_torch.data import tokenization as ptok
from mvp_pytorch_tpu_torch.data import tsv as ptsv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOADER_TIMEOUT = 60.0
EDGE = ["", "   ", "Hello, World!", "x[SEP]y", "[MASK], dogs", "a\x7fb",
        "café naïve", "中文 dogs", "dogs' ball...",
        "UPPER lower MiXeD", "playing unaffable dogs", "a" * 150,
        "##dogs", "tab\tand\nnewline\r", "[CLS] two dogs [SEP]",
        "¿qué?", "ball　park", "x" * 30 + "dogs"]
WORDPIECE_VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "dog",
                   "##s", "play", "##ing", "un", "##aff", "##able", "hello",
                   ",", "!", ".", "'", "?", "world", "ball", "a", "x", "##x",
                   "two", "cafe", "naive", "upper", "lower", "mixed", "tab",
                   "and", "newline", "中", "文", "que", "¿",
                   "park"]


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    """torch single-threaded in this process: no intra-op thread pool is left
    behind for a later test in the same worker that forks."""
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """The same synthetic root written by both packages."""
    base = tmp_path_factory.mktemp("roots")
    return (jsyn.make_synthetic_root(str(base / "jax"), seed=3),
            psyn.make_synthetic_root(str(base / "port"), seed=3))


@pytest.fixture(scope="module")
def datasets(roots):
    """JAX and port RetrievalDatasets over the port's root."""
    paths = roots[1]

    def build(mod, tok_mod, **kw):
        tok = tok_mod.FastBertTokenizer(paths["vocab"])
        return mod.RetrievalDataset(
            paths["captions"], mod.FeatureStore(paths["features"]), tok,
            sg2id=mod.load_phrase_vocab(paths["id2phrase"]),
            cfg=mod.TensorizeConfig(max_seq_length=12, max_phrases=3), **kw)
    return build(jds, jtok), build(pds, ptok)


def assert_arrays_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        assert g.dtype == want[k].dtype, k
        np.testing.assert_array_equal(g, want[k], err_msg=k)


# ---------------------------------------------------------------------------
# synthetic root, tokenizer, native library
# ---------------------------------------------------------------------------

def test_synthetic_root_is_byte_equal(roots):
    jroot, proot = roots[0]["root"], roots[1]["root"]
    files = sorted(os.path.relpath(os.path.join(d, f), jroot)
                   for d, _, fs in os.walk(jroot) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), proot)
                           for d, _, fs in os.walk(proot) for f in fs)
    assert len(files) > 15
    for rel in files:
        with open(os.path.join(jroot, rel), "rb") as f:
            want = f.read()
        with open(os.path.join(proot, rel), "rb") as f:
            got = f.read()
        if rel == "paths.json":     # holds the root's own path
            want = want.replace(jroot.encode(), b"ROOT")
            got = got.replace(proot.encode(), b"ROOT")
        assert got == want, rel


def test_native_library_builds_here():
    assert native.available()


@pytest.mark.parametrize("vocab", ["synthetic", "wordpiece"])
@pytest.mark.parametrize("path", ["native", "python"])
def test_token_ids_match_jax(roots, tmp_path, vocab, path):
    if vocab == "synthetic":
        vocab_file = roots[1]["vocab"]
        with open(roots[1]["captions"]) as f:
            texts = [c["text"] for cs in json.load(f).values() for c in cs]
    else:
        vocab_file = str(tmp_path / "vocab.txt")
        with open(vocab_file, "w") as f:
            f.write("\n".join(WORDPIECE_VOCAB) + "\n")
        texts = []
    texts += EDGE
    want = jtok.BertTokenizer(vocab_file)
    fast = ptok.FastBertTokenizer(vocab_file)
    assert fast.native_active
    if path == "python":
        fast._native = None
    jfast = jtok.FastBertTokenizer(vocab_file)
    for text in texts:
        ids = want.encode(text)
        assert fast.encode(text) == ids, text
        assert fast.tokenize(text) == want.tokenize(text), text
        assert jfast.encode(text) == ids, text
        assert ptok.BertTokenizer(vocab_file).encode(text) == ids, text
    assert fast.convert_ids_to_tokens(list(range(len(fast)))) == \
        want.convert_ids_to_tokens(list(range(len(want))))


def test_tokenizer_pickles_without_its_native_handle(roots):
    import pickle
    tok = ptok.FastBertTokenizer(roots[1]["vocab"])
    back = pickle.loads(pickle.dumps(tok))
    assert back.native_active
    assert back.encode("two dogs, playing!") == tok.encode("two dogs, playing!")


def test_b64_decode_at_matches_base64():
    rng = np.random.default_rng(0)
    for n in (0, 1, 2, 3, 4, 5, 3 * 1000 + 1, 2054 * 4 * 7):
        raw = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        enc = b"xx" + base64.b64encode(raw) + b"yyy"
        out = np.empty(n + 4, np.uint8)
        got = native.b64_decode_at(enc, 2, len(enc) - 5, out)
        assert got == n and out[:n].tobytes() == raw
    out = np.empty(8, np.uint8)
    assert native.b64_decode_at(b"ab!d", 0, 4, out) == -1
    assert native.b64_decode_at(b"abcde", 0, 5, out) == -1
    with pytest.raises(ValueError):
        native.b64_decode_at(b"abcd", 2, 4, out)


# ---------------------------------------------------------------------------
# TSV, feature store, tensorize
# ---------------------------------------------------------------------------

def test_tsv_rows_and_writer_match_jax(roots, tmp_path):
    rows = [["a", "bé", "3"], ["", "x y", "z"], ["only"], ["r", "", ""]]
    jtsv.tsv_writer(rows, str(tmp_path / "j.tsv"))
    ptsv.tsv_writer(rows, str(tmp_path / "p.tsv"))
    for ext in (".tsv", ".lineidx"):
        assert (open(tmp_path / f"p{ext}", "rb").read()
                == open(tmp_path / f"j{ext}", "rb").read())
    with open(tmp_path / "crlf.tsv", "wb") as f:
        f.write(b"a\tb\r\nc\td\r\n\te\n")
    for name in ("p.tsv", "crlf.tsv", roots[1]["corpus"],
                 roots[1]["features"]):
        path = str(tmp_path / name) if not os.path.isabs(name) else name
        jt, pt = jtsv.TSVFile(path), ptsv.TSVFile(path)
        assert len(pt) == len(jt)
        for i in list(range(len(jt))) + [-1]:
            assert pt.seek(i) == jt.seek(i)
            assert pt.seek_bytes(i) == jt.seek_bytes(i)
            assert pt.seek_raw(i) == jt.seek_raw(i)


@pytest.mark.parametrize("decode", ["native", "python"])
def test_feature_store_matches_jax(roots, monkeypatch, decode):
    feats = roots[1]["features"]
    want = jds.FeatureStore(feats)
    got = pds.FeatureStore(feats)
    if decode == "python":
        monkeypatch.setattr(native, "available", lambda: False)
    assert got.keys() == want.keys()
    for key in want.keys():
        f, t = got.get(key)
        wf, wt = want.get(key)
        assert f.dtype == wf.dtype == np.float32
        np.testing.assert_array_equal(f, wf)
        assert t == wt
        assert key in got


def test_tensorize_and_collate_match_jax(roots):
    paths = roots[1]
    jt = jtok.BertTokenizer(paths["vocab"])
    pt = ptok.FastBertTokenizer(paths["vocab"])
    store = jds.FeatureStore(paths["features"])
    sg2id = jds.load_phrase_vocab(paths["id2phrase"])
    assert pds.load_phrase_vocab(paths["id2phrase"]) == sg2id
    with open(paths["captions"]) as f:
        caps = json.load(f)
    cfgs = [dict(), dict(max_seq_length=6, max_phrases=2, max_tag_length=5,
                         max_img_seq_length=4),
            dict(max_seq_length=40, max_img_seq_length=12)]
    for kw in cfgs:
        jexs, pexs = [], []
        for i, (key, cs) in enumerate(sorted(caps.items())[:6]):
            feat, tags = store.get(key)
            phr = jds.phrases_to_ids(cs[0]["phrases"], sg2id)
            assert pds.phrases_to_ids(cs[0]["phrases"], sg2id) == phr
            extra = pds.tags_for_text_a(tags, True, i % 2 == 0)
            assert extra == jds.tags_for_text_a(tags, True, i % 2 == 0)
            args = (cs[0]["text"], feat, " ".join(tags), phr)
            jexs.append(jtz.tensorize_example(
                jt, *args, cfg=jtz.TensorizeConfig(**kw), text_a_tags=extra))
            pexs.append(ptz.tensorize_example(
                pt, *args, cfg=ptz.TensorizeConfig(**kw), text_a_tags=extra))
            assert_arrays_equal(pexs[-1], jexs[-1])
        assert_arrays_equal(ptz.collate(pexs), jtz.collate(jexs))
    assert pds.tags_for_text_a(["a"], False, True) == ""


# ---------------------------------------------------------------------------
# dataset and sampler
# ---------------------------------------------------------------------------

def test_retrieval_dataset_matches_jax(datasets, roots, tmp_path):
    jd, pd = datasets
    assert len(pd) == len(jd) and pd.img_keys == jd.img_keys
    for idx in (np.arange(5), np.array([7, 3, 59, 0, 12, 12])):
        assert_arrays_equal(pd.fetch(idx), jd.fetch(idx))
    assert_arrays_equal(pd.caption_arrays(), jd.caption_arrays())
    assert_arrays_equal(pd.image_arrays(), jd.image_arrays())
    keys = tmp_path / "keys.tsv"
    keys.write_text("img_0003\tx\nimg_0001\n\nimg_0010\n")
    paths = roots[1]

    def build(mod, tok_mod):
        return mod.RetrievalDataset(
            paths["captions"], mod.FeatureStore(paths["features"]),
            tok_mod.BertTokenizer(paths["vocab"]), num_captions_per_img=3,
            img_keys_file=str(keys))
    jd3, pd3 = build(jds, jtok), build(pds, ptok)
    assert pd3.img_keys == jd3.img_keys == ["img_0001", "img_0003",
                                            "img_0010"]
    assert_arrays_equal(pd3.fetch(np.arange(9)), jd3.fetch(np.arange(9)))
    assert_arrays_equal(pd3.caption_arrays(), jd3.caption_arrays())
    keys.write_text("nothing\n")
    with pytest.raises(ValueError):
        build(pds, ptok)


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("n,batch,world", [(60, 8, 1), (60, 8, 2), (5, 8, 1),
                                           (61, 6, 3)])
def test_batch_sampler_matches_jax(n, batch, world, drop_last):
    steps = 3 * -(-n // batch) + 2          # past 3 epochs
    for rank in range(world):
        kw = dict(seed=5, drop_last=drop_last, rank=rank, world_size=world)
        want = jloader.BatchSampler(n, batch, **kw)
        got = ploader.BatchSampler(n, batch, **kw)
        for step in range(steps):
            np.testing.assert_array_equal(got.batch_at(step),
                                          want.batch_at(step))
            assert got.epoch_at(step) == want.epoch_at(step)
        # resume at step 7: a fresh sampler, first asked for step 7
        resumed = ploader.BatchSampler(n, batch, **kw)
        for step in range(7, steps):
            np.testing.assert_array_equal(resumed.batch_at(step),
                                          want.batch_at(step))


# ---------------------------------------------------------------------------
# the process loader
# ---------------------------------------------------------------------------

def _port_names(batch):
    from mvp_pytorch_tpu_torch.tasks.retrieval import port_names
    return port_names(batch)


@pytest.mark.parametrize("workers", [1, 3])
def test_loader_batches_are_the_samplers_in_order(datasets, workers):
    from mvp_pytorch_tpu_torch.tasks.retrieval import RetrievalFetch
    jd, pd = datasets
    sampler = ploader.BatchSampler(len(pd), 7, seed=2)
    want_sampler = jloader.BatchSampler(len(jd), 7, seed=2)
    loader = ploader.ProcessLoader(
        RetrievalFetch(pd, use_phrase=True), sampler, start_step=3,
        num_workers=workers, device="cpu", multiprocessing_context="spawn",
        timeout=LOADER_TIMEOUT)
    seen = []
    for step, batch in loader:
        want = _port_names(jd.fetch(want_sampler.batch_at(step)))
        assert_arrays_equal(batch, want)
        assert loader.timing()["worker_ms"] > 0
        seen.append(step)
        if len(seen) == 9:       # past two epochs of 60 / 7 steps
            break
    assert seen == list(range(3, 12))
    assert not loader._procs
    assert not [f for f in os.listdir("/dev/shm") if loader._tag in f]
    with pytest.raises(ValueError):
        ploader.ProcessLoader(RetrievalFetch(pd, use_phrase=True), sampler,
                              num_workers=0, device="cpu")


def test_loader_worker_error_reaches_the_consumer(datasets):
    from mvp_pytorch_tpu_torch.tasks.retrieval import RetrievalFetch
    pd = datasets[1]
    # indices past the dataset's end fail inside the worker's fetch
    sampler = ploader.BatchSampler(len(pd) + 40, 10, seed=0, shuffle=False)
    loader = ploader.ProcessLoader(
        RetrievalFetch(pd, use_phrase=False), sampler, num_workers=2,
        device="cpu", multiprocessing_context="spawn",
        timeout=LOADER_TIMEOUT)
    steps = []
    with pytest.raises(RuntimeError, match="IndexError"):
        for step, _ in loader:
            steps.append(step)
    assert steps == list(range(len(pd) // 10))
    assert not loader._procs


WORKER_FAULTS = {
    # worker 1 dies at step 3 without a word, as the OOM killer does; the
    # sleep lets its queue's feeder send step 1 first
    "death": ("""
def fetch(idx):
    if idx[0] >= 12:
        time.sleep(1.0)
        os._exit(7)
    return {"x": np.full((4, 3), idx[0], np.int32)}
""", 60.0, "died"),
    # worker 1 hangs at step 3: the consumer gives up after its timeout
    "silence": ("""
def fetch(idx):
    if idx[0] >= 12:
        time.sleep(60.0)
    return {"x": np.full((4, 3), idx[0], np.int32)}
""", 2.0, "sent nothing"),
}
RUN_LOADER = """
loader = ProcessLoader(fetch, BatchSampler(100, 4, shuffle=False),
                       num_workers=2, device="cpu",
                       multiprocessing_context="fork", timeout={timeout})
seen = []
try:
    for step, batch in loader:
        assert int(batch["x"][0, 0]) == 4 * step
        seen.append(step)
except (RuntimeError, TimeoutError) as e:
    assert {match!r} in str(e), e
    assert seen == [0, 1, 2], seen
    assert not loader._procs
    print("RAISED", seen)
"""


@pytest.mark.parametrize("fault", sorted(WORKER_FAULTS))
def test_loader_worker_fault_reaches_the_consumer(fault):
    """Forked workers, in a subprocess that imports only the port."""
    body, timeout, match = WORKER_FAULTS[fault]
    code = ("import os, time\nimport numpy as np\n"
            "from mvp_pytorch_tpu_torch.data.loader import (BatchSampler,\n"
            "                                               ProcessLoader)\n"
            + body + RUN_LOADER.format(timeout=timeout, match=match))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "RAISED [0, 1, 2]" in res.stdout
