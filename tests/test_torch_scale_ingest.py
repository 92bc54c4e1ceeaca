"""The port's corpus-scale ingest rehearsal (`tools/scale_ingest.py`)
against the JAX package's (`tools_tpu/scale_ingest.py`), on the CPU.

- `generate` writes, from the same arguments, files byte for byte the JAX
  tool's (the two `data/synthetic.py` copies differ only in their
  docstrings);
- the same generated corpus gives equal `fetch(indices, epoch)` batches
  through both packages' `MultiCorpusPretrainDataset.from_yaml`;
- `generate` and `rehearse(device='cpu')` pass the four checks at a few MB,
  through the command line in a subprocess that imports only the port (its
  loader forks; this process holds JAX): (a) the chunks tile the pairs
  once, (b) each chunk's first pair carries its fingerprint, (c) the
  loader's RSS grows by less than its slots plus the JAX test's 400 MB, (d)
  a resumed loader repeats 4 batches bit for bit; at a few MB (c) cannot
  stream more than the bound, so the slow twin of
  `tests/test_scale_ingest.py` streams 1.2 GB.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from mvp_pytorch_tpu.data import datasets as jds
from mvp_pytorch_tpu.data import loader as jloader
from mvp_pytorch_tpu.data import tokenization as jtok
from mvp_pytorch_tpu_torch.data import datasets as pds
from mvp_pytorch_tpu_torch.data import tokenization as ptok
from mvp_pytorch_tpu_torch.data.loader import SLOTS_PER_WORKER
from mvp_pytorch_tpu_torch.tools import scale_ingest as port_ingest
from tools_tpu import scale_ingest as jax_ingest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_GB = 0.01             # 16 images of ~0.5 MB over 4 chunks
DEADLINE = 120              # seconds, each rehearsal subprocess


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    """torch single-threaded in this process: no intra-op thread pool is left
    behind for a later test in the same worker that forks."""
    torch.set_num_threads(1)


def tree_bytes(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def test_generate_writes_the_jax_tools_bytes(tmp_path):
    root = str(tmp_path / "corpus")
    want = jax_ingest.generate(root, total_gb=SMALL_GB, chunks=4, seed=3)
    want_files = tree_bytes(root)
    shutil.rmtree(root)
    got = port_ingest.generate(root, total_gb=SMALL_GB, chunks=4, seed=3)
    for k in ("yaml", "corpus", "vocab", "chunks", "n_images",
              "caps_per_img", "feature_gb"):
        assert got[k] == want[k], k
    got_files = tree_bytes(root)
    assert sorted(got_files) == sorted(want_files)
    for name in want_files:
        assert got_files[name] == want_files[name], name


def test_batches_match_the_jax_dataset(tmp_path):
    paths = port_ingest.generate(str(tmp_path / "corpus"),
                                 total_gb=SMALL_GB, chunks=4)
    kw = dict(seed=0, qa_pairs=True, mask_visual=False)
    jd = jds.MultiCorpusPretrainDataset.from_yaml(
        paths["yaml"], jtok.FastBertTokenizer(paths["vocab"]), **kw)
    pd = pds.MultiCorpusPretrainDataset.from_yaml(
        paths["yaml"], ptok.FastBertTokenizer(paths["vocab"]), **kw)
    assert len(pd) == len(jd) == paths["n_images"] * paths["caps_per_img"]
    sampler = jloader.BatchSampler(len(pd), 16, seed=0)
    # the pairs' epoch is 0 for steps 0-4, 1 for step 5
    for step in (0, 1, 2, 5):
        idx, epoch = sampler.batch_at(step), sampler.epoch_at(step)
        want, got = jd.fetch(idx, epoch), pd.fetch(idx, epoch)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def rehearse_cli(tmp_path, *flags):
    """The port's command line in a fresh interpreter under --platform cpu;
    returns its two JSON lines."""
    env = dict({k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
               OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "mvp_pytorch_tpu_torch.tools.scale_ingest",
         "--root", str(tmp_path / "corpus"), "--platform", "cpu"]
        + list(flags), cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=DEADLINE)
    assert res.returncode == 0, res.stderr[-4000:]
    lines = [json.loads(ln) for ln in res.stdout.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 2, res.stdout
    assert not (tmp_path / "corpus").exists()      # removed without --keep
    return lines


def memory_bound_mb(res, workers):
    """(c)'s bound: each worker's SLOTS_PER_WORKER shared slots of one
    batch (counted once: in the consumer, which maps every slot) plus the
    400 MB that the JAX test allows a loader beside its batches."""
    return SLOTS_PER_WORKER * workers * res["batch_bytes"] / 2**20 + 400.0


def test_rehearsal_passes_its_checks_at_a_few_mb(tmp_path):
    gen, res = rehearse_cli(tmp_path, "--gb", str(SMALL_GB), "--chunks", "4",
                            "--batch", "8", "--steps", "8", "--workers", "2",
                            "--device_demand_ex_s", "100")
    assert gen["n_images"] == 16 and gen["generated"] > 0
    assert res["device"] == "cpu" and res["workers"] == 2
    assert res["resume_bit_exact_steps"] == 4
    assert res["rss_bound_mb"] == pytest.approx(memory_bound_mb(res, 2),
                                                abs=0.05)
    assert 0 <= res["rss_growth_mb"] < res["rss_bound_mb"]
    assert res["ingest_ex_s"] > 0 and res["streamed_gb"] > 0
    assert res["feed_ratio"] == pytest.approx(res["ingest_ex_s"] / 100.0,
                                              abs=0.01)


@pytest.mark.slow
def test_rehearsal_at_1_2_gb(tmp_path):
    """`tests/test_scale_ingest.py` on the port: 1.2 GB in 3 chunks, B 96,
    24 steps, 2 workers, resumed at step 12; more bytes streamed than the
    memory bound, which holds."""
    gen, res = rehearse_cli(tmp_path, "--gb", "1.2", "--chunks", "3",
                            "--batch", "96", "--steps", "24", "--workers",
                            "2")
    assert gen["generated"] >= 1.0 and gen["n_images"] % 3 == 0
    bound = memory_bound_mb(res, 2)
    assert res["streamed_gb"] > 1.0 and res["streamed_gb"] * 1024 > bound
    assert res["rss_growth_mb"] < bound
    assert res["resume_bit_exact_steps"] == 4
    assert res["ingest_ex_s"] > 0 and res["feed_ratio"] is None
