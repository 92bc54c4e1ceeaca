"""A port checkpoint holds the tokenizer files of its output directory, as
the JAX package's `CheckpointManager.save` does, so that a checkpoint
directory is a model directory on its own.

- `CheckpointManager.write` copies whichever of `TOKENIZER_FILES` the output
  directory holds, synchronously and through `AsyncSaver`, and says nothing
  about the missing ones; a JAX checkpoint of the same output directory
  holds the same files (the 2-rank mesh path is checked on the launcher's
  driver runs, `tests/test_torch_launch.py`);
- a retrieval CLI checkpoint (`--synthetic --tiny --platform cpu`, 2 steps)
  is enough to serve embeddings from (`InferencePipeline('embedding')`) and
  to go on fine-tuning retrieval from, with no other directory given; a
  pretraining CLI checkpoint, which has the MLM head, is enough to serve
  masked tokens from (`InferencePipeline('mlm')`). A retrieval model has no
  MLM head, so the 'mlm' pipeline refuses its checkpoint by the missing
  `cls.predictions` keys, whatever the vocabulary.
"""

import logging
import os

import numpy as np
import pytest
import torch

from mvp_pytorch_tpu.training import checkpoint as jax_checkpoint
from mvp_pytorch_tpu_torch.pipeline import InferencePipeline
from mvp_pytorch_tpu_torch.tasks import pretrain as port_pretrain
from mvp_pytorch_tpu_torch.tasks import retrieval as port_retrieval
from mvp_pytorch_tpu_torch.training.checkpoint import (
    TOKENIZER_FILES, AsyncSaver, CheckpointManager)
from torch_flags import WORKERS

RUN = ["--synthetic", "--tiny", "--platform", "cpu", "--do_train",
       "--max_steps", "2", "--ckpt_period", "2", "--train_batch_size", "8",
       "--dtype", "float32"] + WORKERS + ["1"]


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    """torch single-threaded in this process: no intra-op thread pool is left
    behind for a later test in the same worker that forks."""
    torch.set_num_threads(1)


def tokenizer_files(d):
    return {n for n in TOKENIZER_FILES if os.path.exists(os.path.join(d, n))}


def output_dir_with_two_files(d):
    """An output directory with two of the three tokenizer files."""
    os.makedirs(d)
    files = {"vocab.txt": "[PAD]\n[UNK]\nword\n",
             "tokenizer_config.json": '{"do_lower_case": true}\n'}
    for name, text in files.items():
        with open(os.path.join(d, name), "w") as f:
            f.write(text)
    return files


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_write_copies_tokenizer_files(tmp_path, mode, caplog, capsys):
    out = str(tmp_path / "out")
    files = output_dir_with_two_files(out)
    model = torch.nn.Linear(3, 2)
    saver = AsyncSaver() if mode == "async" else None
    with caplog.at_level(logging.DEBUG):
        d = CheckpointManager(out).save(4, model, saver=saver)
        if saver is not None:
            saver.wait()
    assert tokenizer_files(d) == set(files)
    for name, text in files.items():
        with open(os.path.join(d, name)) as f:
            assert f.read() == text
    assert not caplog.records
    assert capsys.readouterr() == ("", "")


def test_jax_checkpoint_holds_the_same_tokenizer_files(tmp_path):
    jout, pout = str(tmp_path / "jax"), str(tmp_path / "port")
    output_dir_with_two_files(jout)
    output_dir_with_two_files(pout)
    jd = jax_checkpoint.CheckpointManager(jout).save(
        1, {"w": np.zeros((2, 3), np.float32)})
    pd = CheckpointManager(pout).save(1, torch.nn.Linear(3, 2))
    assert tokenizer_files(jd) == tokenizer_files(pd) == {
        "vocab.txt", "tokenizer_config.json"}


@pytest.fixture(scope="module")
def cli_checkpoints(tmp_path_factory):
    """(retrieval output dir, its step-2 checkpoint, pretraining step-2
    checkpoint) of two tiny CLI runs."""
    base = tmp_path_factory.mktemp("cli")
    ret = str(base / "retrieval")
    port_retrieval.main(["--output_dir", ret] + RUN)
    pre = str(base / "pretrain")
    port_pretrain.main(["--output_dir", pre] + RUN)
    step = "checkpoint-0000002"
    return ret, os.path.join(ret, step), os.path.join(pre, step)


def test_retrieval_checkpoint_serves_embeddings(cli_checkpoints):
    _, ckpt, _ = cli_checkpoints
    assert tokenizer_files(ckpt) == {"vocab.txt"}
    pipe = InferencePipeline("embedding", ckpt, device="cpu")
    assert pipe.tokenizer.vocab_size == len(open(
        os.path.join(ckpt, "vocab.txt")).read().splitlines())


def test_pretraining_checkpoint_serves_masked_tokens(cli_checkpoints):
    _, _, ckpt = cli_checkpoints
    assert tokenizer_files(ckpt) == {"vocab.txt"}
    pipe = InferencePipeline("mlm", ckpt, device="cpu")
    assert "[MASK]" in pipe.tokenizer.vocab


def test_finetuning_starts_from_the_checkpoint_alone(cli_checkpoints,
                                                     tmp_path):
    """The retrieval driver, given the checkpoint as its only model
    directory (no --synthetic, no --data_dir), reads config, weights and
    vocabulary from it and trains and evaluates on the same data files."""
    ret, ckpt, _ = cli_checkpoints
    synth = os.path.join(ret, "synth")
    res = port_retrieval.main([
        "--output_dir", str(tmp_path / "ft"), "--model_name_or_path", ckpt,
        "--captions_json", os.path.join(synth, "captions.json"),
        "--feature_tsv", os.path.join(synth, "features", "predictions.tsv"),
        "--id2phrase", os.path.join(synth, "id2phrase.json"),
        "--platform", "cpu", "--do_train", "--do_eval", "--max_steps", "1",
        "--train_batch_size", "8"] + WORKERS + ["1"])
    assert len(res["train"]) == 1
    assert np.isfinite(res["train"][0]["loss"])
    assert "fine" in res["eval"]
