"""The port imports torch and numpy, never JAX or the JAX package."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "mvp_pytorch_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mvp_pytorch_tpu")


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    """torch single-threaded in this process: no intra-op thread pool is left
    behind for a later test in the same worker that forks."""
    torch.set_num_threads(1)


def package_files():
    for dirpath, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_import_leaves_jax_out_of_sys_modules():
    """In a fresh interpreter (the test process has jax already: conftest),
    importing the package and every submodule (the parallel ones included)
    pulls in none of them, nor
    `yaml` (only a `--dataset_yaml` manifest needs it, at its first read),
    nor `PIL` (only decoding an image file needs it)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import mvp_pytorch_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}"
        " + ('yaml', 'PIL')]\n"
        "assert len(names) >= 77, names\n"
        "for n in ('models.pretrain', 'models.heads', 'tasks.pretrain',\n"
        "          'training.loop', 'native', 'data.tokenization',\n"
        "          'data.tsv', 'data.tensorize', 'data.datasets',\n"
        "          'data.synthetic', 'data.loader', 'utils.logger',\n"
        "          'tasks.common', 'tasks.retrieval', 'utils.misc',\n"
        "          'data.masking', 'tasks.vqa', 'tasks.ve', 'tasks.re_task',\n"
        "          'tasks.nlvr', 'pipeline', 'tasks.serve',\n"
        "          'models.img_bert', 'data.processors',\n"
        "          'models.generation', 'tasks.captioning', 'utils.cider',\n"
        "          'utils.caption_eval', 'utils.meteor_rouge', 'utils.spice',\n"
        "          'models.cbs', 'training.scst', 'detection',\n"
        "          'detection.backbone', 'detection.nms',\n"
        "          'detection.roi_align', 'detection.detector',\n"
        "          'detection.frontend', 'detection.synthetic_boxes',\n"
        "          'detection.train_cli', 'tools', 'tools.transforms',\n"
        "          'tools.img_feat_extract', 'parallel',\n"
        "          'parallel.distributed', 'parallel.collectives',\n"
        "          'parallel.mesh', 'parallel.activation_sharding',\n"
        "          'parallel.pipeline', 'parallel.sharded_retrieval',\n"
        "          'ops.moe', 'training.sharded_checkpoint',\n"
        "          'training.consolidate', 'tools.launch',\n"
        "          'training.profiler', 'tools.inspect_ckpt',\n"
        "          'tools.load_test_serve', 'utils.file_utils'):\n"
        "    assert p.__name__ + '.' + n in names, n\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("path", list(package_files()),
                         ids=lambda p: os.path.relpath(p, PKG))
def test_no_forbidden_import_in_source(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        for m in mods:
            assert m.split(".")[0] not in FORBIDDEN, (path, m)
