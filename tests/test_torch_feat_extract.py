"""The port's region-feature extraction (`tools/img_feat_extract.py`) and
image transforms (`tools/transforms.py`) against the JAX package's, on the
CPU.

- `resize_shape`, `VinVLTransform` and a seeded `TrainTransform` (flips,
  jitter): arrays equal;
- `python -m mvp_pytorch_tpu_torch.tools.img_feat_extract --platform cpu`
  over five PNGs of mixed sizes (batch 2: a padded last chunk) against the
  JAX tool with the same detector weights (`convert.detector_state_dict`):
  the same image order, row count and tags, the 2,054-d features within
  1e-4, `imageid2idx.json` equal; the TSV readable by the port's
  `FeatureStore`; a batch of 1 (one image a forward) writes the same rows;
- `feature_row` is the tool's row encoding.
"""

import base64
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvp_pytorch_tpu.data.tsv import TSVFile as JaxTSV
from mvp_pytorch_tpu.detection import DetectorConfig as JaxConfig
from mvp_pytorch_tpu.detection import JaxDetector
from mvp_pytorch_tpu.detection import save_detector as jax_save_detector
from mvp_pytorch_tpu.tools import img_feat_extract as jextract
from mvp_pytorch_tpu.tools import transforms as jtf
from mvp_pytorch_tpu_torch.convert import detector_state_dict
from mvp_pytorch_tpu_torch.data.datasets import FeatureStore
from mvp_pytorch_tpu_torch.data.tsv import TSVFile
from mvp_pytorch_tpu_torch.detection import (Detector, DetectorConfig,
                                             save_detector)
from mvp_pytorch_tpu_torch.tools import img_feat_extract as pextract
from mvp_pytorch_tpu_torch.tools import transforms as ptf

TINY = dict(canvas=64, num_classes=6, pre_nms_topk=32, max_regions=8,
            stage_channels=(64, 64, 64), stage_blocks=(1, 1, 1),
            head_channels=64, feat_dim=128)
CFG = {"MIN_SIZE_TEST": 32, "MAX_SIZE_TEST": 64, "TO_BGR255": True,
       "PIXEL_MEAN": [102.98, 115.95, 122.77], "PIXEL_STD": [1.0, 2.0, 1.5]}


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    """torch single-threaded in this process: no intra-op thread pool is left
    behind for a later test in the same worker that forks."""
    torch.set_num_threads(1)


def image(h, w, seed=0):
    from PIL import Image
    rs = np.random.RandomState(seed)
    return Image.fromarray((rs.rand(h, w, 3) * 255).astype(np.uint8))


def test_resize_shape_matches_jax():
    for w in (5, 37, 333, 600, 601, 1000, 2000):
        for h in (5, 41, 600, 999, 3000):
            for lo, hi in ((600, 1000), (384, 640), (800, 1333)):
                assert (ptf.resize_shape(w, h, lo, hi)
                        == jtf.resize_shape(w, h, lo, hi))


@pytest.mark.parametrize("shape", [(40, 60), (70, 30), (32, 32)])
def test_transforms_match_jax(shape):
    img = image(*shape, seed=shape[0])
    np.testing.assert_array_equal(ptf.build_transforms(CFG)(img),
                                  jtf.build_transforms(CFG)(img))
    knobs = dict(flip_horizontal_prob=0.5, flip_vertical_prob=0.5,
                 brightness=0.2, contrast=0.3, saturation=0.1, seed=4)
    pt = ptf.build_transforms(CFG, is_train=True, **knobs)
    jt = jtf.build_transforms(CFG, is_train=True, **knobs)
    for _ in range(4):                        # the seeded stream advances
        np.testing.assert_array_equal(pt(img), jt(img))


@pytest.fixture(scope="module")
def extracted(tmp_path_factory):
    """Five PNGs; one detector's weights saved for both tools; the JAX
    tool's output at batch 2."""
    base = tmp_path_factory.mktemp("extract")
    img_dir = base / "imgs"
    img_dir.mkdir()
    for i, (h, w) in enumerate([(48, 64), (64, 40), (30, 30), (64, 64),
                                (20, 50)]):
        image(h, w, seed=i).save(str(img_dir / f"im{i}.png"))
    (img_dir / "notes.txt").write_text("not an image")
    cfg = JaxConfig(**TINY)
    model = JaxDetector(cfg)
    params = jax.jit(lambda: model.init(
        jax.random.PRNGKey(2), jnp.zeros((1, 64, 64, 3))))()["params"]
    jck, pck = str(base / "jax_ck"), str(base / "port_ck")
    jax_save_detector(jck, cfg, {"params": params})
    port = Detector(DetectorConfig(**TINY), device="cpu")
    port.load_state_dict(detector_state_dict(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    save_detector(pck, port.config, port)
    label_map = str(base / "labels.json")
    with open(label_map, "w") as f:
        json.dump({"label_to_idx": {f"obj{i}": i for i in range(6)}}, f)
    jout = str(base / "jax_out")
    jextract.main(["--image_dir", str(img_dir), "--target_dir", jout,
                   "--od_ckpt", jck, "--batch_size", "2", "--label_map",
                   label_map])
    return dict(img_dir=str(img_dir), pck=pck, jout=jout,
                label_map=label_map, base=base)


def rows_of(tsv):
    out = []
    for i in range(len(tsv)):
        name, payload = tsv.seek(i)
        d = json.loads(payload)
        feats = np.frombuffer(base64.b64decode(d["feature"]),
                              np.float32).reshape(-1, TINY["feat_dim"] + 6)
        out.append((name, feats, d["predictions"]))
    return out


@pytest.mark.parametrize("batch", ["2", "1"])
def test_extraction_matches_the_jax_tool(extracted, batch):
    pout = str(extracted["base"] / f"port_out_{batch}")
    path = pextract.main(["--image_dir", extracted["img_dir"],
                          "--target_dir", pout, "--od_ckpt", extracted["pck"],
                          "--batch_size", batch, "--label_map",
                          extracted["label_map"], "--platform", "cpu"])
    assert path == os.path.join(pout, "predictions.tsv")
    want = rows_of(JaxTSV(os.path.join(extracted["jout"], "predictions.tsv")))
    got = rows_of(TSVFile(path))
    assert [r[0] for r in got] == [r[0] for r in want] == [
        f"im{i}.png" for i in range(5)]
    for (_, gf, gt), (_, wf, wt) in zip(got, want):
        assert gt == wt and len(gt) == gf.shape[0] > 0
        assert all(t.startswith("obj") for t in gt)
        np.testing.assert_allclose(gf, wf, atol=1e-4, rtol=0)
    for name in ("imageid2idx.json",):
        with open(os.path.join(pout, name)) as f, \
                open(os.path.join(extracted["jout"], name)) as g:
            assert json.load(f) == json.load(g)
    store = FeatureStore(path, feature_dim=TINY["feat_dim"] + 6)
    feats, tags = store.get("im3.png")
    np.testing.assert_array_equal(feats, got[3][1])
    assert tags == got[3][2]


def test_feature_row_is_the_tool_encoding():
    feats = np.arange(12, dtype=np.float64).reshape(2, 6)
    name, payload = pextract.feature_row("a.png", feats, ("x", "y"))
    d = json.loads(payload)
    assert name == "a.png" and d["predictions"] == ["x", "y"]
    np.testing.assert_array_equal(
        np.frombuffer(base64.b64decode(d["feature"]), np.float32),
        feats.astype(np.float32).ravel())
