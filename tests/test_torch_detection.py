"""The port's detection front-end (`detection/`) against the JAX package's,
on the CPU, in fp32, the JAX weights carried over by
`convert.detector_state_dict`.

- `box_iou` within 1e-6; `nms` / `batched_nms` indices and validity equal,
  tied scores included; `roi_align` within 1e-5 with boxes partly off the
  map;
- `Trunk` within 1e-4 of the largest output at even, odd and non-square
  sizes (flax's asymmetric "SAME" padding of the stride-2 stem, convs and
  pool);
- `Detector.forward` at `train_detector`'s small config: boxes, scores,
  features and class logits within 1e-4 relative, `valid` and `class_ids`
  equal; a state dict flattened (c, p, p) instead of (p, p, c) does not
  give the same features;
- `Detector.loss` and every parameter's gradient within 1e-4 relative;
- `dtype="bfloat16"`: the map in bf16, the field and features in fp32, the
  field held by the 1.25 rule against JAX's bf16 field;
- the README's recipe: a JAX checkpoint converted, saved and served;
- `map50` on the hand-checked cases of `tests/test_detection.py`;
- `_postprocess` rows equal to the JAX frontend's on the same outputs;
  `batch_call` equal to per-image calls (a padded last chunk);
- the checkpoint round trip, the missing-checkpoint refusal, and
  `train_cli` on the CPU (`load_frontend` reads it back; its loss falls over
  40 steps, a slow test); without `cpu` every entry point asks for CUDA.
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvp_pytorch_tpu.detection import DetectorConfig as JaxConfig
from mvp_pytorch_tpu.detection import JaxDetectionFrontend, JaxDetector
from mvp_pytorch_tpu.detection import box_iou as jax_box_iou
from mvp_pytorch_tpu.detection import roi_align as jax_roi_align
from mvp_pytorch_tpu.detection.backbone import Trunk as JaxTrunk
from mvp_pytorch_tpu.detection.nms import batched_nms as jax_batched_nms
from mvp_pytorch_tpu.detection.nms import nms as jax_nms
from mvp_pytorch_tpu.detection.synthetic_boxes import make_batch as jax_batch
from mvp_pytorch_tpu_torch.convert import detector_state_dict
from mvp_pytorch_tpu_torch.detection import (DetectionFrontend, Detector,
                                             DetectorConfig, batched_nms,
                                             box_iou, load_frontend, nms,
                                             roi_align, save_detector)
from mvp_pytorch_tpu_torch.detection import synthetic_boxes as psyn
from mvp_pytorch_tpu_torch.detection import train_cli
from mvp_pytorch_tpu_torch.detection.backbone import Trunk
from mvp_pytorch_tpu_torch.detection.frontend import host_output

REL = 1e-4
SMALL = dict(canvas=128, num_classes=6, pre_nms_topk=64, max_regions=8,
             stage_channels=(64, 64, 64), stage_blocks=(1, 1, 1),
             head_channels=64, feat_dim=256)
TINY = dict(canvas=64, num_classes=6, pre_nms_topk=32, max_regions=8,
            stage_channels=(64, 64, 64), stage_blocks=(1, 1, 1),
            head_channels=64, feat_dim=128)


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    """torch single-threaded in this process: no intra-op thread pool is left
    behind for a later test in the same worker that forks."""
    torch.set_num_threads(1)


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------

def random_boxes(rs, n, extent=100.0):
    xy = rs.rand(n, 2) * extent
    wh = rs.rand(n, 2) * extent / 2
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_box_iou_matches_jax():
    rs = np.random.RandomState(0)
    a, b = random_boxes(rs, 7), random_boxes(rs, 5)
    b[0] = b[0, [2, 3, 0, 1]]                 # an inverted (empty) box
    want = np.asarray(jax_box_iou(jnp.asarray(a), jnp.asarray(b)))
    got = box_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(box_iou(torch.tensor([[0., 0., 10., 10.]]),
                                       torch.tensor([[5., 5., 15., 15.]])),
                               [[25.0 / 175.0]], rtol=1e-6)


@pytest.mark.parametrize("seed", range(4))
def test_nms_matches_jax_with_ties(seed):
    """Dense overlapping boxes, scores drawn from a few values (ties), some
    below the threshold; more slots than survivors."""
    rs = np.random.RandomState(seed)
    b, k, out = 3, 40, 12
    boxes = np.stack([random_boxes(rs, k, 60.0) for _ in range(b)])
    scores = rs.choice([0.02, 0.3, 0.5, 0.5, 0.9], (b, k)).astype(np.float32)
    for thr in (0.3, 0.5):
        want = jax_batched_nms(jnp.asarray(boxes), jnp.asarray(scores), out,
                               thr, 0.05)
        got = batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                          out, thr, 0.05)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        one = nms(torch.from_numpy(boxes[0]), torch.from_numpy(scores[0]),
                  out, thr, 0.05)
        wone = jax_nms(jnp.asarray(boxes[0]), jnp.asarray(scores[0]), out,
                       thr, 0.05)
        np.testing.assert_array_equal(one[0].numpy(), np.asarray(wone[0]))
        np.testing.assert_array_equal(one[1].numpy(), np.asarray(wone[1]))


def test_nms_oracle():
    boxes = torch.tensor([[0., 0., 10., 10.], [1., 1., 11., 11.],
                          [20., 20., 30., 30.], [21., 21., 31., 31.]])
    scores = torch.tensor([0.9, 0.8, 0.7, 0.6])
    idx, valid = nms(boxes, scores, max_out=4, iou_threshold=0.5)
    assert idx[valid].tolist() == [0, 2]
    assert idx[~valid].tolist() == [0, 0]
    assert not nms(boxes, scores, 4, 0.5, score_threshold=0.95)[1].any()


def test_roi_align_matches_jax_off_the_map():
    rs = np.random.RandomState(0)
    fmap = rs.randn(12, 16, 3).astype(np.float32)
    boxes = np.asarray([[8., 16., 120., 88.], [0., 0., 40., 40.],
                        [100., 60., 128., 96.],     # past the bottom edge
                        [-30., -20., 20., 30.],     # above and left
                        [110., 80., 170., 140.],    # mostly off the map
                        [50., 50., 50.5, 50.2]],    # thinner than a cell
                       np.float32)
    for size, ratio in ((4, 2), (7, 2), (3, 1)):
        want = np.asarray(jax_roi_align(jnp.asarray(fmap), jnp.asarray(boxes),
                                        output_size=size, spatial_scale=1 / 8.,
                                        sampling_ratio=ratio))
        got = roi_align(torch.from_numpy(fmap), torch.from_numpy(boxes),
                        output_size=size, spatial_scale=1 / 8.,
                        sampling_ratio=ratio).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.abs(got[4]).max() > 0 and np.abs(got[4]).max() < np.abs(
        got[0]).max() * 10


# ---------------------------------------------------------------------------
# the trunk and the detector
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trunks():
    """The JAX trunk's params and outputs at even, odd and non-square
    sizes."""
    out = {}
    jt = JaxTrunk((64, 64), (1, 1))
    for shape in [(2, 32, 32, 3), (2, 33, 33, 3), (1, 37, 30, 3)]:
        x = np.random.RandomState(shape[1]).randn(*shape).astype(np.float32)
        p = jax.jit(lambda x: jt.init(jax.random.PRNGKey(1), x))(
            jnp.asarray(x))["params"]
        out[shape] = (x, numpy_tree(p), np.asarray(jax.jit(
            lambda p, x: jt.apply({"params": p}, x))(p, jnp.asarray(x))))
    return out


@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (2, 33, 33, 3),
                                   (1, 37, 30, 3)], ids=str)
def test_trunk_matches_jax(trunks, shape):
    x, params, want = trunks[shape]
    trunk = Trunk((64, 64), (1, 1))
    trunk.load_state_dict(detector_state_dict(params), strict=True)
    with torch.no_grad():
        got = trunk(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert rel_err(got, want) < REL


@pytest.fixture(scope="module")
def det():
    """The JAX detector at the small config: params, a batch, its forward
    and its loss with gradients."""
    cfg = JaxConfig(**SMALL)
    model = JaxDetector(cfg)
    data = jax_batch(np.random.RandomState(3), 2, cfg.canvas)
    x = jnp.asarray(data["images"])
    params = jax.jit(lambda: model.init(jax.random.PRNGKey(0), x))()[
        "params"]
    out = jax.jit(lambda p, x: model.apply({"params": p}, x))(params, x)

    @jax.jit
    def loss_and_grads(p):
        def f(p):
            return model.apply({"params": p}, x,
                               jnp.asarray(data["gt_boxes"]),
                               jnp.asarray(data["gt_classes"]),
                               jnp.asarray(data["gt_valid"]),
                               method=model.loss)
        return jax.value_and_grad(f, has_aux=True)(p)
    (loss, aux), grads = loss_and_grads(params)
    return dict(params=numpy_tree(params), data=data,
                out=host_tuple(out), loss=float(loss),
                aux={k: float(v) for k, v in aux.items()},
                grads=detector_state_dict(numpy_tree(grads)))


def host_tuple(out):
    return type(out)(*(np.asarray(v) for v in out))


def port_detector(params, cfg=SMALL):
    model = Detector(DetectorConfig(**cfg), device="cpu")
    model.load_state_dict(detector_state_dict(params), strict=True)
    return model


def test_detector_forward_matches_jax(det):
    model = port_detector(det["params"])
    with torch.no_grad():
        out = model(torch.from_numpy(det["data"]["images"]))
    want = det["out"]
    np.testing.assert_array_equal(out.valid.numpy(), want.valid)
    assert want.valid.sum() > 4
    np.testing.assert_array_equal(out.class_ids.numpy(), want.class_ids)
    for name in ("boxes", "scores", "feats", "class_logits"):
        assert rel_err(getattr(out, name).numpy(), getattr(want, name)) < REL, \
            name
    assert out.feats.shape == (2, SMALL["max_regions"], SMALL["feat_dim"])
    assert (out.feats.numpy()[~out.valid.numpy()] == 0).all()


def test_roi_fc1_rows_are_flattened_channels_last(det):
    """roi_fc1's rows permuted from flax's (p, p, c) order to (c, p, p),
    as an NCHW flatten would need: the features change."""
    sd = detector_state_dict(det["params"])
    w = sd["roi_fc1.weight"]
    p, c = 7, SMALL["stage_channels"][-1]
    sd["roi_fc1.weight"] = w.reshape(-1, p, p, c).permute(0, 3, 1, 2).reshape(
        w.shape)
    model = Detector(DetectorConfig(**SMALL), device="cpu")
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = model(torch.from_numpy(det["data"]["images"]))
    assert rel_err(out.feats.numpy(), det["out"].feats) > 1e-2


def test_detector_loss_and_grads_match_jax(det):
    model = port_detector(det["params"])
    d = {k: torch.from_numpy(v) for k, v in det["data"].items()}
    loss, aux = model.loss(d["images"], d["gt_boxes"], d["gt_classes"],
                           d["gt_valid"])
    loss.backward()
    assert abs(loss.item() - det["loss"]) <= REL * abs(det["loss"])
    for k, v in det["aux"].items():
        assert abs(aux[k].item() - v) <= REL * max(abs(v), 1e-6), k
    grads = dict(model.named_parameters())
    assert set(grads) == set(det["grads"])
    for name, want in det["grads"].items():
        got = grads[name].grad
        assert (got - want).norm() <= REL * want.norm(), name


# ---------------------------------------------------------------------------
# mAP@0.5
# ---------------------------------------------------------------------------

def test_map50_metric_exactness():
    gt = [dict(boxes=np.array([[0, 0, 10, 10], [20, 20, 30, 30]],
                              np.float32), classes=np.array([0, 1]))]
    det = [dict(boxes=gt[0]["boxes"].copy(),
                scores=np.array([0.9, 0.8], np.float32),
                classes=np.array([0, 1]))]
    assert psyn.map50(det, gt, num_classes=2) == 1.0
    det = [dict(boxes=np.array([[6, 6, 16, 16], [20, 20, 30, 30]],
                               np.float32),
                scores=np.array([0.9, 0.8], np.float32),
                classes=np.array([0, 1]))]
    assert psyn.map50(det, gt, num_classes=2) == 0.5
    det = [dict(boxes=np.array([[0, 0, 10, 10], [0, 0, 10, 10]],
                               np.float32),
                scores=np.array([0.9, 0.8], np.float32),
                classes=np.array([0, 0]))]
    assert psyn.map50(det, [dict(boxes=gt[0]["boxes"][:1],
                                 classes=np.array([0]))],
                      num_classes=1) == 1.0
    assert psyn.map50([dict(boxes=np.zeros((0, 4), np.float32),
                            scores=np.zeros(0, np.float32),
                            classes=np.zeros(0, np.int32))], gt,
                      num_classes=2) == 0.0


def test_make_batch_is_the_jax_stream():
    want = jax_batch(np.random.RandomState(7), 3, 64)
    got = psyn.make_batch(np.random.RandomState(7), 3, 64)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# the frontend
# ---------------------------------------------------------------------------

def test_postprocess_matches_jax(det):
    """The same (JAX) outputs through both `_postprocess`: the stable
    order of the valid regions, the clip and normalisation by the unpadded
    extent, the tags."""
    out = det["out"]
    labels = {i: f"name_{i}" for i in range(SMALL["num_classes"])}
    fe = DetectionFrontend(config=DetectorConfig(**TINY), device="cpu")
    fe.labels = labels
    jself = types.SimpleNamespace(labels=labels)
    for i, (nw, nh) in enumerate([(128, 96), (77, 128)]):
        want = JaxDetectionFrontend._postprocess(jself, out, i, nw, nh)
        got = fe._postprocess(out, i, nw, nh)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
        got_t = fe._postprocess(type(out)(*(torch.from_numpy(v.copy())
                                            for v in out)), i, nw, nh)
        np.testing.assert_array_equal(got_t[0], want[0])


def write_pngs(directory, shapes, seed=1):
    from PIL import Image
    rs = np.random.RandomState(seed)
    paths = []
    for i, (h, w) in enumerate(shapes):
        p = os.path.join(directory, f"img{i}.png")
        Image.fromarray((rs.rand(h, w, 3) * 255).astype(np.uint8)).save(p)
        paths.append(p)
    return paths


def test_batch_call_equals_single_calls(tmp_path):
    paths = write_pngs(str(tmp_path), [(96, 128), (64, 64), (120, 80)])
    fe = DetectionFrontend(config=DetectorConfig(**TINY), device="cpu")
    singles = [fe(p) for p in paths]
    batched = fe.batch_call(paths, batch_size=2)
    assert len(batched) == 3
    for (f1, t1), (f2, t2) in zip(singles, batched):
        np.testing.assert_allclose(f1, f2, atol=1e-5)
        assert t1 == t2
    feats = singles[0][0]
    assert feats.shape[1] == TINY["feat_dim"] + 6 and feats.shape[0] > 0
    geo = feats[:, -6:]
    assert (geo[:, :4] >= 0).all() and (geo[:, :4] <= 1).all()
    np.testing.assert_allclose(geo[:, 4], geo[:, 2] - geo[:, 0], atol=1e-6)


def test_checkpoint_round_trip_and_refusal(tmp_path):
    paths = write_pngs(str(tmp_path), [(50, 70)])
    fe = DetectionFrontend(config=DetectorConfig(**TINY), seed=3,
                           device="cpu")
    ckpt = str(tmp_path / "ckpt")
    save_detector(ckpt, fe.config, fe.model)
    with open(os.path.join(ckpt, "detector_config.json")) as f:
        assert json.load(f) == JaxConfig(**TINY).to_dict()
    lm = str(tmp_path / "labels.json")
    with open(lm, "w") as f:
        json.dump({"label_to_idx": {f"thing{i}": i for i in range(6)}}, f)
    fe2 = load_frontend("torch:" + ckpt, label_map=lm, device="cpu")
    (f1, t1), (f2, t2) = fe(paths[0]), fe2(paths[0])
    np.testing.assert_array_equal(f1, f2)
    assert all(t.startswith("thing") for t in t2) and len(t2) == len(t1)
    with pytest.raises(FileNotFoundError, match="random weights"):
        DetectionFrontend(ckpt_dir=str(tmp_path / "nowhere"), device="cpu")
    with pytest.raises(ValueError, match="torch:<ckpt_dir>"):
        load_frontend("jax", device="cpu")


def test_train_cli_on_the_cpu(tmp_path):
    """A few steps at canvas 64: the checkpoint and its history are
    written, `load_frontend` reads it back, and the detector there equals
    the trained one."""
    out = str(tmp_path / "ck")
    res = train_cli.main(["--out_dir", out, "--steps", "4", "--canvas", "64",
                          "--batch", "4", "--platform", "cpu",
                          "--log_every", "2"])
    hist = res["loss"]
    assert len(hist) == 4 and np.isfinite(hist).all()
    with open(os.path.join(out, "train_history.json")) as f:
        assert json.load(f)["loss"] == hist
    fe = load_frontend("torch:" + out, device="cpu")
    assert fe.config.canvas == 64 and fe.config.max_regions == 16
    for k, v in res["model"].state_dict().items():
        assert torch.equal(fe.model.state_dict()[k], v), k


@pytest.mark.slow  # ~35 s: 40 steps of the default detector on the CPU
def test_train_cli_loss_falls(tmp_path):
    """40 steps at canvas 64 (the JAX twin, `tests/test_detection.py`'s
    train_cli test, is slow too): each step draws a new batch, so the mean
    of the last five losses is held below 0.9 of the first."""
    res = train_cli.main(["--out_dir", str(tmp_path / "ck"), "--steps", "40",
                          "--canvas", "64", "--batch", "4", "--platform",
                          "cpu", "--log_every", "0"])
    hist = res["loss"]
    assert np.mean(hist[-5:]) < 0.9 * hist[0], hist


def test_jax_checkpoint_conversion_recipe(det, tmp_path):
    """The README's recipe: a JAX checkpoint (`detector.msgpack`) read by
    the JAX package's `load_detector`, converted, saved as the port's
    checkpoint and served by `load_frontend`: the JAX frontend's outputs."""
    from mvp_pytorch_tpu.detection import save_detector as jax_save
    from mvp_pytorch_tpu.detection.frontend import load_detector as jax_load
    jck, pck = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_save(jck, JaxConfig(**SMALL), {"params": det["params"]})
    jcfg, params = jax_load(jck)
    cfg = DetectorConfig.from_dict(jcfg.to_dict())
    model = Detector(cfg, device="cpu")
    model.load_state_dict(detector_state_dict(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    save_detector(pck, cfg, model)
    fe = load_frontend("torch:" + pck, device="cpu")
    out = host_output(fe.detect(det["data"]["images"]))
    np.testing.assert_array_equal(out.valid, det["out"].valid)
    assert rel_err(out.feats, det["out"].feats) < REL


def test_bf16_detector_follows_the_jax_dtype(det):
    """`dtype="bfloat16"` runs the trunk and the proposal convs in bf16 (the
    map comes out bf16), the field and the features in fp32, as the JAX
    `dtype=`; the bf16 field is no further from JAX's fp32 field than 1.25
    times JAX's own bf16 field plus one bf16 ulp of its largest value."""
    import dataclasses
    cfg = JaxConfig(**dict(SMALL, dtype="bfloat16"))
    x = det["data"]["images"]
    jm32, jm16 = JaxDetector(JaxConfig(**SMALL)), JaxDetector(cfg)
    want = [np.asarray(v, np.float32) for v in jm32.apply(
        {"params": det["params"]}, jnp.asarray(x),
        method=jm32.proposal_field)[:2]]
    j16 = [np.asarray(v, np.float32) for v in jm16.apply(
        {"params": det["params"]}, jnp.asarray(x),
        method=jm16.proposal_field)[:2]]
    model = Detector(dataclasses.replace(DetectorConfig(**SMALL),
                                         dtype="bfloat16"), device="cpu")
    model.load_state_dict(detector_state_dict(det["params"]), strict=True)
    with torch.no_grad():
        obj, boxes, fmap = model.proposal_field(torch.from_numpy(x))
        out = model(torch.from_numpy(x))
    assert fmap.dtype == torch.bfloat16
    assert obj.dtype == boxes.dtype == out.feats.dtype == torch.float32
    assert out.class_logits.dtype == torch.float32
    for got, ref, j in zip((obj.numpy(), boxes.numpy()), want, j16):
        far, j_far = np.abs(got - ref).max(), np.abs(j - ref).max()
        assert far <= 1.25 * j_far + 2.0 ** -8 * np.abs(ref).max(), (far,
                                                                      j_far)


def test_runs_on_cuda_unless_asked_for_the_cpu(tmp_path):
    """The detector, its frontend, `train_cli` and the extraction tool pick
    CUDA unless told `cpu`; without a card that raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points would run on it")
    from mvp_pytorch_tpu_torch.tools import img_feat_extract
    with pytest.raises(RuntimeError, match="CUDA"):
        Detector(DetectorConfig(**TINY))
    with pytest.raises(RuntimeError, match="CUDA"):
        DetectionFrontend(config=DetectorConfig(**TINY))
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--out_dir", str(tmp_path / "ck"), "--steps", "1",
                        "--canvas", "64"])
    write_pngs(str(tmp_path), [(20, 30)])
    with pytest.raises(RuntimeError, match="CUDA"):
        img_feat_extract.main(["--image_dir", str(tmp_path), "--target_dir",
                               str(tmp_path / "out")])
