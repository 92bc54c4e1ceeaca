"""The SigLIP cell's pieces on the CPU: its FLOP counts against hand counts
and against what PyTorch's FLOP counter sees the plain reference multiply,
the attention backward's bound against a hand count, the cell's own
configuration and traffic, and the float8 control, which has to come out
as not correct under the cell's limits while the program comes out
correct (at the cell's widths, with the depth, vocabulary, image, text and
batch cut)."""

import json
import math
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness
from benchmark.calibrate import readings
from benchmark.flops import attention_bwd
from benchmark.reference import siglip as ref
from benchmark.reference.common import Numerics

CELL = "siglip-so400m.pretrain-b48"


def tiny_cell(widths: bool = False) -> harness.Cell:
    """The cell with 2 + 2 layers (1 + 1 at the cell's own widths), a
    300-row table, 56-pixel images (16 patches), 16-token text and 6 pairs;
    at hidden 72 and 4 heads of 18 unless `widths`."""
    c = harness.find_cell(CELL)
    cut = dict(num_hidden_layers=1 if widths else 2)
    if not widths:
        cut.update(hidden_size=72, intermediate_size=96,
                   num_attention_heads=4)
    c.config = {**c.config,
                "vision_config": {**c.config["vision_config"], **cut,
                                  "image_size": 56},
                "text_config": {**c.config["text_config"], **cut,
                                "vocab_size": 300,
                                "max_position_embeddings": 16}}
    c.traffic = {**c.traffic, "batch": 6, "text_len": 16,
                 "caption_tokens": [3, 12], "trace_steps": 2}
    return c


def test_train_step_hand_count():
    """B 48 at the published widths: the patch product (729 patches of 588
    values), 27 vision layers over 729 tokens, the MAP head, 27 text layers
    over 64 tokens, the text head and the 48 x 48 logits; three products a
    product in training. About 104 TFLOP a step."""
    c = harness.find_cell(CELL)
    h, inter, b = 1152, 4304, 48
    layer = lambda n, l: (2.0 * n * l * (4 * h * h + 2 * h * inter)  # noqa
                          + 4.0 * n * l * l * h)
    fwd = (2.0 * b * 729 * 588 * h + 27 * layer(b, 729)
           + 2.0 * b * h * h + 2.0 * b * 729 * h * 2 * h + 4.0 * b * 729 * h
           + 2.0 * b * h * h + 2 * 2.0 * b * h * inter
           + 27 * layer(b, 64) + 2.0 * b * h * h + 2.0 * b * b * h)
    got = c.flops().train_step(c.config, c.traffic)
    assert got == pytest.approx(3 * fwd, rel=1e-12)
    assert 1.03e14 < got < 1.05e14


def test_forward_count_matches_the_reference():
    c = tiny_cell()
    cfg, tr = c.config, c.traffic
    W = ref.make_weights(cfg, 3, "cpu")
    g = torch.Generator().manual_seed(4)
    batch = c.driver.pairs(cfg, tr, g, "cpu")
    model = ref.Siglip(W, cfg, Numerics())
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model.forward(batch)
    assert c.flops().train_step(cfg, tr) == 3 * fc.get_total_flops()


def test_attention_backward_bound_hand_count():
    """bf16 q, k, v, the output, its grad, dq, dk, dv once each, against 10
    B H Lq Lk D operations at 989 TFLOP/s: the vision tower's call (B 48,
    16 heads of 72, 729 keys) is bound by operations, the text's (64 keys)
    by bytes."""
    nbytes = 2 * 48 * 16 * 72 * (4 * 64 + 4 * 64)
    assert attention_bwd.bound_s(48, 16, 64, 64, 72, "bfloat16", 0) == \
        pytest.approx(nbytes / 3.35e12)
    ops = 10.0 * 48 * 16 * 729 * 729 * 72
    assert attention_bwd.bound_s(48, 16, 729, 729, 72, "bfloat16", 0) == \
        pytest.approx(ops / 989e12)
    # fp32 counts its three passes, as the forward's bound does
    assert attention_bwd.bound_s(48, 16, 729, 729, 72, "float32", 0) == \
        pytest.approx(3 * ops / 495e12)
    assert attention_bwd.bound_s(2, 1, 1, 1, 72, "bfloat16", 1000) == \
        pytest.approx((2 * 2 * 72 * 8 + 1000) / 3.35e12)


def test_cell_is_the_published_configuration():
    c = harness.find_cell(CELL)
    bench = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
    entry = [x for x in bench["configs"] if x["name"] == "siglip-so400m"][0]
    assert entry["reduced"] == [] == c.config["reduced"]
    for part in ("vision_config", "text_config"):
        p = c.config[part]
        assert (p["hidden_size"], p["intermediate_size"],
                p["num_hidden_layers"], p["num_attention_heads"]) == (
                    1152, 4304, 27, 16)
    v = c.config["vision_config"]
    assert (v["image_size"] // v["patch_size"]) ** 2 == 729
    n = sum(math.prod(s) for _, s, _ in ref.param_spec(c.config))
    assert 877e6 < n < 879e6
    assert c.chips == 1 and c.traffic["batch"] == 48
    assert {m["name"] for m in c.per_layer} >= {
        "vision_fwd_ms.train", "attn_bwd_roofline.train", "mfu.train",
        "attn_roofline.train"}


def test_pairs_are_seeded_captions_padded_with_the_pad_id():
    c = harness.find_cell(CELL)
    tr = {**c.traffic, "batch": 4}
    a = c.driver.pairs(c.config, tr, torch.Generator().manual_seed(2), "cpu")
    b = c.driver.pairs(c.config, tr, torch.Generator().manual_seed(2), "cpu")
    assert torch.equal(a["input_ids"], b["input_ids"])
    assert a["pixel_values"].shape == (4, 3, 384, 384)
    ids = a["input_ids"]
    assert ids.shape == (4, 64)
    words = (ids != 1).sum(1)
    assert ((words >= 8) & (words <= 40)).all()
    assert ids.max() < 32000 and ids.min() >= 0


def _fails(numbers, limits):
    correct, _ = harness.compare(numbers, limits)
    return not correct


def test_control_fails_tiny():
    """The float8 control (the reference with every product's operands in
    float8 e4m3) at the cell's widths, 1 + 1 layers: the program passes
    the cell's limits, the control does not."""
    c = tiny_cell(widths=True)
    program, control = (line["numbers"] for line in
                        readings(c, 2 ** 31 + 5, "cpu", 0.3, "control"))
    assert not _fails(program, c.limits), program
    assert _fails(control, c.limits), control
