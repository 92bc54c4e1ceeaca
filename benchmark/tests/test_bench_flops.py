"""The FLOP counts of `flops/` against hand counts and against what
PyTorch's FLOP counter sees the plain reference multiply at a tiny size,
and the attention bound against the kernel table's bounds."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import generate, harness, weights
from benchmark.flops.attention import bound_s
from benchmark.flops.transformer import layers
from benchmark.reference import family
from benchmark.reference.common import Numerics, Stream
from benchmark.tests import tiny


def test_layers_hand_count():
    # 2 sequences of 3 tokens, one layer, hidden 4, feed-forward 8:
    # projections 2*6*(4*16 + 2*32) = 1536, q.k^T and p.v 4*2*9*4 = 288
    assert layers(2, 3, 1, 4, 8) == 1536 + 288


def _counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("name", ["mvptr-base.pretrain-b96",
                                  "oscar-base.pretrain-b96"])
def test_train_step_forward_count(name):
    c = tiny.cell(name)
    cfg, tr = c.config, c.traffic
    ref = family(cfg["family"])
    W = weights.make(ref.param_spec(cfg, "pretrain"), cfg, 3, "cpu")
    g = torch.Generator().manual_seed(4)
    batch = generate.pretrain_batch(cfg["family"], cfg, tr, g, "cpu")
    st = Stream(torch.Generator().manual_seed(5), 0.0, 0.0, torch.float32)
    if cfg["family"] == "two_stream":
        model = ref.TwoStream(W, cfg, Numerics())
        kw = dict(max_tag_length=tr["tag_len"], max_pred_a=tr["max_pred_a"],
                  max_pred_b=tr["max_pred_b"],
                  phrase_width=tr["phrase_width"])
    else:
        model = ref.SingleStream(W, cfg, Numerics())
        kw = dict(max_pred=tr["max_pred_a"] + tr["max_pred_b"])
    with torch.no_grad():
        n = _counted(lambda: model.pretrain_loss(batch, st, **kw))
    assert c.flops().train_step(cfg, tr) == 3 * n


def test_score_sweep_count():
    c = tiny.cell("mvptr-base.score-flickr1k")
    cfg, tr = c.config, c.traffic
    ref = family(cfg["family"])
    W = weights.make(ref.param_spec(cfg, "retrieval"), cfg, 3, "cpu")
    model = ref.TwoStream(W, cfg, Numerics())
    caps, imgs = generate.gallery(cfg, tr, torch.Generator().manual_seed(4),
                                  "cpu")
    st = Stream(None, 0.0, 0.0, torch.float32)
    t, n_img = tr["tag_len"], tr["images"]
    pairs = n_img * tr["k_i2t"] + n_img * tr["captions_per_image"] * \
        tr["k_t2i"]

    def sweep():
        txt, gt = model.encode_text(caps["input_ids_a"],
                                    caps["attention_mask_a"],
                                    caps["token_type_ids_a"], st)
        vis, gi = model.encode_image(imgs["input_ids_b"],
                                     imgs["attention_mask_b"],
                                     imgs["token_type_ids_b"],
                                     imgs["img_feats"], st)
        _ = gi @ gt.t()
        ci = torch.arange(pairs) % txt.shape[0]
        ii = torch.arange(pairs) % vis.shape[0]
        model.itm_scores(txt[ci], caps["attention_mask_a"][ci],
                         vis[ii, t:], imgs["attention_mask_b"][ii, t:])
    with torch.no_grad():
        assert c.flops().score_sweep(cfg, tr) == _counted(sweep)


# (B, L, bias, dtype, bound ms) of the port's kernel table
TABLE = [(1000, 125, True, "bfloat16", 0.2294),
         (500, 75, True, "bfloat16", 0.0688),
         (500, 70, True, "bfloat16", 0.0642),
         (96, 125, True, "bfloat16", 0.0220),
         (96, 75, True, "bfloat16", 0.0132),
         (96, 70, True, "bfloat16", 0.0123),
         (96, 145, True, "bfloat16", 0.0255),
         (1000, 125, True, "float32", 0.4587)]


@pytest.mark.parametrize("b,l,bias,dtype,ms", TABLE)
def test_attention_bound_matches_kernel_table(b, l, bias, dtype, ms):
    nbytes = b * l * 4 if bias else 0          # a [B, 1, 1, L] fp32 bias
    assert round(bound_s(b, 12, l, l, 64, dtype, nbytes) * 1e3, 4) == ms


def test_peaks_table():
    r = harness.Readings(tiny.cell("mvptr-base.pretrain-b96",
                                   "bfloat16"), {}, {}, None, {})
    assert r.peak_flops() == 989e12
