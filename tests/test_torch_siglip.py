"""SigLIP on the port (`models/siglip.py`, `layers.PreLNLayer`,
`tasks/pretrain.py::siglip_loss_fn` and its command line) against the plain
float32 reference of the benchmark (`benchmark/reference/siglip.py`) on
seeded weights, at a tiny size on the CPU: hidden 72, 4 heads of 18, 2 + 2
layers, 56-pixel images of 14-pixel patches (16 tokens), 16-token text.

The port runs in float32 here unless a test says otherwise. Its products
and the reference's are the same float32 functions summed in other orders,
so the tolerances below are a few float32 roundings carried through the
depth; computing the reference's products in bf16 misses them
(`test_bf16_products_miss_the_float32_tolerance`)."""

import json
import math

import pytest
import torch

from benchmark.reference import siglip as ref
from benchmark.reference.adamw import AdamW as RefAdamW
from benchmark.reference.common import Numerics
from mvp_pytorch_tpu_torch.models.layers import PreLNLayer
from mvp_pytorch_tpu_torch.models.siglip import (MAPHead, SiglipConfig,
                                                 SiglipModel)
from mvp_pytorch_tpu_torch.ops.attention import plain_attention
from mvp_pytorch_tpu_torch.tasks import pretrain
from mvp_pytorch_tpu_torch.training import profiler
from mvp_pytorch_tpu_torch.training.optim import make_optimizer
from mvp_pytorch_tpu_torch.training.trainer import Trainer
from torch_flags import WORKERS

TINY = {
    "text_config": {"vocab_size": 300, "hidden_size": 72,
                    "intermediate_size": 96, "num_hidden_layers": 2,
                    "num_attention_heads": 4, "max_position_embeddings": 16,
                    "layer_norm_eps": 1e-6, "pad_token_id": 1},
    "vision_config": {"hidden_size": 72, "intermediate_size": 96,
                      "num_hidden_layers": 2, "num_attention_heads": 4,
                      "num_channels": 3, "image_size": 56, "patch_size": 14,
                      "layer_norm_eps": 1e-6},
    # weights wider than the published init's 0.02, so that attention and
    # the MAP probe are far from uniform at this width
    "initializer_range": 0.1, "dtype": "float32"}
B = 6
# embeddings and logits: float32 functions in another summation order, a
# few roundings (2^-24) through 2 + 2 layers, the head and the norms
EMB_ATOL = 2e-6
# the loss (about 10 here, B terms of B pairs summed): a few float32 ulps
LOSS_RTOL = 1e-6
# each leaf's gradient, relative in its norm: the backward's roundings
# through the same depth
GRAD_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    """torch single-threaded in this process: no intra-op thread pool is left
    behind for a later test in the same worker that forks."""
    torch.set_num_threads(1)


def seeded(seed=7, **cfg):
    """(config dict, reference weights, the port's model holding them)."""
    cfg = {**TINY, **cfg}
    W = ref.make_weights(cfg, seed, "cpu")
    model = SiglipModel(SiglipConfig.from_dict(cfg), device="cpu", seed=1)
    model.load_state_dict(W, strict=True)
    return cfg, W, model


def batch(seed=3, b=B):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, TINY["text_config"]["vocab_size"], (b, 16),
                        generator=g)
    ids[:, 10:] = TINY["text_config"]["pad_token_id"]     # padded, no mask
    return {"pixel_values": torch.randn(b, 3, 56, 56, generator=g),
            "input_ids": ids}


def rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def moving(name, t):
    """The part of a leaf whose gradient the mathematics does not zero: a
    key's bias adds one constant to every score of a query, which the
    softmax takes away, so its gradient (and `in_proj_bias`'s key rows) is
    rounding alone, and Adam turns that into steps of about the lr."""
    if name.endswith("k_proj.bias"):
        return t[:0]
    if name.endswith("in_proj_bias"):
        h = t.shape[0] // 3
        return torch.cat([t[:h], t[2 * h:]])
    return t


def test_parameters_are_the_published_ones():
    """The port's parameters are the reference's spec, name for name and
    shape for shape; at the published so400m/14-384 sizes the spec holds
    about 878 M parameters."""
    cfg, W, model = seeded()
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == {
        n: tuple(s) for n, s, _ in ref.param_spec(cfg)}
    full = json.load(open("benchmark/configs/siglip-so400m.json"))
    n = sum(math.prod(s) for _, s, _ in ref.param_spec(full))
    assert 877e6 < n < 879e6, n
    assert SiglipConfig.from_dict(full).vision_config.num_patches == 729


def test_embeddings_logits_and_loss_match_the_reference():
    cfg, W, model = seeded()
    b = batch()
    with torch.no_grad():
        out = model(b["pixel_values"], b["input_ids"])
        img, txt, logits, loss = ref.Siglip(W, cfg, Numerics()).forward(b)
    torch.testing.assert_close(out.image_embeds, img, atol=EMB_ATOL, rtol=0)
    torch.testing.assert_close(out.text_embeds, txt, atol=EMB_ATOL, rtol=0)
    # logits are 10 x.y - 10: ten times the embeddings' tolerance
    torch.testing.assert_close(out.logits_per_text, logits,
                               atol=10 * EMB_ATOL, rtol=0)
    assert out.loss.item() == pytest.approx(loss.item(), rel=LOSS_RTOL)
    # the initial t = log 10, b = -10: every pair scores near -10
    assert (logits + 10.0).abs().max() < 10.0 + 1e-4


def test_every_gradient_matches_the_reference():
    cfg, W, model = seeded()
    b = batch()
    model.train()
    model(b["pixel_values"], b["input_ids"]).loss.backward()
    Wr = {k: v.clone().requires_grad_(True) for k, v in W.items()}
    loss = ref.Siglip(Wr, cfg, Numerics()).pretrain_loss(b)["loss"]
    want = dict(zip(Wr, torch.autograd.grad(loss, list(Wr.values()))))
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    top = max(g.abs().max() for g in want.values())
    for name, p in got.items():
        assert p.grad is not None, name
        a, b = moving(name, p.grad), moving(name, want[name])
        if b.numel():
            assert rel(a, b) <= GRAD_RTOL, (name, rel(a, b))
        # the zeroed parts: rounding, far below every other gradient
        assert p.grad.abs().sum() - a.abs().sum() <= 1e-5 * top, name


def test_three_adamw_steps_match_the_reference():
    """Three `Trainer.step`s with `siglip_loss_fn` under the port's AdamW
    (the cell's betas, decay and clip, a larger lr so that three steps move
    every leaf) against plain AdamW over the reference's gradients."""
    cfg, W, model = seeded()
    lr, b2, wd = 1e-3, 0.95, 1e-4
    opt = make_optimizer(model, lr, schedule="constant", weight_decay=wd,
                         b2=b2, max_grad_norm=1.0)
    trainer = Trainer(model, pretrain.siglip_loss_fn(), opt, seed=5)
    Wr = {k: v.clone().requires_grad_(True) for k, v in W.items()}
    rmodel = ref.Siglip(Wr, cfg, Numerics())
    ropt = RefAdamW(Wr, lr, b2=b2, weight_decay=wd, max_grad_norm=1.0)
    for s in range(3):
        bt = batch(seed=10 + s)
        out = trainer.step(bt)
        scale = math.exp(Wr["logit_scale"].item())   # as this step read it
        loss = rmodel.pretrain_loss(bt)["loss"]
        ropt.step(dict(zip(Wr, torch.autograd.grad(loss, list(Wr.values())))))
        assert out["loss"] == pytest.approx(loss.item(), rel=1e-5)
        assert out["logit_scale"] == pytest.approx(scale, rel=1e-6)
    for name, p in model.named_parameters():
        change = moving(name, p.detach() - W[name])
        want = moving(name, Wr[name].detach() - W[name])
        # Adam divides by sqrt(nu): a leaf's change carries its gradients'
        # relative error (GRAD_RTOL) through three steps
        if want.numel():
            assert rel(change, want) <= 10 * GRAD_RTOL, (name,
                                                         rel(change, want))


def test_map_head_alone_matches_the_reference():
    """The probe's attention over every token (Lq 1), the LayerNorm and MLP
    on its residual, pooled to one row."""
    cfg, W, _ = seeded()
    head = MAPHead(SiglipConfig.from_dict(cfg).vision_config, torch.float32)
    pre = "vision_model.head."
    head.load_state_dict({k[len(pre):]: v for k, v in W.items()
                          if k.startswith(pre)}, strict=True)
    x = torch.randn(B, 16, 72, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        got = head(x)
    want = ref.Siglip(W, cfg, Numerics()).map_head(x, cfg["vision_config"])
    assert got.shape == (B, 72)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def test_pre_ln_layer_alone_matches_the_reference():
    """x + attn(LN1(x)), then + mlp(LN2(.)), in float32 and in bf16 (the
    residual stream in bf16, LayerNorm statistics in float32: within bf16
    roundings, 2^-8 of the values)."""
    cfg, W, _ = seeded()
    pre = "vision_model.encoder.layers.0."
    sd = {k[len(pre):]: v for k, v in W.items() if k.startswith(pre)}
    x = torch.randn(B, 16, 72, generator=torch.Generator().manual_seed(6))
    want = ref.Siglip(W, cfg, Numerics()).layer(
        pre[:-1], x, cfg["vision_config"])
    for dt, atol in ((torch.float32, 2e-6), (torch.bfloat16, 0.06)):
        layer = PreLNLayer(72, 4, 96, 1e-6, dt)
        layer.load_state_dict(sd, strict=True)
        with torch.no_grad():
            got = layer(x.to(dt))
        assert got.dtype == dt
        torch.testing.assert_close(got.float(), want, atol=atol, rtol=0)


class _Bf16(Numerics):
    """The reference with every product's operands rounded to bf16 (a
    precision below the configuration's float32 here)."""

    def q(self, x):
        return x + (x.detach().to(torch.bfloat16).float() - x.detach())


def test_bf16_products_miss_the_float32_tolerance():
    """The tolerances above are tight enough to tell float32 products from
    bf16 ones: the float32 reference meets them against the port, the same
    reference computing its products in bf16 misses them."""
    cfg, W, model = seeded()
    b = batch()
    with torch.no_grad():
        out = model(b["pixel_values"], b["input_ids"])
        f32 = ref.Siglip(W, cfg, Numerics()).forward(b)
        low = ref.Siglip(W, cfg, _Bf16()).forward(b)
    assert (out.image_embeds - f32[0]).abs().max() <= EMB_ATOL
    assert (out.image_embeds - low[0]).abs().max() > 10 * EMB_ATOL
    assert abs(out.loss.item() - f32[3].item()) <= LOSS_RTOL * f32[3].item()
    assert abs(out.loss.item() - low[3].item()) > LOSS_RTOL * f32[3].item()


def test_mixed_bf16_model_tracks_the_reference():
    """The configuration's mixed bf16 (bf16 products and residual stream,
    float32 LayerNorm statistics, norms and loss) stays within bf16
    roundings of the float32 reference: the loss within 1e-3 relative,
    each embedding's cosine with the reference's above 0.999."""
    cfg, W, model = seeded(dtype="bfloat16")
    b = batch()
    with torch.no_grad():
        out = model(b["pixel_values"], b["input_ids"])
        img, txt, _, loss = ref.Siglip(W, cfg, Numerics()).forward(b)
    assert out.image_embeds.dtype == out.logits_per_text.dtype == torch.float32
    assert out.loss.item() == pytest.approx(loss.item(), rel=1e-3)
    for got, want in ((out.image_embeds, img), (out.text_embeds, txt)):
        assert (got * want).sum(-1).min() > 0.999


def test_training_step_holds_the_siglip_spans():
    """A `Trainer` step's record holds `siglip.vision`, `.text` and `.loss`
    (inside `trainer.forward`, whose host time they share), and its
    forward calls the attention once a layer of each tower and once for the
    MAP probe (2 + 2 + 1 here; 27 + 27 + 1 = 55 at so400m)."""
    cfg, W, model = seeded()
    opt = make_optimizer(model, 1e-4, schedule="constant")
    calls = plain_attention.calls
    Trainer(model, pretrain.siglip_loss_fn(), opt, seed=1).step(batch())
    assert plain_attention.calls - calls == 5
    rec = profiler.records("train_step")[-1]
    for span in ("siglip.vision", "siglip.text", "siglip.loss",
                 "trainer.forward"):
        assert rec.spans[span][0] == 1, span
    inner = sum(rec.spans[s][1] for s in ("siglip.vision", "siglip.text",
                                          "siglip.loss"))
    assert inner <= rec.spans["trainer.forward"][1]


def test_synthetic_fetch_draws_seeded_pairs():
    cfg = SiglipConfig.from_dict(TINY)
    fetch = pretrain.SiglipSyntheticFetch(cfg, seed=9)
    a, b = fetch([3, 4]), fetch([4], epoch=2)
    assert a["pixel_values"].shape == (2, 3, 56, 56)
    assert a["input_ids"].shape == (2, 16)
    assert (a["input_ids"][1] == b["input_ids"][0]).all()
    ids = a["input_ids"]
    n = (ids != 1).sum(1)                     # 8 or more words, then pads
    assert (n >= 8).all() and ids.max() < 300
    for row, words in zip(ids, n):
        assert (row[:words] != 1).all() and (row[words:] == 1).all()


def test_cli_trains_a_tiny_siglip_config(tmp_path):
    """`tasks.pretrain --siglip_config ... --synthetic` trains SigLIP through
    the TrainLoop and writes a checkpoint whose config is SigLIP's."""
    path = tmp_path / "siglip.json"
    path.write_text(json.dumps(TINY))
    out = pretrain.main([
        "--output_dir", str(tmp_path / "run"), "--siglip_config", str(path),
        "--synthetic", "--platform", "cpu", "--dtype", "float32",
        "--max_steps", "3", "--train_batch_size", "4", "--ckpt_period", "3",
        "--scheduler", "constant", "--learning_rate", "1e-3"]
        + WORKERS + ["1"])
    losses = [m["loss"] for m in out["train"]]
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    saved = list((tmp_path / "run").rglob("config.json"))
    assert saved and json.load(open(saved[0]))["model_type"] == "siglip"
    with pytest.raises(ValueError, match="--synthetic"):
        pretrain.main(["--output_dir", str(tmp_path / "no"),
                       "--siglip_config", str(path), "--platform", "cpu"])
