"""The port's backbone and retrieval path against the torch reference's frozen
golden outputs and against the JAX package, in fp32 on the CPU.

Tolerances are those of tests/test_golden_fixture.py: atol 2e-4 for the
stream outputs, global embeddings and similarities, 5e-4 for fused outputs
and what is computed from them, rtol 1e-3. Parameters come from the golden
fixture (the `bert` subtree) plus a numpy-seeded classifier; the JAX outputs
are computed once per module, with eager `apply` and no flax `init`.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvp_pytorch_tpu.models import ModelConfig as JaxConfig
from mvp_pytorch_tpu.models.tasks import RetrievalModel as JaxRetrieval
from mvp_pytorch_tpu.tasks import retrieval_eval as jax_eval
from mvp_pytorch_tpu_torch.convert import load_jax_params
from mvp_pytorch_tpu_torch.models import BiEncoder, ModelConfig, RetrievalModel
from mvp_pytorch_tpu_torch.tasks import retrieval_eval as port_eval
from mvp_pytorch_tpu_torch.tasks.retrieval import two_stage_scoring

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "golden")
STREAM = dict(atol=2e-4, rtol=1e-3)
FUSED = dict(atol=5e-4, rtol=1e-3)


def unflatten(flat):
    tree = {}
    for k, v in flat.items():
        parts = k.split("/")
        t = tree
        for p in parts[:-1]:
            t = t.setdefault(p, {})
        t[parts[-1]] = v
    return tree


@pytest.fixture(scope="module", autouse=True)
def fp32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def golden():
    params = unflatten(dict(np.load(os.path.join(FIX, "params.npz"))))
    inputs = dict(np.load(os.path.join(FIX, "inputs.npz")))
    expected = dict(np.load(os.path.join(FIX, "expected.npz")))
    with open(os.path.join(FIX, "config.json")) as f:
        cfg_kw = json.load(f)
    mt = cfg_kw.pop("max_tag_length")
    return params, inputs, expected, cfg_kw, mt


def retrieval_params(golden_params):
    """The golden `bert` subtree plus a seeded classifier and logit_scale."""
    r = np.random.RandomState(7)
    h = golden_params["bert"]["pooler"]["dense"]["kernel"].shape[0]
    return {"bert": golden_params["bert"],
            "classifier": {"out": {
                "kernel": r.randn(h, 2).astype(np.float32),
                "bias": r.randn(2).astype(np.float32)}},
            "logit_scale": np.asarray(np.log(1 / 0.07), np.float32)}


def synthetic_set(n_img=4, cpi=3, la=9, t=6, r_=5, img_dim=22, seed=11):
    """Continuous, padded inputs: no two captions or images alike."""
    rs = np.random.RandomState(seed)
    n_cap = n_img * cpi
    mask_a = np.ones((n_cap, la), np.int64)
    mask_a[1::2, la - 2:] = 0
    mask_b = np.ones((n_img, t + r_), np.int64)
    mask_b[1, t + r_ - 2:] = 0
    caps = dict(input_ids_a=rs.randint(1, 99, (n_cap, la)).astype(np.int64),
                attention_mask_a=mask_a,
                token_type_ids_a=np.zeros((n_cap, la), np.int64))
    imgs = dict(input_ids_b=rs.randint(1, 99, (n_img, t)).astype(np.int64),
                attention_mask_b=mask_b,
                token_type_ids_b=np.ones((n_img, t), np.int64),
                img_feats=rs.randn(n_img, r_, img_dim).astype(np.float32))
    return caps, imgs


@pytest.fixture(scope="module")
def models(golden):
    params, _, _, cfg_kw, mt = golden
    full = retrieval_params(params)
    port = RetrievalModel(ModelConfig(**cfg_kw), device="cpu")
    load_jax_params(port, full)
    jax_model = JaxRetrieval(JaxConfig(**cfg_kw))
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, full)}
    return port, jax_model, variables, mt


def jax_apply(models, method, *args, **kw):
    _, jm, variables, _ = models
    return jm.apply(variables, *(jnp.asarray(a) for a in args),
                    method=getattr(JaxRetrieval, method), **kw)


def port_apply(models, method, *args, **kw):
    port = models[0]
    with torch.no_grad():
        return getattr(port, method)(*(torch.from_numpy(np.asarray(a))
                                       for a in args), **kw)


def test_backbone_golden(golden):
    """BiEncoder.forward on the golden inputs against the real torch
    reference's frozen outputs."""
    params, inputs, exp, cfg_kw, mt = golden
    model = BiEncoder(ModelConfig(**cfg_kw))
    load_jax_params(model, params["bert"])
    names = ("input_ids_a", "attention_mask_a", "token_type_ids_a",
             "input_ids_b", "attention_mask_b", "token_type_ids_b",
             "img_feats")
    with torch.no_grad():
        out = model(*(torch.from_numpy(inputs[n]) for n in names),
                    max_tag_length=mt)
    for got, key, tol in ((out.txt_output, "txt", STREAM),
                          (out.vis_output, "vis", STREAM),
                          (out.sim_mat, "sim", STREAM),
                          (out.sequence_output, "seq", FUSED),
                          (out.pooled_output, "pooled", FUSED)):
        np.testing.assert_allclose(got.numpy(), exp[key], **tol,
                                   err_msg=key)


@pytest.fixture(scope="module")
def retrieval_outputs(models):
    """Each inference method's outputs on both sides, computed once."""
    caps, imgs = synthetic_set()
    mt = models[3]
    a = (caps["input_ids_a"], caps["attention_mask_a"],
         caps["token_type_ids_a"])
    b = (imgs["input_ids_b"], imgs["attention_mask_b"],
         imgs["token_type_ids_b"], imgs["img_feats"])
    n = 4   # the first caption of each image with its image: pairwise calls
    pair_a = tuple(x[::3][:n] for x in a)
    out = {}
    for side, apply in (("jax", jax_apply), ("port", port_apply)):
        txt_seq, txt_glob = apply(models, "encode_text_full", *a)
        vis, vis_mask, img_glob = apply(models, "encode_image_full", *b,
                                        max_tag_length=mt)
        ts, tm = np.asarray(txt_seq)[::3][:n], caps["attention_mask_a"][::3][:n]
        cached = apply(models, "score_cached", ts, tm, np.asarray(vis),
                       np.asarray(vis_mask))
        score = apply(models, "score", *pair_a, *b, max_tag_length=mt)
        enc = apply(models, "encode", *pair_a, *b)
        out[side] = {
            "txt_seq": (txt_seq, STREAM), "txt_glob": (txt_glob, STREAM),
            "vis": (vis, STREAM), "vis_mask": (vis_mask, STREAM),
            "img_glob": (img_glob, STREAM), "score_cached": (cached, FUSED),
            "score": (score, FUSED), "encode_txt": (enc[0], STREAM),
            "encode_img": (enc[1], STREAM)}
    return out


@pytest.mark.parametrize("name", ["txt_seq", "txt_glob", "vis", "vis_mask",
                                  "img_glob", "score_cached", "score",
                                  "encode_txt", "encode_img"])
def test_retrieval_methods_match_jax(retrieval_outputs, name):
    want, tol = retrieval_outputs["jax"][name]
    got, _ = retrieval_outputs["port"][name]
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), **tol)


def jax_two_stage(models, caps, imgs, cpi, k_i2t, k_t2i):
    """The default branch of the JAX two_stage_eval, eagerly, on one batch."""
    mt = models[3]
    txt_seq, txt_glob = jax_apply(
        models, "encode_text_full", caps["input_ids_a"],
        caps["attention_mask_a"], caps["token_type_ids_a"])
    vis, vis_mask, img_glob = jax_apply(
        models, "encode_image_full", imgs["input_ids_b"],
        imgs["attention_mask_b"], imgs["token_type_ids_b"],
        imgs["img_feats"], max_tag_length=mt)
    sims = np.asarray(img_glob @ txt_glob.T)
    n_img, n_cap = sims.shape
    i2t, t2i = jax_eval.coarse_candidates(sims, k_i2t, k_t2i)
    cap_idx = np.concatenate([i2t.reshape(-1), np.repeat(np.arange(n_cap), k_t2i)])
    img_idx = np.concatenate([np.repeat(np.arange(n_img), k_i2t), t2i.reshape(-1)])
    logits = jax_apply(models, "score_cached", np.asarray(txt_seq)[cap_idx],
                       caps["attention_mask_a"][cap_idx],
                       np.asarray(vis)[img_idx], np.asarray(vis_mask)[img_idx])
    scores = np.asarray(jax.nn.softmax(logits, axis=-1)[:, 1])
    coarse = jax_eval.evaluate_ranks(*jax_eval.coarse_ranks(sims, cpi))
    fine = jax_eval.evaluate_ranks(
        jax_eval.mask_shortlist_misses(jax_eval.fine_ranks_i2t(
            scores[:n_img * k_i2t].reshape(n_img, k_i2t), i2t, cpi), k_i2t),
        jax_eval.mask_shortlist_misses(jax_eval.fine_ranks_t2i(
            scores[n_img * k_i2t:].reshape(n_cap, k_t2i), t2i, cpi), k_t2i))
    return {"coarse": coarse, "fine": fine, "i2t_cands": i2t,
            "t2i_cands": t2i, "scores": scores}


def test_two_stage_scoring_matches_jax(models):
    """4 images x 3 captions, K = 2: the same candidates, scores and R@K as
    the JAX algebra; ragged encoder and pair batches."""
    caps, imgs = synthetic_set()
    want = jax_two_stage(models, caps, imgs, 3, 2, 2)
    got = two_stage_scoring(models[0], caps, imgs, 3, 2, 2, enc_batch=5,
                            pair_batch=7, max_tag_length=models[3])
    np.testing.assert_array_equal(got["i2t_cands"], want["i2t_cands"])
    np.testing.assert_array_equal(got["t2i_cands"], want["t2i_cands"])
    np.testing.assert_allclose(got["scores"], want["scores"], **FUSED)
    assert got["n_pairs"] == 4 * 2 + 12 * 2
    assert got["coarse"] == want["coarse"]
    assert got["fine"] == want["fine"]
    assert set(got["seconds"]) == {"encode_text", "encode_image", "coarse",
                                   "rerank", "ranks"}


def _rank_inputs(seed):
    """A sims matrix with ties (rounded) and fine scores with shortlist
    misses, for 6 images x 2 captions."""
    r = np.random.RandomState(seed)
    sims = np.round(r.rand(6, 12), 1).astype(np.float32)
    cand_caps = r.randint(0, 12, (6, 3))
    cand_imgs = r.randint(0, 6, (12, 3))
    scores_i = np.round(r.rand(6, 3), 1)
    scores_t = np.round(r.rand(12, 3), 1)
    return sims, cand_caps, cand_imgs, scores_i, scores_t


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rank_functions_match_jax_package(seed):
    sims, cand_caps, cand_imgs, scores_i, scores_t = _rank_inputs(seed)
    for x, y in zip(port_eval.coarse_ranks(sims, 2),
                    jax_eval.coarse_ranks(sims, 2)):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(port_eval.coarse_candidates(sims, 3, 2),
                    jax_eval.coarse_candidates(sims, 3, 2)):
        np.testing.assert_array_equal(x, y)
    fi = port_eval.fine_ranks_i2t(scores_i, cand_caps, 2)
    np.testing.assert_array_equal(
        fi, jax_eval.fine_ranks_i2t(scores_i, cand_caps, 2))
    ft = port_eval.fine_ranks_t2i(scores_t, cand_imgs, 2)
    np.testing.assert_array_equal(
        ft, jax_eval.fine_ranks_t2i(scores_t, cand_imgs, 2))
    np.testing.assert_array_equal(port_eval.mask_shortlist_misses(fi, 3),
                                  jax_eval.mask_shortlist_misses(fi, 3))
    assert port_eval.evaluate_ranks(fi, ft) == jax_eval.evaluate_ranks(fi, ft)
    assert (port_eval.recall_at_k(ft, (1, 2))
            == jax_eval.recall_at_k(ft, (1, 2)))


def test_bf16_forward_tracks_fp32(golden):
    """bf16 compute over the same fp32 params stays within bf16 resolution
    of the fp32 path (the held-against-fp32 rule of tests/test_models.py)."""
    params, _, _, cfg_kw, mt = golden
    full = retrieval_params(params)
    caps, imgs = synthetic_set()
    outs = {}
    for dt in ("float32", "bfloat16"):
        m = RetrievalModel(ModelConfig(**cfg_kw, dtype=dt), device="cpu")
        load_jax_params(m, full)
        assert m.bert.txt_proj.dtype == torch.float32
        with torch.no_grad():
            seq, glob = m.encode_text_full(
                *(torch.from_numpy(caps[k]) for k in
                  ("input_ids_a", "attention_mask_a", "token_type_ids_a")))
        assert seq.dtype == (torch.bfloat16 if dt == "bfloat16"
                             else torch.float32)
        assert glob.dtype == torch.float32
        outs[dt] = (seq.float(), glob)
    torch.testing.assert_close(outs["bfloat16"][1], outs["float32"][1],
                               atol=0.05, rtol=0)
    torch.testing.assert_close(outs["bfloat16"][0], outs["float32"][0],
                               atol=0.1, rtol=0)


def test_cuda_requested_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: CUDA is not missing here")
    from mvp_pytorch_tpu_torch.models import tiny_config
    with pytest.raises(RuntimeError, match="CUDA"):
        RetrievalModel(tiny_config())


def test_config_mirrors_jax():
    """The same JSON keys and defaults as the JAX package's ModelConfig."""
    import dataclasses
    from mvp_pytorch_tpu_torch.models import tiny_config
    from mvp_pytorch_tpu.models.config import tiny_config as jax_tiny
    jax_fields = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    port_fields = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    assert port_fields == jax_fields
    assert (dataclasses.asdict(tiny_config())
            == dataclasses.asdict(jax_tiny()))
    cfg = ModelConfig.from_dict({"hidden_size": 64, "unknown_key": 1},
                                num_attention_heads=8)
    assert (cfg.hidden_size, cfg.head_dim, cfg.half_layers) == (64, 8, 6)


def test_stream_encoder_bias_list_and_mid_readout(golden):
    """A per-layer bias list equal to the shared bias gives the same output,
    and `return_at_layer` reads the output of that layer."""
    from mvp_pytorch_tpu_torch.models.layers import mask_to_bias
    params, _, _, cfg_kw, _ = golden
    model = BiEncoder(ModelConfig(**cfg_kw))
    load_jax_params(model, params["bert"])
    r = np.random.RandomState(5)
    x = torch.from_numpy(r.randn(2, 6, 32).astype(np.float32))
    mask = torch.ones(2, 6, dtype=torch.int64)
    mask[1, 4:] = 0
    bias = mask_to_bias(mask)
    enc = model.mul_encoder
    with torch.no_grad():
        out, mid = enc(x, bias, return_at_layer=0)
        out_list, none = enc(x, [bias, bias])
        first = enc.layer[0](x, bias)
    torch.testing.assert_close(out_list, out, rtol=0, atol=0)
    torch.testing.assert_close(mid, first, rtol=0, atol=0)
    assert none is None
    with pytest.raises(ValueError):
        enc(x, [bias])


def test_attention_dropout_takes_the_plain_path_in_training():
    from mvp_pytorch_tpu_torch.models import tiny_config
    from mvp_pytorch_tpu_torch.models.layers import SelfAttention
    torch.manual_seed(0)
    layer = SelfAttention(tiny_config(attention_probs_dropout_prob=0.5))
    x = torch.randn(2, 5, 32)
    with torch.no_grad():
        layer.eval()
        ref = layer(x, None)
        layer.train()
        dropped = layer(x, None)
    assert torch.isfinite(dropped).all()
    assert not torch.allclose(dropped, ref)


def test_mlp_classifier_is_initialised_from_the_seed():
    from mvp_pytorch_tpu_torch.models import tiny_config
    cfg = tiny_config(classifier="mlp")
    a = RetrievalModel(cfg, device="cpu", seed=3).state_dict()
    b = RetrievalModel(cfg, device="cpu", seed=3).state_dict()
    assert set(a) == set(b)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    w = a["classifier.0.weight"]
    assert abs(float(w.std()) - cfg.initializer_range) < 0.005
    assert float(a["classifier.2.bias"].abs().max()) == 0.0
