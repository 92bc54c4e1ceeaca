"""Load the JAX package's flax params into the port.

A flax params tree (nested dicts or a flat dict with "/"-joined paths, as
numpy arrays) maps onto the reference's torch state-dict keys, which the
port's modules carry: dense kernels are transposed to torch's [out, in],
LayerNorm `scale` becomes `weight`, embedding tables and the raw `[H, H]`
global projections load as they are. The mapping is this package's own copy
of the JAX package's `convert.export_state_dict` rules, for the retrieval
model (`bert`, `classifier`, `logit_scale`), the pretraining model (also
`cls_predictions`, `half_mlm`, `cls_seq_relationship` and, where the tree has
them, `qa_head` and `qa_seq_relation`), the single-pair task models
(`ClassificationModel`, `ClassificationPlusModel`, `VQAModel`, `REModel`)
and the single-stream models (`ImgBertModel`'s `bert/encoder`, its
`code_embeddings`, and `ImgBertForPreTraining`'s masked-region heads
`mrf_mrc/{mrf_dense, mrf_norm, mrc, mrf_bias}`, which become
`cls.MRF_predictor.0.*`, `cls.MRF_predictor.2.*`, `cls.MRC_predictor.*` and
`cls.MRF_bias`), and the captioning model (`bert` and
`cls_predictions`, whose `bias` spans the whole vocabulary).
The tied LM decoders have no params in a flax tree; the models'
`load_state_dict` (`BiPretrainModel`, `ImgBertForPreTraining`,
`CaptioningModel`) check the reference's `decoder.weight` copies against
the word table and drop them. VQA's untied decoder (`cls/decoder/kernel`)
loads as `cls.predictions.decoder.weight`.

The JAX exporter has no rule for `ClassificationPlusModel`'s flax
`nn.Sequential` names, so the port names them itself: `single_mapping/
layers_0|layers_2` become `single_mapping.0/.2`, and an mlp classifier's
`classifier/layers_0|layers_2` become `classifier.0/.2`; its linear
classifier (`classifier/{kernel,bias}`) becomes `classifier.weight/bias`.
A `ClassifierHead`'s `classifier/dense` and `classifier/out` become
`classifier.0` and `classifier.2` (mlp) or `classifier.weight/bias`.

The JAX exporter has no rule for MoE leaves either, so the port names them
itself: an encoder layer's `moe/wi` [E, H, F] and `moe/wo` [E, F, H] load as
`...layer.{i}.moe.wi` / `.moe.wo` as they are (the flax layout), and
`moe/router/kernel` [H, E] as `...moe.router.weight` [E, H]. A tree in the
stacked layout of a `pipeline_stages > 0` config (`layers/layer` leaves with
a leading layer dimension) is unstacked into per-layer keys first
(`parallel.pipeline.unstack_model_params`).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

# flax sub-path inside an encoder layer -> (torch key, leaf kind)
_LAYER_SUFFIX = {
    ("attention", "self", "query"): ("attention.self.query", "dense"),
    ("attention", "self", "key"): ("attention.self.key", "dense"),
    ("attention", "self", "value"): ("attention.self.value", "dense"),
    ("attention", "output_dense"): ("attention.output.dense", "dense"),
    ("attention", "output_norm"): ("attention.output.LayerNorm", "norm"),
    ("intermediate_dense",): ("intermediate.dense", "dense"),
    ("output_dense",): ("output.dense", "dense"),
    ("output_norm",): ("output.LayerNorm", "norm"),
    ("moe", "router"): ("moe.router", "dense"),
}

_ENCODERS = ("txt_encoder", "vis_encoder", "mul_encoder", "encoder")
# the single-stream pretraining model's masked-region heads (flax
# `mrf_mrc/<name>`) -> (torch key under `cls`, leaf kind)
_MRF_MRC = {"mrf_dense": ("cls.MRF_predictor.0", "dense"),
            "mrf_norm": ("cls.MRF_predictor.2", "norm"),
            "mrc": ("cls.MRC_predictor", "dense")}
# flax LM head -> its torch prefix
_LM_HEADS = {"cls_predictions": "cls.predictions", "half_mlm": "half_mlm",
             "cls": "cls.predictions"}          # the last: VQA's QA head


def _flatten(tree: Mapping[str, Any], prefix=()) -> Iterator[Tuple[tuple, np.ndarray]]:
    for k in sorted(tree):
        v = tree[k]
        path = prefix + tuple(k.split("/"))
        if isinstance(v, Mapping):
            yield from _flatten(v, path)
        else:
            yield path, np.asarray(v)


def _leaf(kind: str, leaf: str, val: np.ndarray):
    """flax leaf -> (torch suffix, value)."""
    if kind == "norm":
        return {"scale": "weight", "bias": "bias"}[leaf], val
    if kind == "dense":
        if leaf == "kernel":
            return "weight", val.T
        if leaf == "bias":
            return "bias", val
    raise KeyError(f"unknown {kind} leaf {leaf!r}")


def _torch_key(path: tuple, val: np.ndarray, mlp_classifier: bool):
    """One flax path -> (torch key, value), or KeyError if it has no place."""
    if path == ("logit_scale",):
        return "logit_scale", val
    if path[0] in _LM_HEADS:
        base, p = _LM_HEADS[path[0]], path[1:]
        if p == ("bias",):
            return f"{base}.bias", val
        if p == ("decoder", "kernel"):           # QAPredictionHead, untied
            return f"{base}.decoder.weight", val.T
        if len(p) == 3 and p[0] == "transform" and p[1] in ("dense",
                                                            "LayerNorm"):
            kind = "dense" if p[1] == "dense" else "norm"
            suf, val = _leaf(kind, p[2], val)
            return f"{base}.transform.{p[1]}.{suf}", val
    if path[:2] == ("cls_seq_relationship", "seq_relationship") \
            and len(path) == 3:
        suf, val = _leaf("dense", path[2], val)
        return f"cls.seq_relationship.{suf}", val
    if path == ("mrf_mrc", "mrf_bias"):
        return "cls.MRF_bias", val
    if path[0] == "mrf_mrc" and len(path) == 3 and path[1] in _MRF_MRC:
        base, kind = _MRF_MRC[path[1]]
        suf, val = _leaf(kind, path[2], val)
        return f"{base}.{suf}", val
    if path[0] in ("qa_head", "qa_seq_relation") and len(path) == 2:
        suf, val = _leaf("dense", path[1], val)
        return f"{path[0]}.{suf}", val
    if path[0] == "classifier" and len(path) in (2, 3):
        suf, val = _leaf("dense", path[-1], val)
        sub = path[1] if len(path) == 3 else None
        if sub is not None and sub.startswith("layers_"):   # nn.Sequential
            return f"classifier.{sub[len('layers_'):]}.{suf}", val
        if sub is not None and mlp_classifier:
            return f"classifier.{'0' if sub == 'dense' else '2'}.{suf}", val
        return f"classifier.{suf}", val
    if (path[0] == "single_mapping" and len(path) == 3
            and path[1] in ("layers_0", "layers_2")):
        suf, val = _leaf("dense", path[2], val)
        return f"single_mapping.{path[1][len('layers_'):]}.{suf}", val
    if path[0] == "bert" and len(path) > 1:
        p = path[1:]
        if p[0] == "embeddings" and p[-1] == "embedding" and len(p) == 3:
            return f"bert.embeddings.{p[1]}.weight", val
        if p == ("code_embeddings", "embedding"):
            return "bert.code_embeddings.weight", val
        if p[:2] == ("embeddings", "LayerNorm"):
            suf, val = _leaf("norm", p[2], val)
            return f"bert.embeddings.LayerNorm.{suf}", val
        if p[:2] == ("pooler", "dense"):
            suf, val = _leaf("dense", p[2], val)
            return f"bert.pooler.dense.{suf}", val
        if p in (("txt_proj",), ("vis_proj",)):
            return f"bert.{p[0]}", val          # applied as x @ P: no transpose
        if p[0] == "img_embedding" and len(p) == 2:
            suf, val = _leaf("dense", p[1], val)
            return f"bert.img_embedding.{suf}", val
        if p[0] == "img_norm" and len(p) == 2:
            suf, val = _leaf("norm", p[1], val)
            return f"bert.LayerNorm.{suf}", val
        if p[0] in _ENCODERS and len(p) > 2 and p[1].startswith("layer_"):
            if p[2:] in (("moe", "wi"), ("moe", "wo")):
                i = p[1][len("layer_"):]
                return f"bert.{p[0]}.layer.{i}.moe.{p[3]}", val
            spec = _LAYER_SUFFIX.get(tuple(p[2:-1]))
            if spec is not None:
                tk, kind = spec
                suf, val = _leaf(kind, p[-1], val)
                return f"bert.{p[0]}.layer.{p[1][len('layer_'):]}.{tk}.{suf}", val
    raise KeyError(f"flax path {'/'.join(path)} has no key in the port")


def _nest(tree: Mapping[str, Any]) -> dict:
    """A tree with "/"-joined keys (at any level) as nested dicts."""
    out: dict = {}
    for k, v in tree.items():
        node = out
        parts = k.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        if isinstance(v, Mapping):
            node.setdefault(parts[-1], {}).update(_nest(v))
        else:
            node[parts[-1]] = v
    return out


def jax_params_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax params tree of a full model (`bert` and its heads, and
    `logit_scale` where the model has one) -> the reference's torch state
    dict."""
    from .parallel.pipeline import unstack_model_params
    flat = list(_flatten(unstack_model_params(_nest(params))))
    mlp = any(p[:2] == ("classifier", "dense") for p, _ in flat)
    sd = {}
    for path, val in flat:
        key, val = _torch_key(path, val, mlp)
        sd[key] = torch.from_numpy(np.array(val, copy=True))
    return sd


def load_jax_params(model: torch.nn.Module, params: Mapping[str, Any]):
    """Load flax params into `model` with `load_state_dict(strict=True)`.

    `model` is a `RetrievalModel` (params hold `bert`, `classifier`,
    `logit_scale`), a `BiPretrainModel` (params hold `bert`, the pretraining
    heads, `logit_scale`; `qa_head` exactly when `qa_answer_size > 0` and
    `qa_seq_relation` exactly when the model has `qa_pairs`), a single-pair
    task model (`bert` and `classifier`, `cls` or `single_mapping` and
    `classifier`), a single-stream model (`ImgBertForPreTraining`: `bert`,
    the pretraining heads and with `use_mrfr` `mrf_mrc`;
    `ImgBertForSequenceClassification` / `ImgBertForMultipleChoice`: `bert`
    and `classifier`; `CaptioningModel`: `bert` and `cls_predictions`) or a
    bare `BiEncoder` / `ImgBertModel` (params are the `bert` subtree). A
    flax path with no place in the port, or a port parameter the params do
    not cover, raises."""
    if hasattr(model, "bert"):
        sd = jax_params_to_state_dict(params)
    else:
        sd = {k[len("bert."):]: v for k, v in
              jax_params_to_state_dict({"bert": params}).items()}
    model.load_state_dict(sd, strict=True)
    return model


def detector_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX detector's flax params (`JaxDetector`: `trunk/...`,
    `head_conv`, `obj_head`, `box_head`, `roi_fc1`, `roi_fc2`, `cls_head`;
    numpy leaves, nested or "/"-joined) -> the port's `Detector` state dict:
    a conv kernel HWIO becomes OIHW, a Dense kernel [in, out] becomes
    [out, in], a GroupNorm's `scale` / `bias` become `weight` / `bias`.
    `roi_fc1`'s rows keep their order: the port flattens each pooled RoI
    channels-last, (p, p, c), as flax flattens its NHWC pooling. The result
    loads with `load_state_dict(strict=True)`."""
    sd = {}
    for path, val in _flatten(params):
        *mods, leaf = path
        val = np.asarray(val)
        if leaf == "kernel":
            leaf = "weight"
            val = (np.transpose(val, (3, 2, 0, 1)) if val.ndim == 4
                   else val.T)
        elif leaf == "scale":
            leaf = "weight"
        elif leaf != "bias":
            raise KeyError(f"flax path {'/'.join(path)} has no key in the "
                           f"port's detector")
        sd[".".join(mods + [leaf])] = torch.from_numpy(
            np.array(val, copy=True))
    return sd
