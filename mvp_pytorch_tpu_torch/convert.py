"""Load the JAX package's flax params into the port.

A flax params tree (nested dicts or a flat dict with "/"-joined paths, as
numpy arrays) maps onto the reference's torch state-dict keys, which the
port's modules carry: dense kernels are transposed to torch's [out, in],
LayerNorm `scale` becomes `weight`, embedding tables and the raw `[H, H]`
global projections load as they are. The mapping is this package's own copy
of the JAX package's `convert.export_state_dict` rules.
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
}

_ENCODERS = ("txt_encoder", "vis_encoder", "mul_encoder")


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
    if path[0] == "classifier":
        suf, val = _leaf("dense", path[-1], val)
        if mlp_classifier:
            return f"classifier.{'0' if path[1] == 'dense' else '2'}.{suf}", val
        return f"classifier.{suf}", val
    if path[0] == "bert" and len(path) > 1:
        p = path[1:]
        if p[0] == "embeddings" and p[-1] == "embedding" and len(p) == 3:
            return f"bert.embeddings.{p[1]}.weight", val
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
            spec = _LAYER_SUFFIX.get(tuple(p[2:-1]))
            if spec is not None:
                tk, kind = spec
                suf, val = _leaf(kind, p[-1], val)
                return f"bert.{p[0]}.layer.{p[1][len('layer_'):]}.{tk}.{suf}", val
    raise KeyError(f"flax path {'/'.join(path)} has no key in the port")


def jax_params_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax params tree of a full model (`bert`, `classifier`,
    `logit_scale`) -> the reference's torch state dict."""
    flat = list(_flatten(params))
    mlp = any(p[:2] == ("classifier", "dense") for p, _ in flat)
    sd = {}
    for path, val in flat:
        key, val = _torch_key(path, val, mlp)
        sd[key] = torch.from_numpy(np.ascontiguousarray(val).reshape(val.shape))
    return sd


def load_jax_params(model: torch.nn.Module, params: Mapping[str, Any]):
    """Load flax params into `model` with `load_state_dict(strict=True)`.

    `model` is a `RetrievalModel` (params hold `bert`, `classifier`,
    `logit_scale`) or a bare `BiEncoder` (params are the `bert` subtree). A
    flax path with no place in the port, or a port parameter the params do
    not cover, raises."""
    if hasattr(model, "bert"):
        sd = jax_params_to_state_dict(params)
    else:
        sd = {k[len("bert."):]: v for k, v in
              jax_params_to_state_dict({"bert": params}).items()}
    model.load_state_dict(sd, strict=True)
    return model
