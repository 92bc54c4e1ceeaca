"""Model configuration, key-compatible with the JAX package's `config.json`.

The field names and defaults are those of `mvp_pytorch_tpu.models.config`
(a superset of the reference BertConfig JSON keys), so a checkpoint directory
written by either package self-describes the same way. Fields that only the
JAX package reads (remat, pipeline stages, MoE) are kept so that both
packages' configs carry the same keys.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Any, Optional


@dataclass
class ModelConfig:
    # --- BERT core (reference BertConfig JSON keys) ---
    vocab_size: int = 30522              # wordpieces + phrase concepts
    hidden_size: int = 768
    num_hidden_layers: int = 12          # split 6/6/6 across txt/vis/mul
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12

    # --- MVPTR vocabulary split ---
    only_word_size: int = 30522

    # --- image stream ---
    img_feature_dim: int = 2054          # 2048 RoI + 6 box geometry
    img_feature_type: str = "faster_r-cnn"
    use_img_layernorm: bool = False
    img_layer_norm_eps: float = 1e-12

    # --- task/pretrain fields grafted by the reference run scripts ---
    num_contrast_classes: int = 2
    qa_answer_size: int = 0
    num_labels: int = 2
    loss_type: str = "sfmx"
    cls_hidden_scale: int = 2
    classifier: str = "linear"           # linear | mlp
    max_text_seq_length: Optional[int] = None

    # --- compute policy ---
    dtype: str = "float32"               # float32 | bfloat16
    attention_impl: str = "auto"
    remat: bool = False
    fused_hn_pass: bool = False
    pipeline_stages: int = 0
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_every: int = 2
    moe_group_size: int = 1024

    def __post_init__(self):
        if self.hidden_size % self.num_attention_heads != 0:
            raise ValueError(
                f"hidden_size {self.hidden_size} not divisible by "
                f"num_attention_heads {self.num_attention_heads}")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def half_layers(self) -> int:
        """Layers per stream encoder (reference modeling_vlbert.py:360-364)."""
        return self.num_hidden_layers // 2

    def save_pretrained(self, save_directory: str) -> None:
        """`config.json` in the JAX package's format."""
        os.makedirs(save_directory, exist_ok=True)
        with open(os.path.join(save_directory, "config.json"), "w") as f:
            f.write(json.dumps(dataclasses.asdict(self), indent=2,
                               sort_keys=True) + "\n")

    @classmethod
    def from_dict(cls, d: dict, **overrides: Any) -> "ModelConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in d.items() if k in known}
        kwargs.update({k: v for k, v in overrides.items() if k in known})
        return cls(**kwargs)

    @classmethod
    def from_pretrained(cls, directory: str, **overrides: Any
                        ) -> "ModelConfig":
        """The `config.json` of a checkpoint directory, with `overrides`."""
        with open(os.path.join(directory, "config.json")) as f:
            return cls.from_dict(json.load(f), **overrides)


def tiny_config(**overrides: Any) -> ModelConfig:
    """Tiny config for unit tests: hidden 32, 4 heads, 2+2+2 layers."""
    base = dict(
        vocab_size=131,
        only_word_size=99,
        hidden_size=32,
        num_hidden_layers=4,
        num_attention_heads=4,
        intermediate_size=37,
        max_position_embeddings=64,
        img_feature_dim=22,
        qa_answer_size=7,
        hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0,
    )
    base.update(overrides)
    return ModelConfig(**base)
