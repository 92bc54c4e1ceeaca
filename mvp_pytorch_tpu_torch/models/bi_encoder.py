"""Two-stream + fusion backbone ("BiEncoder"), inference path.

The JAX package's `mvp_pytorch_tpu/models/bi_encoder.py` in PyTorch: a shared
embedding table over the wordpiece + phrase vocabulary, three
`num_hidden_layers // 2`-layer stream encoders (txt / vis / mul), the 2054-d
region projection appended to the vision stream, the global projections with
their similarity matrix, and the tag-stripped fusion input
`[txt_out ; vis_out[:, max_tag_length:]]` (reference
`oscar/modeling/modeling_vlbert.py:354-875`). Hard-negative mining waits for
the training slice.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from .config import ModelConfig
from .layers import (Dense, Embeddings, LayerNorm, Pooler, StreamEncoder,
                     compute_dtype, init_weights, mask_to_bias)


def l2_normalize(x, dim=-1, eps=1e-12):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True),
                           min=eps)


class BiEncoderOutput(NamedTuple):
    sequence_output: torch.Tensor   # [B, La+R, H] fused output
    pooled_output: torch.Tensor     # [B, H]
    txt_output: torch.Tensor        # [B, La, H]
    vis_output: torch.Tensor        # [B, T+R, H]
    sim_mat: torch.Tensor           # [B, B] rows = text, cols = image, fp32
    mid_joint: Optional[torch.Tensor]


class BiEncoder(nn.Module):
    def __init__(self, config: ModelConfig):
        super().__init__()
        h = config.hidden_size
        dt = compute_dtype(config)
        self.config = config
        self.embeddings = Embeddings(config)
        self.txt_encoder = StreamEncoder(config, config.half_layers)
        self.vis_encoder = StreamEncoder(config, config.half_layers)
        self.mul_encoder = StreamEncoder(config, config.half_layers)
        self.pooler = Pooler(config)
        # raw [H, H] matrices applied as x @ P in fp32 (not torch-transposed)
        self.txt_proj = nn.Parameter(torch.empty(h, h))
        self.vis_proj = nn.Parameter(torch.empty(h, h))
        self.img_embedding = Dense(config.img_feature_dim, h, dt)
        if config.use_img_layernorm:
            self.LayerNorm = LayerNorm(h, config.img_layer_norm_eps, dt)
        self.img_dropout = nn.Dropout(config.hidden_dropout_prob)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's init; the projections are normal(H^-1/2)."""
        init_weights(self, self.config.initializer_range, generator)
        std = self.config.hidden_size ** -0.5
        self.txt_proj.normal_(0.0, std, generator=generator)
        self.vis_proj.normal_(0.0, std, generator=generator)

    def encode_text(self, input_ids_a, attention_mask_a=None,
                    token_type_ids_a=None, position_ids_a=None):
        """Text stream -> (seq [B, La, H], global [B, H] fp32)."""
        if attention_mask_a is None:
            attention_mask_a = torch.ones_like(input_ids_a)
        emb = self.embeddings(input_ids_a, token_type_ids_a, position_ids_a)
        seq, _ = self.txt_encoder(emb, mask_to_bias(attention_mask_a))
        glob = l2_normalize(seq[:, 0].float() @ self.txt_proj)
        return seq, glob

    def embed_image_stream(self, input_ids_b, token_type_ids_b, img_feats,
                           position_ids_b=None):
        """[CLS] tags [SEP] token embeddings ++ projected region features
        (no position embeddings on regions; reference :498-509)."""
        tok = self.embeddings(input_ids_b, token_type_ids_b, position_ids_b)
        img = self.img_embedding(img_feats)
        if self.config.use_img_layernorm:
            img = self.LayerNorm(img)
        img = self.img_dropout(img)
        return torch.cat([tok, img.to(tok.dtype)], dim=1)

    def encode_image(self, input_ids_b, attention_mask_b=None,
                     token_type_ids_b=None, img_feats=None,
                     position_ids_b=None):
        """Vision stream -> (seq [B, T+R, H], global [B, H] fp32)."""
        if attention_mask_b is None:
            attention_mask_b = torch.ones(
                input_ids_b.shape[0],
                input_ids_b.shape[1] + img_feats.shape[1],
                dtype=torch.int32, device=input_ids_b.device)
        emb = self.embed_image_stream(input_ids_b, token_type_ids_b,
                                      img_feats, position_ids_b)
        seq, _ = self.vis_encoder(emb, mask_to_bias(attention_mask_b))
        glob = l2_normalize(seq[:, 0].float() @ self.vis_proj)
        return seq, glob

    def fuse(self, txt_seq, attention_mask_a, vis_part, vis_part_mask, *,
             return_at_layer: Optional[int] = None):
        """Fusion encoder over [txt_seq ; vis_part] -> (seq, pooled, mid)."""
        joint = torch.cat([txt_seq, vis_part], dim=1)
        joint_mask = torch.cat([attention_mask_a, vis_part_mask], dim=-1)
        seq, mid = self.mul_encoder(joint, mask_to_bias(joint_mask),
                                    return_at_layer=return_at_layer)
        return seq, self.pooler(seq), mid

    def forward(self, input_ids_a, attention_mask_a=None,
                token_type_ids_a=None, input_ids_b=None,
                attention_mask_b=None, token_type_ids_b=None,
                img_feats=None, position_ids_a=None, position_ids_b=None,
                *, max_tag_length: Optional[int] = None, use_b: bool = False,
                phrase_layer: Optional[int] = None) -> BiEncoderOutput:
        """The reference BiBertImgModel.forward without hard negatives."""
        if attention_mask_a is None:
            attention_mask_a = torch.ones_like(input_ids_a)
        if attention_mask_b is None:
            attention_mask_b = torch.ones(
                input_ids_b.shape[0],
                input_ids_b.shape[1] + img_feats.shape[1],
                dtype=torch.int32, device=input_ids_b.device)
        txt_seq, global_txt = self.encode_text(
            input_ids_a, attention_mask_a, token_type_ids_a, position_ids_a)
        vis_seq, global_img = self.encode_image(
            input_ids_b, attention_mask_b, token_type_ids_b, img_feats,
            position_ids_b)
        # strip the tag positions (or just CLS with use_b) before fusion
        # (reference modeling_vlbert.py:515-520)
        if not use_b and max_tag_length is None:
            raise ValueError(
                "max_tag_length is required when use_b=False: the fusion "
                "input strips the tag positions")
        strip = 1 if use_b else max_tag_length
        sim_mat = global_txt @ global_img.T
        seq_out, pooled, mid = self.fuse(
            txt_seq, attention_mask_a, vis_seq[:, strip:, :],
            attention_mask_b[:, strip:], return_at_layer=phrase_layer)
        return BiEncoderOutput(
            sequence_output=seq_out, pooled_output=pooled,
            txt_output=txt_seq, vis_output=vis_seq, sim_mat=sim_mat,
            mid_joint=mid)
