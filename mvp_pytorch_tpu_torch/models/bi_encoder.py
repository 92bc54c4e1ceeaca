"""Two-stream + fusion backbone ("BiEncoder"), for inference and training.

The JAX package's `mvp_pytorch_tpu/models/bi_encoder.py` in PyTorch: a shared
embedding table over the wordpiece + phrase vocabulary, three
`num_hidden_layers // 2`-layer stream encoders (txt / vis / mul), the 2054-d
region projection appended to the vision stream, the global projections with
their similarity matrix, in-batch hard-negative mining (hardest or sampled)
with the 50/50 hard-image / hard-text slot mix re-encoded by the fusion
encoder, and the tag-stripped fusion input `[txt_out ; vis_out[:,
max_tag_length:]]` (reference `oscar/modeling/modeling_vlbert.py:354-875`).

Random choices (sampled negatives, the slot permutation) draw from a
`torch.Generator` the caller passes; `hn_dice` pins the permutation, as in
the JAX package. `forward_joint` waits for the NLVR slice.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from .config import ModelConfig
from .layers import (Dense, Dropout, Embeddings, LayerNorm, Pooler,
                     StreamEncoder, compute_dtype, init_weights, mask_to_bias)


def l2_normalize(x, dim=-1, eps=1e-12):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True),
                           min=eps)


class BiEncoderOutput(NamedTuple):
    sequence_output: torch.Tensor   # [B, La+R, H] fused output (true pairs)
    pooled_output: torch.Tensor     # [B, H]
    hard_sequence_output: Optional[torch.Tensor]  # [B, La+R, H] hard pairs
    hard_pooled_output: Optional[torch.Tensor]    # [B, H]
    txt_output: torch.Tensor        # [B, La, H]
    vis_output: torch.Tensor        # [B, T+R, H]
    sim_mat: torch.Tensor           # [B, B] rows = text, cols = image, fp32
    hard_txt_index: Optional[torch.Tensor]  # [B] text example per hard slot
    hard_img_index: Optional[torch.Tensor]  # [B] image example per hard slot
    mid_joint: Optional[torch.Tensor]       # fusion mid-layer (phrase_layer)
    mid_hard: Optional[torch.Tensor]


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
        self.img_dropout = Dropout(config.hidden_dropout_prob)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's init; the projections are normal(H^-1/2)."""
        init_weights(self, self.config.initializer_range, generator)
        std = self.config.hidden_size ** -0.5
        self.txt_proj.normal_(0.0, std, generator=generator)
        self.vis_proj.normal_(0.0, std, generator=generator)

    def word_table(self) -> torch.Tensor:
        """The shared [vocab_size, H] embedding table, for the tied LM
        heads."""
        return self.embeddings.word_table()

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

    def mine_hard_negatives(self, sim_mat, *, hn_mod: str = "hard",
                            logit=None, hn_dice=None,
                            generator: Optional[torch.Generator] = None):
        """Per output slot s, the (text, image) example of its hard pair.

        hn_mod "hard": the most similar other image per text and other text
        per image (argmax of sim - 2 I); "sample": a categorical draw over
        logit * sim - 10000 I. The first n // 2 slots pair text dice[s] with
        its hard image, the rest pair a hard text with image dice[s], where
        dice is a random permutation unless `hn_dice` pins it."""
        n = sim_mat.shape[0]
        with torch.no_grad():
            eye = torch.eye(n, dtype=sim_mat.dtype, device=sim_mat.device)
            if hn_mod == "hard":
                masked = sim_mat - 2.0 * eye
                hard_img_index = masked.argmax(dim=1)      # per text
                hard_txt_index = masked.argmax(dim=0)      # per image
            elif hn_mod == "sample":
                masked = logit * sim_mat - 10000.0 * eye
                hard_img_index = torch.multinomial(
                    torch.softmax(masked, dim=1), 1, generator=generator)[:, 0]
                hard_txt_index = torch.multinomial(
                    torch.softmax(masked.T, dim=1), 1,
                    generator=generator)[:, 0]
            else:
                raise NotImplementedError(hn_mod)
            dice = (torch.randperm(n, generator=generator,
                                   device=sim_mat.device)
                    if hn_dice is None else hn_dice.to(sim_mat.device))
            is_hard_img = torch.arange(n, device=sim_mat.device) < n // 2
            txt = torch.where(is_hard_img, dice, hard_txt_index[dice])
            img = torch.where(is_hard_img, hard_img_index[dice], dice)
        return txt, img

    def forward(self, input_ids_a, attention_mask_a=None,
                token_type_ids_a=None, input_ids_b=None,
                attention_mask_b=None, token_type_ids_b=None,
                img_feats=None, position_ids_a=None, position_ids_b=None,
                *, max_tag_length: Optional[int] = None, use_b: bool = False,
                encode_hn: bool = False, hn_mod: str = "hard", logit=None,
                phrase_layer: Optional[int] = None, hn_dice=None,
                generator: Optional[torch.Generator] = None
                ) -> BiEncoderOutput:
        """The reference BiBertImgModel.forward (modeling_vlbert.py:411-609):
        both streams, the similarity matrix and the fusion pass; with
        `encode_hn` also the hard-negative pairs' fusion pass, as one pass
        over 2B rows when `config.fused_hn_pass`."""
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
        only_vis = vis_seq[:, strip:, :]
        only_vis_mask = attention_mask_b[:, strip:]
        sim_mat = global_txt @ global_img.T

        hard_seq = hard_pooled = hard_txt = hard_img = mid_hard = None
        if not encode_hn:
            seq_out, pooled, mid_joint = self.fuse(
                txt_seq, attention_mask_a, only_vis, only_vis_mask,
                return_at_layer=phrase_layer)
        else:
            hard_txt, hard_img = self.mine_hard_negatives(
                sim_mat, hn_mod=hn_mod, logit=logit, hn_dice=hn_dice,
                generator=generator)
            n = sim_mat.shape[0]
            if self.config.fused_hn_pass:
                both_seq, both_pooled, both_mid = self.fuse(
                    torch.cat([txt_seq, txt_seq[hard_txt]], 0),
                    torch.cat([attention_mask_a, attention_mask_a[hard_txt]],
                              0),
                    torch.cat([only_vis, only_vis[hard_img]], 0),
                    torch.cat([only_vis_mask, only_vis_mask[hard_img]], 0),
                    return_at_layer=phrase_layer)
                seq_out, hard_seq = both_seq[:n], both_seq[n:]
                pooled, hard_pooled = both_pooled[:n], both_pooled[n:]
                mid_joint = None
                if both_mid is not None:
                    mid_joint, mid_hard = both_mid[:n], both_mid[n:]
            else:
                hard_seq, hard_pooled, mid_hard = self.fuse(
                    txt_seq[hard_txt], attention_mask_a[hard_txt],
                    only_vis[hard_img], only_vis_mask[hard_img],
                    return_at_layer=phrase_layer)
                seq_out, pooled, mid_joint = self.fuse(
                    txt_seq, attention_mask_a, only_vis, only_vis_mask,
                    return_at_layer=phrase_layer)
        return BiEncoderOutput(
            sequence_output=seq_out, pooled_output=pooled,
            hard_sequence_output=hard_seq, hard_pooled_output=hard_pooled,
            txt_output=txt_seq, vis_output=vis_seq, sim_mat=sim_mat,
            hard_txt_index=hard_txt, hard_img_index=hard_img,
            mid_joint=mid_joint, mid_hard=mid_hard)
