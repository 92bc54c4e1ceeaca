"""Ops of the port: masked attention (its CUDA kernel binding, its
attention-prob dropout and its backward) and the fixed-shape masked and span
ops."""

from .attention import (MASK_VALUE, MaskedAttentionFn, dropout_hash,
                        dropout_keep, mask_to_bias, masked_attention,
                        plain_attention, plain_attention_blhd)
from .masked import (cross_entropy, gather_masked_positions, gather_span,
                     masked_cross_entropy)

__all__ = ["MASK_VALUE", "MaskedAttentionFn", "cross_entropy", "dropout_hash",
           "dropout_keep", "gather_masked_positions", "gather_span",
           "mask_to_bias", "masked_attention", "masked_cross_entropy",
           "plain_attention", "plain_attention_blhd"]
