"""Ops of the port: masked attention and its CUDA kernel binding."""

from .attention import (MASK_VALUE, mask_to_bias, masked_attention,
                        plain_attention, plain_attention_blhd)

__all__ = ["MASK_VALUE", "mask_to_bias", "masked_attention",
           "plain_attention", "plain_attention_blhd"]
