"""PyTorch / CUDA port of mvp_pytorch_tpu for NVIDIA Hopper.

This slice carries the two-stage retrieval scoring path of `RetrievalModel`:
the three-encoder `BiEncoder` at inference, its conversion from the JAX
package's params, and the hand-written masked-attention kernel
(`csrc/masked_attention.cu`) that every encoder layer runs on the card.

Entry points run on CUDA unless the caller passes `device="cpu"`; on a CPU
tensor each kernel wrapper runs its plain PyTorch version.
"""

from .models.config import ModelConfig, tiny_config

__all__ = ["ModelConfig", "tiny_config"]
