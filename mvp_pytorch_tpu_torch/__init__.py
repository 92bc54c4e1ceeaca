"""PyTorch / CUDA port of mvp_pytorch_tpu for NVIDIA Hopper.

The port carries the flagship `RetrievalModel`: its training step (the
three-encoder `BiEncoder` with hard-negative mining, CLIP + ITM + WRA losses,
AdamW matching optax, a single-device trainer and checkpoints) and its
two-stage retrieval scoring; the pretraining model `BiPretrainModel` (the
5-loss composite) and its training step; the conversion from the JAX
package's params; and the hand-written masked-attention kernel
(`csrc/masked_attention.cuh`, with attention-prob dropout inside) that every
encoder layer runs on the card, forward and under autograd. Later slices
add the pretraining corpus path, the task models and their command lines,
serving, the single-stream model and captioning with its decoders.

Entry points run on CUDA unless the caller passes `device="cpu"`; on a CPU
tensor each kernel wrapper runs its plain PyTorch version.
"""

from .models.config import ModelConfig, tiny_config

__all__ = ["ModelConfig", "tiny_config"]
