"""Models of the port: config, layers, backbone, heads, task models."""

from .bi_encoder import BiEncoder, BiEncoderOutput, l2_normalize
from .config import ModelConfig, tiny_config
from .heads import ClassifierHead
from .tasks import RetrievalModel

__all__ = ["BiEncoder", "BiEncoderOutput", "ClassifierHead", "ModelConfig",
           "RetrievalModel", "l2_normalize", "tiny_config"]
