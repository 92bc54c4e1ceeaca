"""Models of the port: config, layers, backbone, heads, task models."""

from .bi_encoder import BiEncoder, BiEncoderOutput, l2_normalize
from .config import ModelConfig, tiny_config
from .heads import ClassifierHead
from .pretrain import BiPretrainModel, PretrainOutput
from .tasks import (ClassificationModel, ClassificationPlusModel, REModel,
                    RetrievalModel, RetrievalTrainOutput, VQAModel)

__all__ = ["BiEncoder", "BiEncoderOutput", "BiPretrainModel",
           "ClassificationModel", "ClassificationPlusModel",
           "ClassifierHead", "ModelConfig", "PretrainOutput", "REModel",
           "RetrievalModel", "RetrievalTrainOutput", "VQAModel",
           "l2_normalize", "tiny_config"]
