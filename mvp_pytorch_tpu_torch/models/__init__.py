"""Models of the port: config, layers, backbone, heads, task models."""

from .bi_encoder import BiEncoder, BiEncoderOutput, l2_normalize
from .config import ModelConfig, tiny_config
from .heads import ClassifierHead
from .pretrain import BiPretrainModel, PretrainOutput
from .tasks import (CaseModel, ClassificationModel, ClassificationPlusModel,
                    MLMModel, NLVRModel, REModel, RepModel, RetrievalModel,
                    RetrievalTrainOutput, VQAModel, WREModel)

__all__ = ["BiEncoder", "BiEncoderOutput", "BiPretrainModel", "CaseModel",
           "ClassificationModel", "ClassificationPlusModel",
           "ClassifierHead", "MLMModel", "ModelConfig", "NLVRModel",
           "PretrainOutput", "REModel", "RepModel", "RetrievalModel",
           "RetrievalTrainOutput", "VQAModel", "WREModel", "l2_normalize",
           "tiny_config"]
