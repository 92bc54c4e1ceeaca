"""Models of the port: config, layers, backbone, heads, task models."""

from .bi_encoder import BiEncoder, BiEncoderOutput, l2_normalize
from .config import ModelConfig, tiny_config
from .heads import ClassifierHead
from .img_bert import (CaptioningModel, ImgBertForMultipleChoice,
                       ImgBertForPreTraining,
                       ImgBertForSequenceClassification, ImgBertModel)
from .pretrain import BiPretrainModel, PretrainOutput
from .siglip import SiglipConfig, SiglipModel
from .tasks import (CaseModel, ClassificationModel, ClassificationPlusModel,
                    MLMModel, NLVRModel, REModel, RepModel, RetrievalModel,
                    RetrievalTrainOutput, VQAModel, WREModel)

__all__ = ["BiEncoder", "BiEncoderOutput", "BiPretrainModel",
           "CaptioningModel", "CaseModel",
           "ClassificationModel", "ClassificationPlusModel",
           "ClassifierHead", "ImgBertForMultipleChoice",
           "ImgBertForPreTraining", "ImgBertForSequenceClassification",
           "ImgBertModel", "MLMModel", "ModelConfig", "NLVRModel",
           "PretrainOutput", "REModel", "RepModel", "RetrievalModel",
           "RetrievalTrainOutput", "SiglipConfig", "SiglipModel", "VQAModel",
           "WREModel", "l2_normalize",
           "tiny_config"]
