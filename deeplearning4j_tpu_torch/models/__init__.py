"""Canned architectures."""

from deeplearning4j_tpu_torch.models.zoo import (  # noqa: F401
    AlexNet, Darknet19, FaceNetNN4Small2, InceptionResNetV1, LeNet,
    NASNet, ResNet50, SimpleCNN, SqueezeNet, TextGenerationLSTM,
    TinyYOLO, UNet, VGG16, VGG19, Xception, YOLO2, ZooModel)
from deeplearning4j_tpu_torch.models.bert import (  # noqa: F401
    BertConfig, BertTrainer, forward as bert_forward,
    init_params as bert_init_params, mlm_loss, param_specs as
    bert_param_specs, synthetic_mlm_batch)
