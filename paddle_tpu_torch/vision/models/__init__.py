"""Vision models of the port (counterpart of
``paddle_tpu/vision/models/``): every family of the reference's zoo
(LeNet, AlexNet, VGG, SqueezeNet, MobileNet V1 / V2 / V3, ShuffleNetV2,
DenseNet, GoogLeNet, Inception-v3, ResNet, ViT), each built on
``device`` (the CUDA card unless ``"cpu"`` is named) from an explicit
``torch.Generator`` (``generator=``, default one seeded with ``seed=``),
with the reference's parameter and state names."""
from .alexnet import AlexNet, alexnet
from .densenet import (DenseNet, densenet121, densenet161, densenet169,
                       densenet201, densenet264)
from .googlenet import GoogLeNet, googlenet
from .inceptionv3 import InceptionV3, inception_v3
from .lenet import LeNet
from .mobilenet import MobileNetV1, MobileNetV2, mobilenet_v1, mobilenet_v2
from .mobilenetv3 import (MobileNetV3Large, MobileNetV3Small,
                          mobilenet_v3_large, mobilenet_v3_small)
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18,
                     resnet34, resnet50, resnet101, resnet152,
                     resnext50_32x4d, resnext101_32x4d, wide_resnet50_2,
                     wide_resnet101_2)
from .shufflenetv2 import (ShuffleNetV2, shufflenet_v2_swish,
                           shufflenet_v2_x0_25, shufflenet_v2_x0_33,
                           shufflenet_v2_x0_5, shufflenet_v2_x1_0,
                           shufflenet_v2_x1_5, shufflenet_v2_x2_0)
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19
from .vit import VisionTransformer, vit_b_16, vit_l_16

__all__ = ["AlexNet", "BasicBlock", "BottleneckBlock", "DenseNet",
           "GoogLeNet", "InceptionV3", "LeNet", "MobileNetV1", "MobileNetV2",
           "MobileNetV3Large", "MobileNetV3Small", "ResNet", "ShuffleNetV2",
           "SqueezeNet", "VGG", "VisionTransformer", "alexnet",
           "densenet121", "densenet161", "densenet169", "densenet201",
           "densenet264", "googlenet", "inception_v3", "mobilenet_v1",
           "mobilenet_v2", "mobilenet_v3_large", "mobilenet_v3_small",
           "resnet101", "resnet152", "resnet18", "resnet34", "resnet50",
           "resnext101_32x4d", "resnext50_32x4d", "shufflenet_v2_swish",
           "shufflenet_v2_x0_25", "shufflenet_v2_x0_33", "shufflenet_v2_x0_5",
           "shufflenet_v2_x1_0", "shufflenet_v2_x1_5", "shufflenet_v2_x2_0",
           "squeezenet1_0", "squeezenet1_1", "vgg11", "vgg13", "vgg16",
           "vgg19", "vit_b_16", "vit_l_16", "wide_resnet101_2",
           "wide_resnet50_2"]
