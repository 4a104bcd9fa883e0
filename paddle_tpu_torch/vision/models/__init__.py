"""Vision models of the port (counterpart of
``paddle_tpu/vision/models/``): the ResNet family. The other families
wait (ROADMAP.md §A.6)."""
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18,
                     resnet34, resnet50, resnet101, resnet152,
                     resnext50_32x4d, resnext101_32x4d, wide_resnet50_2,
                     wide_resnet101_2)

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "resnet101",
           "resnet152", "resnet18", "resnet34", "resnet50",
           "resnext101_32x4d", "resnext50_32x4d", "wide_resnet101_2",
           "wide_resnet50_2"]
