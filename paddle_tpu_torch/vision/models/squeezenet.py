"""SqueezeNet 1.0 / 1.1 (counterpart of
``paddle_tpu/vision/models/squeezenet.py``)."""
from __future__ import annotations

from ... import tensor as T
from ...nn import (AdaptiveAvgPool2D, Conv2D, Dropout, MaxPool2D, ReLU,
                   Sequential)
from ...nn.layer import Layer
from ._common import layer_kw, no_pretrained


class Fire(Layer):
    def __init__(self, in_ch, squeeze, expand1x1, expand3x3, **kw):
        super().__init__()
        self.squeeze = Conv2D(in_ch, squeeze, 1, **kw)
        self.relu = ReLU()
        self.expand1x1 = Conv2D(squeeze, expand1x1, 1, **kw)
        self.expand3x3 = Conv2D(squeeze, expand3x3, 3, padding=1, **kw)

    def forward(self, x):
        s = self.relu(self.squeeze(x))
        return T.concat([self.relu(self.expand1x1(s)),
                         self.relu(self.expand3x3(s))], axis=1)


class SqueezeNet(Layer):
    def __init__(self, version="1.0", num_classes=1000, with_pool=True,
                 **kw):
        super().__init__()
        kw = layer_kw(**kw)
        self.num_classes = num_classes
        self.with_pool = with_pool
        if version == "1.0":
            self.features = Sequential(
                Conv2D(3, 96, 7, stride=2, **kw), ReLU(),
                MaxPool2D(3, stride=2),
                Fire(96, 16, 64, 64, **kw), Fire(128, 16, 64, 64, **kw),
                Fire(128, 32, 128, 128, **kw),
                MaxPool2D(3, stride=2),
                Fire(256, 32, 128, 128, **kw), Fire(256, 48, 192, 192, **kw),
                Fire(384, 48, 192, 192, **kw), Fire(384, 64, 256, 256, **kw),
                MaxPool2D(3, stride=2),
                Fire(512, 64, 256, 256, **kw))
        elif version == "1.1":
            self.features = Sequential(
                Conv2D(3, 64, 3, stride=2, **kw), ReLU(),
                MaxPool2D(3, stride=2),
                Fire(64, 16, 64, 64, **kw), Fire(128, 16, 64, 64, **kw),
                MaxPool2D(3, stride=2),
                Fire(128, 32, 128, 128, **kw), Fire(256, 32, 128, 128, **kw),
                MaxPool2D(3, stride=2),
                Fire(256, 48, 192, 192, **kw), Fire(384, 48, 192, 192, **kw),
                Fire(384, 64, 256, 256, **kw), Fire(512, 64, 256, 256, **kw))
        else:
            raise ValueError(f"unsupported version {version!r}")
        if num_classes > 0:
            self.classifier = Sequential(
                Dropout(0.5), Conv2D(512, num_classes, 1, **kw), ReLU())
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((1, 1))

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = self.classifier(x)
        if self.with_pool:
            x = self.avgpool(x)
        return T.flatten(x, 1)


def _squeezenet(version, pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return SqueezeNet(version, **kwargs)


def squeezenet1_0(pretrained=False, **kwargs):
    return _squeezenet("1.0", pretrained, **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    return _squeezenet("1.1", pretrained, **kwargs)


__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]
