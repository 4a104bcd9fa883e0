"""LeNet (counterpart of ``paddle_tpu/vision/models/lenet.py``): two
conv / ReLU / max-pool stages on a 28 x 28 x 1 input and three
``Linear`` layers. Built on ``device`` from ``generator`` (default: one
seeded with ``seed``), as every model of the zoo."""
from __future__ import annotations

from ... import tensor as T
from ...nn import Conv2D, MaxPool2D, ReLU, Sequential
from ...nn.layer import Layer
from ._common import layer_kw, linear


class LeNet(Layer):
    def __init__(self, num_classes=10, **kw):
        super().__init__()
        kw = layer_kw(**kw)
        self.num_classes = num_classes
        self.features = Sequential(
            Conv2D(1, 6, 3, stride=1, padding=1, **kw), ReLU(),
            MaxPool2D(2, 2),
            Conv2D(6, 16, 5, stride=1, padding=0, **kw), ReLU(),
            MaxPool2D(2, 2))
        if num_classes > 0:
            self.fc = Sequential(linear(400, 120, **kw),
                                 linear(120, 84, **kw),
                                 linear(84, num_classes, **kw))

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(T.flatten(x, 1))
        return x


__all__ = ["LeNet"]
