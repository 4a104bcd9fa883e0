"""GoogLeNet / Inception-v1 (counterpart of
``paddle_tpu/vision/models/googlenet.py``): in training mode it returns
``(out, aux1, aux2)``, the two auxiliary heads' logits beside the main
one, as the reference's does; in eval mode ``out``."""
from __future__ import annotations

import torch

from ... import tensor as T
from ...nn import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Dropout,
                   MaxPool2D, ReLU, Sequential)
from ...nn.layer import Layer
from ._common import layer_kw, linear, no_pretrained


class _BasicConv(Layer):
    def __init__(self, in_ch, out_ch, k, device=None, dtype=torch.float32,
                 generator=None, **conv):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.conv = Conv2D(in_ch, out_ch, k, bias_attr=False, **conv, **kw)
        self.bn = BatchNorm2D(out_ch, **kw)
        self.relu = ReLU()

    def forward(self, x):
        return self.relu(self.bn(self.conv(x)))


class Inception(Layer):
    def __init__(self, in_ch, c1, c3r, c3, c5r, c5, proj, **kw):
        super().__init__()
        self.b1 = _BasicConv(in_ch, c1, 1, **kw)
        self.b2 = Sequential(_BasicConv(in_ch, c3r, 1, **kw),
                             _BasicConv(c3r, c3, 3, padding=1, **kw))
        self.b3 = Sequential(_BasicConv(in_ch, c5r, 1, **kw),
                             _BasicConv(c5r, c5, 5, padding=2, **kw))
        self.b4 = Sequential(MaxPool2D(3, stride=1, padding=1),
                             _BasicConv(in_ch, proj, 1, **kw))

    def forward(self, x):
        return T.concat([self.b1(x), self.b2(x), self.b3(x), self.b4(x)],
                        axis=1)


class _AuxHead(Layer):
    def __init__(self, in_ch, num_classes, **kw):
        super().__init__()
        # adaptive 4 x 4, as the reference's
        self.pool = AdaptiveAvgPool2D((4, 4))
        self.conv = _BasicConv(in_ch, 128, 1, **kw)
        self.fc1 = linear(2048, 1024, **kw)
        self.relu = ReLU()
        self.dropout = Dropout(0.7)
        self.fc2 = linear(1024, num_classes, **kw)

    def forward(self, x):
        x = T.flatten(self.conv(self.pool(x)), 1)
        return self.fc2(self.dropout(self.relu(self.fc1(x))))


class GoogLeNet(Layer):
    def __init__(self, num_classes=1000, with_pool=True, **kw):
        super().__init__()
        kw = layer_kw(**kw)
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = Sequential(
            _BasicConv(3, 64, 7, stride=2, padding=3, **kw),
            MaxPool2D(3, stride=2, padding=1),
            _BasicConv(64, 64, 1, **kw),
            _BasicConv(64, 192, 3, padding=1, **kw),
            MaxPool2D(3, stride=2, padding=1))
        self.inc3a = Inception(192, 64, 96, 128, 16, 32, 32, **kw)
        self.inc3b = Inception(256, 128, 128, 192, 32, 96, 64, **kw)
        self.pool3 = MaxPool2D(3, stride=2, padding=1)
        self.inc4a = Inception(480, 192, 96, 208, 16, 48, 64, **kw)
        self.inc4b = Inception(512, 160, 112, 224, 24, 64, 64, **kw)
        self.inc4c = Inception(512, 128, 128, 256, 24, 64, 64, **kw)
        self.inc4d = Inception(512, 112, 144, 288, 32, 64, 64, **kw)
        self.inc4e = Inception(528, 256, 160, 320, 32, 128, 128, **kw)
        self.pool4 = MaxPool2D(3, stride=2, padding=1)
        self.inc5a = Inception(832, 256, 160, 320, 32, 128, 128, **kw)
        self.inc5b = Inception(832, 384, 192, 384, 48, 128, 128, **kw)
        self.aux1 = (_AuxHead(512, num_classes, **kw) if num_classes > 0
                     else None)
        self.aux2 = (_AuxHead(528, num_classes, **kw) if num_classes > 0
                     else None)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.dropout = Dropout(0.2)
            self.fc = linear(1024, num_classes, **kw)

    def forward(self, x):
        x = self.pool3(self.inc3b(self.inc3a(self.stem(x))))
        x = self.inc4a(x)
        aux = self.training and self.aux1 is not None
        aux1 = self.aux1(x) if aux else None
        x = self.inc4d(self.inc4c(self.inc4b(x)))
        aux2 = self.aux2(x) if aux else None
        x = self.pool4(self.inc4e(x))
        x = self.inc5b(self.inc5a(x))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(T.flatten(x, 1)))
        if aux:
            return x, aux1, aux2
        return x


def googlenet(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return GoogLeNet(**kwargs)


__all__ = ["GoogLeNet", "googlenet"]
