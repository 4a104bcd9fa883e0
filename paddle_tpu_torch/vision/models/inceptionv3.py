"""Inception-v3 (counterpart of
``paddle_tpu/vision/models/inceptionv3.py``), for 299 x 299 inputs."""
from __future__ import annotations

from ... import tensor as T
from ...nn import (AdaptiveAvgPool2D, AvgPool2D, Dropout, MaxPool2D,
                   Sequential)
from ...nn.layer import Layer
from ._common import layer_kw, linear, no_pretrained
from .googlenet import _BasicConv


class InceptionA(Layer):
    def __init__(self, in_ch, pool_features, **kw):
        super().__init__()
        self.b1 = _BasicConv(in_ch, 64, 1, **kw)
        self.b5 = Sequential(_BasicConv(in_ch, 48, 1, **kw),
                             _BasicConv(48, 64, 5, padding=2, **kw))
        self.b3 = Sequential(_BasicConv(in_ch, 64, 1, **kw),
                             _BasicConv(64, 96, 3, padding=1, **kw),
                             _BasicConv(96, 96, 3, padding=1, **kw))
        self.bp = Sequential(AvgPool2D(3, stride=1, padding=1),
                             _BasicConv(in_ch, pool_features, 1, **kw))

    def forward(self, x):
        return T.concat([self.b1(x), self.b5(x), self.b3(x), self.bp(x)],
                        axis=1)


class InceptionB(Layer):
    """Grid reduction 35 -> 17."""

    def __init__(self, in_ch, **kw):
        super().__init__()
        self.b3 = _BasicConv(in_ch, 384, 3, stride=2, **kw)
        self.b3d = Sequential(_BasicConv(in_ch, 64, 1, **kw),
                              _BasicConv(64, 96, 3, padding=1, **kw),
                              _BasicConv(96, 96, 3, stride=2, **kw))
        self.pool = MaxPool2D(3, stride=2)

    def forward(self, x):
        return T.concat([self.b3(x), self.b3d(x), self.pool(x)], axis=1)


class InceptionC(Layer):
    def __init__(self, in_ch, c7, **kw):
        super().__init__()
        self.b1 = _BasicConv(in_ch, 192, 1, **kw)
        self.b7 = Sequential(
            _BasicConv(in_ch, c7, 1, **kw),
            _BasicConv(c7, c7, (1, 7), padding=(0, 3), **kw),
            _BasicConv(c7, 192, (7, 1), padding=(3, 0), **kw))
        self.b7d = Sequential(
            _BasicConv(in_ch, c7, 1, **kw),
            _BasicConv(c7, c7, (7, 1), padding=(3, 0), **kw),
            _BasicConv(c7, c7, (1, 7), padding=(0, 3), **kw),
            _BasicConv(c7, c7, (7, 1), padding=(3, 0), **kw),
            _BasicConv(c7, 192, (1, 7), padding=(0, 3), **kw))
        self.bp = Sequential(AvgPool2D(3, stride=1, padding=1),
                             _BasicConv(in_ch, 192, 1, **kw))

    def forward(self, x):
        return T.concat([self.b1(x), self.b7(x), self.b7d(x), self.bp(x)],
                        axis=1)


class InceptionD(Layer):
    """Grid reduction 17 -> 8."""

    def __init__(self, in_ch, **kw):
        super().__init__()
        self.b3 = Sequential(_BasicConv(in_ch, 192, 1, **kw),
                             _BasicConv(192, 320, 3, stride=2, **kw))
        self.b7 = Sequential(
            _BasicConv(in_ch, 192, 1, **kw),
            _BasicConv(192, 192, (1, 7), padding=(0, 3), **kw),
            _BasicConv(192, 192, (7, 1), padding=(3, 0), **kw),
            _BasicConv(192, 192, 3, stride=2, **kw))
        self.pool = MaxPool2D(3, stride=2)

    def forward(self, x):
        return T.concat([self.b3(x), self.b7(x), self.pool(x)], axis=1)


class InceptionE(Layer):
    def __init__(self, in_ch, **kw):
        super().__init__()
        self.b1 = _BasicConv(in_ch, 320, 1, **kw)
        self.b3_stem = _BasicConv(in_ch, 384, 1, **kw)
        self.b3_a = _BasicConv(384, 384, (1, 3), padding=(0, 1), **kw)
        self.b3_b = _BasicConv(384, 384, (3, 1), padding=(1, 0), **kw)
        self.b3d_stem = Sequential(_BasicConv(in_ch, 448, 1, **kw),
                                   _BasicConv(448, 384, 3, padding=1, **kw))
        self.b3d_a = _BasicConv(384, 384, (1, 3), padding=(0, 1), **kw)
        self.b3d_b = _BasicConv(384, 384, (3, 1), padding=(1, 0), **kw)
        self.bp = Sequential(AvgPool2D(3, stride=1, padding=1),
                             _BasicConv(in_ch, 192, 1, **kw))

    def forward(self, x):
        s = self.b3_stem(x)
        b3 = T.concat([self.b3_a(s), self.b3_b(s)], axis=1)
        d = self.b3d_stem(x)
        b3d = T.concat([self.b3d_a(d), self.b3d_b(d)], axis=1)
        return T.concat([self.b1(x), b3, b3d, self.bp(x)], axis=1)


class InceptionV3(Layer):
    def __init__(self, num_classes=1000, with_pool=True, **kw):
        super().__init__()
        kw = layer_kw(**kw)
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = Sequential(
            _BasicConv(3, 32, 3, stride=2, **kw),
            _BasicConv(32, 32, 3, **kw),
            _BasicConv(32, 64, 3, padding=1, **kw),
            MaxPool2D(3, stride=2),
            _BasicConv(64, 80, 1, **kw),
            _BasicConv(80, 192, 3, **kw),
            MaxPool2D(3, stride=2))
        self.blocks = Sequential(
            InceptionA(192, 32, **kw), InceptionA(256, 64, **kw),
            InceptionA(288, 64, **kw),
            InceptionB(288, **kw),
            InceptionC(768, 128, **kw), InceptionC(768, 160, **kw),
            InceptionC(768, 160, **kw), InceptionC(768, 192, **kw),
            InceptionD(768, **kw),
            InceptionE(1280, **kw), InceptionE(2048, **kw))
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.dropout = Dropout(0.5)
            self.fc = linear(2048, num_classes, **kw)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(T.flatten(x, 1)))
        return x


def inception_v3(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return InceptionV3(**kwargs)


__all__ = ["InceptionV3", "inception_v3"]
