"""MobileNet V1 / V2 (counterpart of
``paddle_tpu/vision/models/mobilenet.py``): depthwise-separable
convolutions (``Conv2D`` with ``groups`` = channels), V2's inverted
residuals under ``ReLU6``."""
from __future__ import annotations

from ... import tensor as T
from ...nn import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Dropout, ReLU,
                   ReLU6, Sequential)
from ...nn.layer import Layer
from ._common import layer_kw, linear, no_pretrained


def _conv_bn(inp, oup, kernel, stride, padding=0, groups=1, act=ReLU,
             **kw):
    layers = [Conv2D(inp, oup, kernel, stride=stride, padding=padding,
                     groups=groups, bias_attr=False, **kw),
              BatchNorm2D(oup, **kw)]
    if act is not None:
        layers.append(act())
    return Sequential(*layers)


class MobileNetV1(Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, **kw):
        super().__init__()
        kw = layer_kw(**kw)
        self.num_classes = num_classes
        self.with_pool = with_pool

        def c(ch):
            return max(int(ch * scale), 8)

        def dw_sep(inp, oup, stride):
            return Sequential(_conv_bn(inp, inp, 3, stride, 1, groups=inp,
                                       **kw),
                              _conv_bn(inp, oup, 1, 1, **kw))

        self.features = Sequential(
            _conv_bn(3, c(32), 3, 2, 1, **kw),
            dw_sep(c(32), c(64), 1),
            dw_sep(c(64), c(128), 2),
            dw_sep(c(128), c(128), 1),
            dw_sep(c(128), c(256), 2),
            dw_sep(c(256), c(256), 1),
            dw_sep(c(256), c(512), 2),
            *[dw_sep(c(512), c(512), 1) for _ in range(5)],
            dw_sep(c(512), c(1024), 2),
            dw_sep(c(1024), c(1024), 1))
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self._out_c = c(1024)
            self.fc = linear(self._out_c, num_classes, **kw)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(T.flatten(x, 1))
        return x


class InvertedResidual(Layer):
    def __init__(self, inp, oup, stride, expand_ratio, **kw):
        super().__init__()
        self.stride = stride
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(_conv_bn(inp, hidden, 1, 1, act=ReLU6, **kw))
        layers += [_conv_bn(hidden, hidden, 3, stride, 1, groups=hidden,
                            act=ReLU6, **kw),
                   _conv_bn(hidden, oup, 1, 1, act=None, **kw)]
        self.conv = Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return T.add(x, out) if self.use_res else out


def _make_divisible(v, divisor=8, min_value=None):
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class MobileNetV2(Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, **kw):
        super().__init__()
        kw = layer_kw(**kw)
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        input_channel = _make_divisible(32 * scale)
        layers = [_conv_bn(3, input_channel, 3, 2, 1, act=ReLU6, **kw)]
        for t, ch, n, s in cfg:
            out_c = _make_divisible(ch * scale)
            for i in range(n):
                layers.append(InvertedResidual(input_channel, out_c,
                                               s if i == 0 else 1, t, **kw))
                input_channel = out_c
        self.last_channel = _make_divisible(1280 * max(1.0, scale))
        layers.append(_conv_bn(input_channel, self.last_channel, 1, 1,
                               act=ReLU6, **kw))
        self.features = Sequential(*layers)
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.classifier = Sequential(
                Dropout(0.2), linear(self.last_channel, num_classes, **kw))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(T.flatten(x, 1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV1(scale=scale, **kwargs)


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV2(scale=scale, **kwargs)


__all__ = ["MobileNetV1", "MobileNetV2", "mobilenet_v1", "mobilenet_v2"]
