"""MobileNetV3 Large / Small (counterpart of
``paddle_tpu/vision/models/mobilenetv3.py``): inverted residuals under
``ReLU`` or ``Hardswish``, some with a squeeze-excite block gated by
``Hardsigmoid``."""
from __future__ import annotations

from ... import tensor as T
from ...nn import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Dropout,
                   Hardsigmoid, Hardswish, ReLU, Sequential)
from ...nn.layer import Layer
from ._common import layer_kw, linear, no_pretrained
from .mobilenet import _make_divisible


class _ConvBNAct(Layer):
    def __init__(self, in_ch, out_ch, k, stride=1, groups=1, act=None,
                 **kw):
        super().__init__()
        self.conv = Conv2D(in_ch, out_ch, k, stride=stride, padding=k // 2,
                           groups=groups, bias_attr=False, **kw)
        self.bn = BatchNorm2D(out_ch, **kw)
        self.act = act() if act else None

    def forward(self, x):
        x = self.bn(self.conv(x))
        return self.act(x) if self.act else x


class SqueezeExcitation(Layer):
    def __init__(self, ch, squeeze_ch, **kw):
        super().__init__()
        self.avgpool = AdaptiveAvgPool2D(1)
        self.fc1 = Conv2D(ch, squeeze_ch, 1, **kw)
        self.relu = ReLU()
        self.fc2 = Conv2D(squeeze_ch, ch, 1, **kw)
        self.hsig = Hardsigmoid()

    def forward(self, x):
        s = self.hsig(self.fc2(self.relu(self.fc1(self.avgpool(x)))))
        return T.multiply(x, s)


class InvertedResidual(Layer):
    def __init__(self, in_ch, exp_ch, out_ch, k, stride, use_se, act, **kw):
        super().__init__()
        self.use_res = stride == 1 and in_ch == out_ch
        layers = []
        if exp_ch != in_ch:
            layers.append(_ConvBNAct(in_ch, exp_ch, 1, act=act, **kw))
        layers.append(_ConvBNAct(exp_ch, exp_ch, k, stride=stride,
                                 groups=exp_ch, act=act, **kw))
        if use_se:
            layers.append(SqueezeExcitation(
                exp_ch, _make_divisible(exp_ch // 4), **kw))
        layers.append(_ConvBNAct(exp_ch, out_ch, 1, act=None, **kw))
        self.block = Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        return T.add(x, out) if self.use_res else out


# (kernel, exp, out, use_se, act, stride): the reference's tables
_LARGE = [
    (3, 16, 16, False, ReLU, 1), (3, 64, 24, False, ReLU, 2),
    (3, 72, 24, False, ReLU, 1), (5, 72, 40, True, ReLU, 2),
    (5, 120, 40, True, ReLU, 1), (5, 120, 40, True, ReLU, 1),
    (3, 240, 80, False, Hardswish, 2), (3, 200, 80, False, Hardswish, 1),
    (3, 184, 80, False, Hardswish, 1), (3, 184, 80, False, Hardswish, 1),
    (3, 480, 112, True, Hardswish, 1), (3, 672, 112, True, Hardswish, 1),
    (5, 672, 160, True, Hardswish, 2), (5, 960, 160, True, Hardswish, 1),
    (5, 960, 160, True, Hardswish, 1),
]
_SMALL = [
    (3, 16, 16, True, ReLU, 2), (3, 72, 24, False, ReLU, 2),
    (3, 88, 24, False, ReLU, 1), (5, 96, 40, True, Hardswish, 2),
    (5, 240, 40, True, Hardswish, 1), (5, 240, 40, True, Hardswish, 1),
    (5, 120, 48, True, Hardswish, 1), (5, 144, 48, True, Hardswish, 1),
    (5, 288, 96, True, Hardswish, 2), (5, 576, 96, True, Hardswish, 1),
    (5, 576, 96, True, Hardswish, 1),
]


class MobileNetV3(Layer):
    def __init__(self, config, last_channel, scale=1.0, num_classes=1000,
                 with_pool=True, **kw):
        super().__init__()
        kw = layer_kw(**kw)
        self.num_classes = num_classes
        self.with_pool = with_pool
        in_ch = _make_divisible(16 * scale)
        layers = [_ConvBNAct(3, in_ch, 3, stride=2, act=Hardswish, **kw)]
        for k, exp, out, use_se, act, stride in config:
            exp_ch = _make_divisible(exp * scale)
            out_ch = _make_divisible(out * scale)
            layers.append(InvertedResidual(in_ch, exp_ch, out_ch, k, stride,
                                           use_se, act, **kw))
            in_ch = out_ch
        last_conv = _make_divisible(6 * in_ch)
        layers.append(_ConvBNAct(in_ch, last_conv, 1, act=Hardswish, **kw))
        self.features = Sequential(*layers)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = Sequential(
                linear(last_conv, last_channel, **kw), Hardswish(),
                Dropout(0.2), linear(last_channel, num_classes, **kw))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(T.flatten(x, 1))
        return x


class MobileNetV3Large(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, **kw):
        super().__init__(_LARGE, _make_divisible(1280 * scale), scale,
                         num_classes, with_pool, **kw)


class MobileNetV3Small(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, **kw):
        super().__init__(_SMALL, _make_divisible(1024 * scale), scale,
                         num_classes, with_pool, **kw)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV3Large(scale=scale, **kwargs)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV3Small(scale=scale, **kwargs)


__all__ = ["MobileNetV3Large", "MobileNetV3Small", "mobilenet_v3_large",
           "mobilenet_v3_small"]
