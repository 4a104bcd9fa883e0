"""ShuffleNetV2 (counterpart of
``paddle_tpu/vision/models/shufflenetv2.py``): x0.25 to x2.0 and the
swish variant. The channel shuffle is a reshape / transpose / reshape."""
from __future__ import annotations

from ... import tensor as T
from ...nn import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, MaxPool2D, ReLU,
                   Sequential, Swish)
from ...nn.layer import Layer
from ._common import layer_kw, linear, no_pretrained

_STAGE_REPEATS = [4, 8, 4]
_CFG = {
    "x0_25": [24, 24, 48, 96, 512],
    "x0_33": [24, 32, 64, 128, 512],
    "x0_5": [24, 48, 96, 192, 1024],
    "x1_0": [24, 116, 232, 464, 1024],
    "x1_5": [24, 176, 352, 704, 1024],
    "x2_0": [24, 244, 488, 976, 2048],
}


def channel_shuffle(x, groups):
    n, c, h, w = x.shape
    x = T.reshape(x, [n, groups, c // groups, h, w])
    x = T.transpose(x, [0, 2, 1, 3, 4])
    return T.reshape(x, [n, c, h, w])


def _conv_bn(in_ch, out_ch, k, stride=1, groups=1, act=ReLU, **kw):
    layers = [Conv2D(in_ch, out_ch, k, stride=stride, padding=k // 2,
                     groups=groups, bias_attr=False, **kw),
              BatchNorm2D(out_ch, **kw)]
    if act is not None:
        layers.append(act())
    return Sequential(*layers)


class InvertedResidual(Layer):
    def __init__(self, in_ch, out_ch, stride, act=ReLU, **kw):
        super().__init__()
        self.stride = stride
        branch_ch = out_ch // 2
        if stride == 1:
            self.branch2 = Sequential(
                _conv_bn(branch_ch, branch_ch, 1, act=act, **kw),
                _conv_bn(branch_ch, branch_ch, 3, stride, groups=branch_ch,
                         act=None, **kw),
                _conv_bn(branch_ch, branch_ch, 1, act=act, **kw))
            self.branch1 = None
        else:
            self.branch1 = Sequential(
                _conv_bn(in_ch, in_ch, 3, stride, groups=in_ch, act=None,
                         **kw),
                _conv_bn(in_ch, branch_ch, 1, act=act, **kw))
            self.branch2 = Sequential(
                _conv_bn(in_ch, branch_ch, 1, act=act, **kw),
                _conv_bn(branch_ch, branch_ch, 3, stride, groups=branch_ch,
                         act=None, **kw),
                _conv_bn(branch_ch, branch_ch, 1, act=act, **kw))

    def forward(self, x):
        if self.stride == 1:
            x1, x2 = T.split(x, 2, axis=1)
            out = T.concat([x1, self.branch2(x2)], axis=1)
        else:
            out = T.concat([self.branch1(x), self.branch2(x)], axis=1)
        return channel_shuffle(out, 2)


class ShuffleNetV2(Layer):
    def __init__(self, scale="x1_0", act="relu", num_classes=1000,
                 with_pool=True, **kw):
        super().__init__()
        if scale not in _CFG:
            raise ValueError(f"supported scales: {sorted(_CFG)}, got {scale}")
        kw = layer_kw(**kw)
        cfg = _CFG[scale]
        act_layer = Swish if act == "swish" else ReLU
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.conv1 = _conv_bn(3, cfg[0], 3, stride=2, act=act_layer, **kw)
        self.maxpool = MaxPool2D(3, stride=2, padding=1)
        stages = []
        in_ch = cfg[0]
        for i, repeats in enumerate(_STAGE_REPEATS):
            out_ch = cfg[i + 1]
            blocks = [InvertedResidual(in_ch, out_ch, 2, act_layer, **kw)]
            for _ in range(repeats - 1):
                blocks.append(InvertedResidual(out_ch, out_ch, 1, act_layer,
                                               **kw))
            stages.append(Sequential(*blocks))
            in_ch = out_ch
        self.stages = Sequential(*stages)
        self.conv_last = _conv_bn(in_ch, cfg[-1], 1, act=act_layer, **kw)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = linear(cfg[-1], num_classes, **kw)

    def forward(self, x):
        x = self.conv_last(self.stages(self.maxpool(self.conv1(x))))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(T.flatten(x, 1))
        return x


def _shufflenet(scale, act="relu", pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return ShuffleNetV2(scale, act, **kwargs)


def shufflenet_v2_x0_25(pretrained=False, **kwargs):
    return _shufflenet("x0_25", pretrained=pretrained, **kwargs)


def shufflenet_v2_x0_33(pretrained=False, **kwargs):
    return _shufflenet("x0_33", pretrained=pretrained, **kwargs)


def shufflenet_v2_x0_5(pretrained=False, **kwargs):
    return _shufflenet("x0_5", pretrained=pretrained, **kwargs)


def shufflenet_v2_x1_0(pretrained=False, **kwargs):
    return _shufflenet("x1_0", pretrained=pretrained, **kwargs)


def shufflenet_v2_x1_5(pretrained=False, **kwargs):
    return _shufflenet("x1_5", pretrained=pretrained, **kwargs)


def shufflenet_v2_x2_0(pretrained=False, **kwargs):
    return _shufflenet("x2_0", pretrained=pretrained, **kwargs)


def shufflenet_v2_swish(pretrained=False, **kwargs):
    return _shufflenet("x1_0", act="swish", pretrained=pretrained, **kwargs)


__all__ = ["ShuffleNetV2", "shufflenet_v2_swish", "shufflenet_v2_x0_25",
           "shufflenet_v2_x0_33", "shufflenet_v2_x0_5", "shufflenet_v2_x1_0",
           "shufflenet_v2_x1_5", "shufflenet_v2_x2_0"]
