"""DenseNet-121 / 161 / 169 / 201 / 264 (counterpart of
``paddle_tpu/vision/models/densenet.py``): dense blocks that concatenate
every layer's output onto its input, with transitions between them."""
from __future__ import annotations

from ... import tensor as T
from ...nn import (AdaptiveAvgPool2D, AvgPool2D, BatchNorm2D, Conv2D,
                   Dropout, MaxPool2D, ReLU, Sequential)
from ...nn.layer import Layer
from ._common import layer_kw, linear, no_pretrained

_CFG = {
    121: (64, 32, [6, 12, 24, 16]),
    161: (96, 48, [6, 12, 36, 24]),
    169: (64, 32, [6, 12, 32, 32]),
    201: (64, 32, [6, 12, 48, 32]),
    264: (64, 32, [6, 12, 64, 48]),
}


class _DenseLayer(Layer):
    def __init__(self, in_ch, growth_rate, bn_size, dropout, **kw):
        super().__init__()
        kw = kw or layer_kw()
        self.norm1 = BatchNorm2D(in_ch, **kw)
        self.relu = ReLU()
        self.conv1 = Conv2D(in_ch, bn_size * growth_rate, 1, bias_attr=False,
                            **kw)
        self.norm2 = BatchNorm2D(bn_size * growth_rate, **kw)
        self.conv2 = Conv2D(bn_size * growth_rate, growth_rate, 3, padding=1,
                            bias_attr=False, **kw)
        self.dropout = Dropout(dropout) if dropout else None

    def forward(self, x):
        out = self.conv1(self.relu(self.norm1(x)))
        out = self.conv2(self.relu(self.norm2(out)))
        if self.dropout is not None:
            out = self.dropout(out)
        return T.concat([x, out], axis=1)


class _DenseBlock(Layer):
    def __init__(self, num_layers, in_ch, growth_rate, bn_size, dropout,
                 **kw):
        super().__init__()
        self.layers = Sequential(*[
            _DenseLayer(in_ch + i * growth_rate, growth_rate, bn_size,
                        dropout, **kw) for i in range(num_layers)])

    def forward(self, x):
        return self.layers(x)


class _Transition(Layer):
    def __init__(self, in_ch, out_ch, **kw):
        super().__init__()
        kw = kw or layer_kw()
        self.norm = BatchNorm2D(in_ch, **kw)
        self.relu = ReLU()
        self.conv = Conv2D(in_ch, out_ch, 1, bias_attr=False, **kw)
        self.pool = AvgPool2D(2, stride=2)

    def forward(self, x):
        return self.pool(self.conv(self.relu(self.norm(x))))


class DenseNet(Layer):
    def __init__(self, layers=121, bn_size=4, dropout=0.0, num_classes=1000,
                 with_pool=True, **kw):
        super().__init__()
        if layers not in _CFG:
            raise ValueError(f"supported depths: {sorted(_CFG)}, got {layers}")
        kw = layer_kw(**kw)
        num_init, growth_rate, block_cfg = _CFG[layers]
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = Sequential(
            Conv2D(3, num_init, 7, stride=2, padding=3, bias_attr=False,
                   **kw),
            BatchNorm2D(num_init, **kw), ReLU(),
            MaxPool2D(3, stride=2, padding=1))
        blocks = []
        ch = num_init
        for i, n in enumerate(block_cfg):
            blocks.append(_DenseBlock(n, ch, growth_rate, bn_size, dropout,
                                      **kw))
            ch += n * growth_rate
            if i != len(block_cfg) - 1:
                blocks.append(_Transition(ch, ch // 2, **kw))
                ch //= 2
        self.blocks = Sequential(*blocks)
        self.norm_final = BatchNorm2D(ch, **kw)
        self.relu = ReLU()
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.classifier = linear(ch, num_classes, **kw)

    def forward(self, x):
        x = self.relu(self.norm_final(self.blocks(self.stem(x))))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(T.flatten(x, 1))
        return x


def _densenet(depth, pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return DenseNet(depth, **kwargs)


def densenet121(pretrained=False, **kwargs):
    return _densenet(121, pretrained, **kwargs)


def densenet161(pretrained=False, **kwargs):
    return _densenet(161, pretrained, **kwargs)


def densenet169(pretrained=False, **kwargs):
    return _densenet(169, pretrained, **kwargs)


def densenet201(pretrained=False, **kwargs):
    return _densenet(201, pretrained, **kwargs)


def densenet264(pretrained=False, **kwargs):
    return _densenet(264, pretrained, **kwargs)


__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201", "densenet264"]
