"""VGG (counterpart of ``paddle_tpu/vision/models/vgg.py``): the four
configurations A / B / D / E, with or without batch norm."""
from __future__ import annotations

from ... import tensor as T
from ...nn import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Dropout,
                   MaxPool2D, ReLU, Sequential)
from ...nn.layer import Layer
from ._common import layer_kw, linear, no_pretrained

cfgs = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512,
          512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
          512, 512, "M", 512, 512, 512, 512, "M"],
}


def make_layers(cfg, batch_norm=False, **kw):
    """The feature stack of ``cfg``; ``kw`` (device, dtype, generator) as
    :func:`layer_kw` gives it, default one on the default device."""
    kw = kw or layer_kw()
    layers = []
    in_channels = 3
    for v in cfg:
        if v == "M":
            layers.append(MaxPool2D(kernel_size=2, stride=2))
        else:
            layers.append(Conv2D(in_channels, v, kernel_size=3, padding=1,
                                 **kw))
            if batch_norm:
                layers.append(BatchNorm2D(v, **kw))
            layers.append(ReLU())
            in_channels = v
    return Sequential(*layers)


class VGG(Layer):
    def __init__(self, features, num_classes=1000, with_pool=True, **kw):
        super().__init__()
        kw = layer_kw(**kw)
        self.features = features
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = Sequential(
                linear(512 * 7 * 7, 4096, **kw), ReLU(), Dropout(),
                linear(4096, 4096, **kw), ReLU(), Dropout(),
                linear(4096, num_classes, **kw))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(T.flatten(x, 1))
        return x


def _vgg(cfg, batch_norm, pretrained, **kwargs):
    no_pretrained(pretrained)
    kw = layer_kw(**{k: kwargs.pop(k) for k in
                     ("device", "dtype", "generator", "seed")
                     if k in kwargs})
    return VGG(make_layers(cfgs[cfg], batch_norm, **kw), **kwargs, **kw)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("A", batch_norm, pretrained, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("B", batch_norm, pretrained, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("D", batch_norm, pretrained, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("E", batch_norm, pretrained, **kwargs)


__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19"]
