"""MobileNetV3 (and MobileNet V2 whole) of the PyTorch port against the
reference's on the CPU, on bridged weights (``torch_port_utils.ZooPair``),
10 classes: MobileNet V2 and MobileNetV3-Small whole at 32 x 32 (state
names, eval logits); MobileNetV3's blocks through the training-mode
forward and the frozen-statistics backward of
``torch_port_utils.check_zoo_train``: ``_ConvBNAct`` with ``Hardswish``,
``SqueezeExcitation`` (its ``Hardsigmoid`` gate), ``InvertedResidual``
with the squeeze-excite, ``Hardswish`` and the residual, and a stride-2
one under ``ReLU`` without them. The whole models' training checks
run on the blocks: a whole deep model's gradients part on rounding alone
(one ReLU input within rounding of 0 moved a layer's weight gradient by
1-2 % in Inception-v3's C block at 3 x 3, measured).
Every builder built on the port's side, output shapes checked.
Tolerance: rel 1e-4 (``ZOO_RTOL``)."""
import pytest

import paddle_tpu.nn as rnn
import paddle_tpu_torch.nn as tnn
from paddle_tpu.vision import models as rmodels
from paddle_tpu.vision.models import mobilenetv3 as rv3
from paddle_tpu_torch.vision import models as tmodels
from paddle_tpu_torch.vision.models import mobilenetv3 as tv3

from torch_port_utils import (ZOO_CLASSES, one_torch_thread,  # noqa: F401
                               ZooPair, check_zoo_names,
                              check_zoo_train, port_zoo_shapes, zoo_close)

WHOLE = {"mobilenet_v2": (2, 3, 32, 32), "mobilenet_v3_small": (2, 3, 32, 32)}
# (block, args after the activation is resolved, input shape)
BLOCKS = {
    "conv_bn_hardswish": (lambda m, a, **kw: m._ConvBNAct(
        8, 16, 3, 2, act=a.Hardswish, **kw), (2, 8, 8, 8)),
    "squeeze_excitation": (lambda m, a, **kw: m.SqueezeExcitation(
        16, 8, **kw), (2, 16, 4, 4)),
    "inverted_se_hardswish_residual": (lambda m, a, **kw: m.InvertedResidual(
        8, 16, 8, 3, 1, True, a.Hardswish, **kw), (2, 8, 8, 8)),
    "inverted_relu_stride2": (lambda m, a, **kw: m.InvertedResidual(
        8, 24, 16, 5, 2, False, a.ReLU, **kw), (2, 8, 8, 8)),
}


@pytest.mark.parametrize("name", list(WHOLE))
def test_state_names_and_eval_logits_match_reference(name):
    p = ZooPair(lambda: getattr(rmodels, name)(num_classes=ZOO_CLASSES),
                lambda: getattr(tmodels, name)(num_classes=ZOO_CLASSES,
                                               device="cpu"), WHOLE[name])
    check_zoo_names(p)
    zoo_close(*p.eval_outputs(), what=f"{name} eval logits")


@pytest.mark.parametrize("block", list(BLOCKS))
def test_block_matches_reference(block):
    make, shape = BLOCKS[block]
    p = ZooPair(lambda: make(rv3, rnn),
                lambda: make(tv3, tnn, device="cpu"), shape)
    check_zoo_names(p)
    check_zoo_train(p)


def test_every_builder_builds():
    shapes = port_zoo_shapes(["mobilenet_v3_large", "mobilenet_v3_small"],
                             (1, 3, 32, 32))
    shapes.update(port_zoo_shapes(["mobilenet_v3_large"], (1, 3, 32, 32),
                                  scale=0.75))
    assert set(shapes.values()) == {(1, ZOO_CLASSES)}
