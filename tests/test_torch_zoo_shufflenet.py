"""ShuffleNetV2 of the PyTorch port against the reference's on the CPU,
on bridged weights (``torch_port_utils.ZooPair``), 10 classes:
``shufflenet_v2_x0_25`` whole at 64 x 64 (its last stage 2 x 2, so the
training-mode batch norms see 8 values a channel) through the state
names, the eval logits and ``check_zoo_train``; the swish variant's
``InvertedResidual`` blocks (stride 1: ``split``, the branch, the channel
shuffle; stride 2: both branches) under ``Swish`` through the same
checks; ``channel_shuffle`` against the reference's; all seven builders
built on the port's side, output shapes checked. Tolerance: rel 1e-4
(``ZOO_RTOL``)."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as rnn
import paddle_tpu_torch.nn as tnn
from paddle_tpu.framework.op import raw
from paddle_tpu.vision import models as rmodels
from paddle_tpu.vision.models import shufflenetv2 as rsh
from paddle_tpu_torch.vision import models as tmodels
from paddle_tpu_torch.vision.models import shufflenetv2 as tsh

from torch_port_utils import (ZOO_CLASSES, one_torch_thread,  # noqa: F401
                               ZooPair, check_zoo_names,
                              check_zoo_train, port_zoo_shapes, zoo_close)

BUILDERS = ["shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
            "shufflenet_v2_x0_5", "shufflenet_v2_x1_0",
            "shufflenet_v2_x1_5", "shufflenet_v2_x2_0",
            "shufflenet_v2_swish"]
BLOCKS = {"swish_stride1": (16, 16, 1), "swish_stride2": (8, 16, 2)}


@pytest.fixture(scope="module")
def whole():
    return ZooPair(
        lambda: rmodels.shufflenet_v2_x0_25(num_classes=ZOO_CLASSES),
        lambda: tmodels.shufflenet_v2_x0_25(num_classes=ZOO_CLASSES,
                                            device="cpu"), (2, 3, 64, 64))


def test_state_names_and_eval_logits_match_reference(whole):
    check_zoo_names(whole)
    zoo_close(*whole.eval_outputs(), what="eval logits")


def test_training_checks_match_reference(whole):
    check_zoo_train(whole)


@pytest.mark.parametrize("block", list(BLOCKS))
def test_swish_block_matches_reference(block):
    cin, cout, stride = BLOCKS[block]
    p = ZooPair(lambda: rsh.InvertedResidual(cin, cout, stride, rnn.Swish),
                lambda: tsh.InvertedResidual(cin, cout, stride, tnn.Swish,
                                             device="cpu"), (2, cin, 8, 8))
    check_zoo_names(p)
    check_zoo_train(p)


def test_channel_shuffle_matches_reference():
    x = np.arange(2 * 8 * 3 * 2, dtype=np.float32).reshape(2, 8, 3, 2)
    want = np.asarray(raw(rsh.channel_shuffle(paddle.to_tensor(x), 2)))
    np.testing.assert_array_equal(
        tsh.channel_shuffle(torch.from_numpy(x), 2).numpy(), want)


def test_every_builder_builds():
    shapes = port_zoo_shapes(BUILDERS, (1, 3, 64, 64))
    assert set(shapes.values()) == {(1, ZOO_CLASSES)}
    with pytest.raises(ValueError):
        tmodels.ShuffleNetV2("x3_0", device="cpu")
