"""DenseNet of the PyTorch port against the reference's on the CPU, on
bridged weights (``torch_port_utils.ZooPair``), 10 classes:
``densenet121`` whole at 32 x 32 in eval mode (state names, logits; the
training checks run on its blocks: a whole deep model's gradients part on rounding alone
(one ReLU input within rounding of 0 moved a layer's weight gradient by
1-2 % in Inception-v3's C block at 3 x 3, measured)); the first ``_DenseLayer``
(with and without dropout, 0 in the checks), ``_DenseBlock`` and
``_Transition`` at their shapes in the model through the training-mode forward and the frozen-statistics
backward of ``torch_port_utils.check_zoo_train``; the five depths built
on the port's side, output shapes checked. Tolerance: rel 1e-4
(``ZOO_RTOL``)."""
import pytest

from paddle_tpu.vision import models as rmodels
from paddle_tpu_torch.vision import models as tmodels

from torch_port_utils import (ZOO_CLASSES, one_torch_thread,  # noqa: F401
                               ZooPair, check_zoo_names,
                              check_zoo_train, port_zoo_shapes, zoo_block,
                              zoo_close)

# the first dense block, its first layer (also with dropout, 0 in the
# training checks) and the first transition at their shapes in
# densenet121 at 32 x 32
BLOCKS = {"dense_layer": ("_DenseLayer", (64, 32, 4, 0.0), (2, 64, 8, 8)),
          "dense_layer_dropout": ("_DenseLayer", (64, 32, 4, 0.2),
                                  (2, 64, 8, 8)),
          "dense_block": ("_DenseBlock", (6, 64, 32, 4, 0.0), (2, 64, 8, 8)),
          "transition": ("_Transition", (256, 128), (2, 256, 8, 8))}


def test_densenet121_state_names_and_eval_logits_match_reference():
    p = ZooPair(lambda: rmodels.densenet121(num_classes=ZOO_CLASSES),
                lambda: tmodels.densenet121(num_classes=ZOO_CLASSES,
                                            device="cpu"), (2, 3, 32, 32))
    check_zoo_names(p)
    zoo_close(*p.eval_outputs(), what="densenet121 eval logits")


@pytest.mark.parametrize("block", list(BLOCKS))
def test_block_matches_reference(block):
    name, args, shape = BLOCKS[block]
    p = ZooPair(*zoo_block("densenet", name, *args), shape)
    check_zoo_names(p)
    check_zoo_train(p)


def test_every_depth_builds():
    shapes = port_zoo_shapes(["densenet121", "densenet161", "densenet169",
                              "densenet201", "densenet264"], (1, 3, 32, 32))
    assert set(shapes.values()) == {(1, ZOO_CLASSES)}
    with pytest.raises(ValueError):
        tmodels.DenseNet(100, device="cpu")
