"""SqueezeNet 1.0 / 1.1 and MobileNet V1 / V2 of the PyTorch port against
the reference's on the CPU, on bridged weights
(``torch_port_utils.ZooPair``), 10 classes. Whole models: SqueezeNet 1.1
at 32 x 32 and MobileNet V1 at 64 x 64 (state names, eval logits,
the training-mode forward and the backward of
``torch_port_utils.check_zoo_train``; at 32 x 32 MobileNet V1's last
batch norms see 2 values a channel in training mode and amplify rounding
to 3e-3 of the logits, measured);
SqueezeNet 1.0 at 64 x 64 (state names, eval logits); MobileNet V2's
``InvertedResidual`` blocks (expand 1 and 6, with and without the
residual) at 8 channels through the same checks. MobileNet V2 whole
in eval mode is in ``test_torch_zoo_mobilenet_v3.py``; the blocks here
carry its training checks. Every builder built on the port's side,
output shapes checked.
Tolerance: rel 1e-4 (``ZOO_RTOL``)."""
import pytest

from paddle_tpu.vision import models as rmodels
from paddle_tpu_torch.vision import models as tmodels

from torch_port_utils import (ZOO_CLASSES, one_torch_thread,  # noqa: F401
                               ZooPair, check_zoo_names,
                              check_zoo_train,
                              port_zoo_shapes, zoo_block, zoo_close)

WHOLE = {"squeezenet1_1": (2, 3, 32, 32), "mobilenet_v1": (2, 3, 64, 64),
         "squeezenet1_0": (2, 3, 64, 64)}
TRAINED = ("squeezenet1_1", "mobilenet_v1")
BLOCKS = {"v2_expand1": (8, 8, 1, 1), "v2_expand6_res": (8, 8, 1, 6),
          "v2_expand6_stride2": (8, 16, 2, 6)}


_PAIRS = {}


def _pair(name):
    if name not in _PAIRS:
        _PAIRS[name] = ZooPair(
            lambda: getattr(rmodels, name)(num_classes=ZOO_CLASSES),
            lambda: getattr(tmodels, name)(num_classes=ZOO_CLASSES,
                                           device="cpu"), WHOLE[name])
    return _PAIRS[name]


@pytest.mark.parametrize("name", list(WHOLE))
def test_state_names_and_eval_logits_match_reference(name):
    p = _pair(name)
    check_zoo_names(p)
    zoo_close(*p.eval_outputs(), what=f"{name} eval logits")


@pytest.mark.parametrize("name", TRAINED)
def test_training_step_matches_reference(name):
    check_zoo_train(_pair(name))


@pytest.mark.parametrize("block", list(BLOCKS))
def test_inverted_residual_v2_matches_reference(block):
    p = ZooPair(*zoo_block("mobilenet", "InvertedResidual", *BLOCKS[block]),
                (2, 8, 8, 8))
    check_zoo_names(p)
    check_zoo_train(p)


def test_every_builder_builds():
    shapes = port_zoo_shapes(["squeezenet1_0", "squeezenet1_1",
                              "mobilenet_v1", "mobilenet_v2"],
                             (1, 3, 64, 64))
    shapes.update(port_zoo_shapes(["mobilenet_v1", "mobilenet_v2"],
                                  (1, 3, 32, 32), scale=0.5))
    assert set(shapes.values()) == {(1, ZOO_CLASSES)}
