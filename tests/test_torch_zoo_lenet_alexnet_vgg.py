"""LeNet, AlexNet and VGG of the PyTorch port
(``paddle_tpu_torch/vision/models/``) against the reference's on the CPU,
on bridged weights (``torch_port_utils.ZooPair``), each at the smallest
input it takes, 10 classes: the state names, the eval logits, the
training-mode forward (dropout 0, batch statistics: outputs and running
statistics) and the backward with the statistics frozen (input and
parameter gradients, ``ZooPair.backward``); every VGG builder
(with and without batch norm; their feature stacks) built on the port's
side, its output shape checked. Tolerance: rel 1e-4 of the largest reference magnitude
(``ZOO_RTOL``: XLA's and oneDNN's convolutions sum in other orders)."""
import pytest

from paddle_tpu.vision import models as rmodels
from paddle_tpu_torch.vision import models as tmodels

from torch_port_utils import (ZOO_CLASSES, one_torch_thread,  # noqa: F401
                               ZooPair, check_zoo_names,
                              check_zoo_train,
                              port_zoo_shapes, zoo_close)

CASES = {"LeNet": (2, 1, 28, 28), "alexnet": (2, 3, 64, 64),
         "vgg11": (2, 3, 32, 32)}


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    name = request.param
    return name, ZooPair(
        lambda: getattr(rmodels, name)(num_classes=ZOO_CLASSES),
        lambda: getattr(tmodels, name)(num_classes=ZOO_CLASSES,
                                       device="cpu"), CASES[name])


def test_state_names_match_reference(pair):
    _, p = pair
    check_zoo_names(p)


def test_eval_logits_match_reference(pair):
    name, p = pair
    zoo_close(*p.eval_outputs(), what=f"{name} eval logits")


def test_training_step_matches_reference(pair):
    _, p = pair
    check_zoo_train(p)


def test_every_builder_builds():
    # the VGGs' feature stacks (num_classes 0: the 102 M-parameter head is
    # vgg11's, built above)
    shapes = port_zoo_shapes(["vgg13", "vgg16", "vgg19"], (1, 3, 32, 32),
                             classes=0)
    shapes.update(port_zoo_shapes(["vgg11", "vgg16"], (1, 3, 32, 32),
                                  classes=0, batch_norm=True))
    assert set(shapes.values()) == {(1, 512, 7, 7)}
    assert port_zoo_shapes(["alexnet"], (1, 3, 64, 64)) == {
        "alexnet": (1, ZOO_CLASSES)}
    with pytest.raises(NotImplementedError):
        tmodels.vgg16(pretrained=True)


def test_every_reference_class_and_builder_is_exported():
    """All 50 public classes and builders of the reference's zoo, and the
    port's own ResNet blocks."""
    import types

    names = {n for n in dir(rmodels) if not n.startswith("_")
             and not isinstance(getattr(rmodels, n), types.ModuleType)}
    assert len(names) == 50
    assert names <= set(tmodels.__all__)
    assert set(tmodels.__all__) == names | {"BasicBlock", "BottleneckBlock"}
    for n in tmodels.__all__:
        assert callable(getattr(tmodels, n)), n
