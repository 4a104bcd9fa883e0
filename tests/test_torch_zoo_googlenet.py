"""GoogLeNet of the PyTorch port against the reference's on the CPU, on
bridged weights (``torch_port_utils.ZooPair``), 10 classes: the whole
model at 64 x 64 (its last stage 2 x 2) through the state names, the eval
logits, and the training-mode forward, which returns ``(out, aux1,
aux2)`` as the reference's (dropout 0; the outputs and the running
statistics); the backward on its blocks (``inc3a``'s ``Inception``
module and ``aux1``'s ``_AuxHead``, at their shapes in the model) with ``torch_port_utils.check_zoo_train``: a whole deep model's gradients part on rounding alone
(one ReLU input within rounding of 0 moved a layer's weight gradient by
1-2 % in Inception-v3's C block at 3 x 3, measured). Tolerance: rel 1e-4 (``ZOO_RTOL``)."""
import pytest

from paddle_tpu.vision import models as rmodels
from paddle_tpu_torch.vision import models as tmodels

from torch_port_utils import (ZOO_CLASSES, one_torch_thread,  # noqa: F401
                               ZooPair, check_zoo_names,
                              check_zoo_stats, check_zoo_train,
                              port_zoo_shapes, zoo_block,
                              zoo_close)

# at the whole model's shapes (inc3a's input, inc4a's output at 64 x 64)
BLOCKS = {"inception": ("Inception", (192, 64, 96, 128, 16, 32, 32),
                        (2, 192, 8, 8)),
          "aux_head": ("_AuxHead", (512, ZOO_CLASSES), (2, 512, 4, 4))}


@pytest.fixture(scope="module")
def whole():
    return ZooPair(lambda: rmodels.googlenet(num_classes=ZOO_CLASSES),
                   lambda: tmodels.googlenet(num_classes=ZOO_CLASSES,
                                             device="cpu"), (2, 3, 64, 64))


def test_state_names_and_eval_logits_match_reference(whole):
    check_zoo_names(whole)
    zoo_close(*whole.eval_outputs(), what="eval logits")


def test_training_forward_returns_aux_heads_as_reference(whole):
    res = whole.train_forward()
    assert len(res["outputs"]) == 3
    for i, (got, want) in enumerate(res["outputs"]):
        assert got.shape == (2, ZOO_CLASSES)
        zoo_close(got, want, what=f"training-mode output {i}")
    check_zoo_stats(res["stats"])


@pytest.mark.parametrize("block", list(BLOCKS))
def test_block_matches_reference(block):
    name, args, shape = BLOCKS[block]
    p = ZooPair(*zoo_block("googlenet", name, *args), shape)
    check_zoo_names(p)
    check_zoo_train(p)


def test_builder_builds():
    assert port_zoo_shapes(["googlenet"], (1, 3, 64, 64)) == {
        "googlenet": (1, ZOO_CLASSES)}
    with pytest.raises(NotImplementedError):
        tmodels.googlenet(pretrained=True)
