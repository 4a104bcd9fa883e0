"""The Vision Transformer of the PyTorch port
(``paddle_tpu_torch/vision/models/vit.py``, on ``nn.MultiHeadAttention``)
against the reference's on the CPU, on bridged weights
(``torch_port_utils.ZooPair``), 10 classes: a 2-layer ViT (32 x 32,
patch 16, embed 64, 4 heads: T = 5) through the state names, the eval
logits and ``torch_port_utils.check_zoo_train`` (outputs, then the input
and parameter gradients, the class token and position table
included); ``PatchEmbed``, ``MLP`` and ``Block`` alone; ``vit_b_16`` and
``vit_l_16`` built on the port's side at 224 x 224, their parameter
counts (ViT-B/16 86.6 M at 1000 classes, Dosovitskiy et al. 2021,
Table 1) and output shapes checked; ``pretrained=True`` refused.
Tolerance: rel 1e-4 (``ZOO_RTOL``)."""
import pytest
import torch

from paddle_tpu.vision.models import vit as rvit
from paddle_tpu_torch.vision import models as tmodels
from paddle_tpu_torch.vision.models import vit as tvit

from torch_port_utils import (ZOO_CLASSES, one_torch_thread,  # noqa: F401
                               ZooPair, check_zoo_names,
                              check_zoo_train, zoo_block, zoo_close)

TINY = dict(img_size=32, patch_size=16, embed_dim=64, depth=2, num_heads=4,
            num_classes=ZOO_CLASSES)
BLOCKS = {"patch_embed": ("PatchEmbed", (32, 16, 3, 64), (2, 3, 32, 32)),
          "mlp": ("MLP", (64, 128), (2, 5, 64)),
          "block": ("Block", (64, 4), (2, 5, 64))}


@pytest.fixture(scope="module")
def tiny():
    return ZooPair(lambda: rvit.VisionTransformer(**TINY),
                   lambda: tvit.VisionTransformer(**TINY, device="cpu"),
                   (2, 3, 32, 32))


def test_state_names_and_eval_logits_match_reference(tiny):
    check_zoo_names(tiny)
    zoo_close(*tiny.eval_outputs(), what="eval logits")


def test_training_checks_match_reference(tiny):
    check_zoo_train(tiny)


@pytest.mark.parametrize("block", list(BLOCKS))
def test_block_matches_reference(block):
    name, args, shape = BLOCKS[block]
    p = ZooPair(*zoo_block("vit", name, *args), shape)
    check_zoo_names(p)
    check_zoo_train(p)


@pytest.mark.parametrize("name,params", [("vit_b_16", 86_567_656),
                                         ("vit_l_16", 304_326_632)])
def test_builders_at_published_widths(name, params):
    m = getattr(tmodels, name)(device="cpu")
    assert sum(p.numel() for p in m.parameters()) == params
    assert m.pos_embed.shape == (1, 197, m.pos_embed.shape[2])
    m = getattr(tmodels, name)(num_classes=ZOO_CLASSES, device="cpu")
    m.eval()
    with torch.no_grad():
        assert tuple(m(torch.zeros(1, 3, 224, 224)).shape) == \
            (1, ZOO_CLASSES)
    with pytest.raises(NotImplementedError):
        getattr(tmodels, name)(pretrained=True)
