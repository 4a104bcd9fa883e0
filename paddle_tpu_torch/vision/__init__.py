"""``paddle.vision`` of the port (counterpart of ``paddle_tpu/vision``):
``models`` (the ResNet family), ``transforms`` (host numpy, Python's
``random``) and ``datasets`` (``FakeData``, ``DatasetFolder``,
``ImageFolder``). ``vision/ops.py`` and the image backends wait
(ROADMAP.md §A.6)."""
from . import datasets, models, transforms

__all__ = ["datasets", "models", "transforms"]
