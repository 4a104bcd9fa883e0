"""hapi (counterpart of ``paddle_tpu/hapi``): callbacks and the model
summary; ``paddle.Model`` itself is ``hapi_model.py``."""
from . import callbacks  # noqa: F401
from .model_summary import summary  # noqa: F401
