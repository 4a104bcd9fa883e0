"""``paddle.summary`` (counterpart of ``paddle_tpu/hapi/model_summary.py``):
a per-layer table (name, type, output shape, own parameters) taken with
forward hooks over one eval-mode forward, and the parameter counts. The
reference's ``flops`` (its compiler's cost analysis of the forward) stays
with ``TrainStep.cost_analysis`` (ROADMAP.md §A.3)."""
from __future__ import annotations

import torch


def _device(net):
    p = next(iter(net.parameters()), None)
    return p.device if p is not None else torch.device("cpu")


def summary(net: torch.nn.Module, input_size=None, dtypes=None, input=None):
    """Print the table and return ``{"total_params",
    "trainable_params"}``. The forward runs on ``input`` (a tensor or a
    tuple of them), else on zeros of ``input_size`` (one shape or a list
    of shapes, ``None`` dims as 1) in ``dtypes`` (default f32), on the
    network's device."""
    rows = []

    def mk_hook(name):
        def hook(layer, inputs, outputs):
            out = outputs[0] if isinstance(outputs, (tuple, list)) \
                else outputs
            shape = list(out.shape) if isinstance(out, torch.Tensor) else "-"
            n = sum(p.numel() for p in layer.parameters(recurse=False))
            rows.append((name, type(layer).__name__, shape, n))
        return hook

    hooks = [sub.register_forward_hook(mk_hook(name))
             for name, sub in net.named_modules() if name]
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            if input is not None:
                net(*(input if isinstance(input, (tuple, list))
                      else (input,)))
            else:
                if input_size is None:
                    raise ValueError("summary needs input_size or input")
                sizes = (input_size if isinstance(input_size[0],
                                                  (tuple, list))
                         else [input_size])
                dts = dtypes or ["float32"] * len(sizes)
                net(*(torch.zeros([s if s is not None else 1 for s in size],
                                  dtype=getattr(torch, dt),
                                  device=_device(net))
                      for size, dt in zip(sizes, dts)))
    finally:
        net.train(was_training)
        for h in hooks:
            h.remove()

    total = sum(p.numel() for p in net.parameters())
    trainable = sum(p.numel() for p in net.parameters() if p.requires_grad)
    line = "-" * 78
    print(line)
    print(f"{'Layer (type)':<34}{'Output Shape':<26}{'Param #':>14}")
    print(line)
    for name, cls, shape, n in rows:
        print(f"{name + ' (' + cls + ')':<34}{str(shape):<26}{n:>14,}")
    print(line)
    print(f"Total params: {total:,}")
    print(f"Trainable params: {trainable:,}")
    print(f"Non-trainable params: {total - trainable:,}")
    print(line)
    return {"total_params": total, "trainable_params": trainable}


__all__ = ["summary"]
