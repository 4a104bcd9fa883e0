"""Metrics (counterpart of ``paddle_tpu/metric/__init__.py``).

``Metric``, ``Accuracy`` (top-k), ``Precision``, ``Recall``, ``Auc`` and
``accuracy``. The statistics are kept on the host in numpy with the
reference's arithmetic (its ``argsort`` for the top-k, so ties break the
same way); predictions and labels may be tensors on any device or
arrays, and are read to the host once per batch.
"""
from __future__ import annotations

import numpy as np
import torch


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class Metric:
    def __init__(self):
        pass

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        super().__init__()
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        """``[..., maxk]`` f32: whether each of the top ``maxk`` classes
        of ``pred`` is the label (class ids, or one-hot / soft labels)."""
        pv, lv = _np(pred), _np(label)
        idx = np.argsort(-pv, axis=-1)[..., :self.maxk]
        if lv.ndim == pv.ndim:
            lv = lv.squeeze(-1) if lv.shape[-1] == 1 else np.argmax(lv, -1)
        return torch.from_numpy((idx == lv[..., None]).astype(np.float32))

    def update(self, correct, *args):
        c = _np(correct)
        accs = []
        num = c.shape[0] if c.ndim else 1
        for i, k in enumerate(self.topk):
            ck = c[..., :k].any(-1).sum()
            self.total[i] += float(ck)
            self.count[i] += num
            accs.append(float(ck) / max(num, 1))
        return accs[0] if len(accs) == 1 else accs

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / c if c else 0.0 for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


def _binary(preds, labels):
    """Predicted positives (``pred > 0.5``) and labels, flat."""
    return ((_np(preds) > 0.5).astype(np.int64).reshape(-1),
            _np(labels).reshape(-1))


class Precision(Metric):
    def __init__(self, name="precision"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p, lab = _binary(preds, labels)
        self.tp += int(((p == 1) & (lab == 1)).sum())
        self.fp += int(((p == 1) & (lab == 0)).sum())

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        return self.tp / (self.tp + self.fp) if (self.tp + self.fp) else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p, lab = _binary(preds, labels)
        self.tp += int(((p == 1) & (lab == 1)).sum())
        self.fn += int(((p == 0) & (lab == 1)).sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        return self.tp / (self.tp + self.fn) if (self.tp + self.fn) else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """ROC AUC from ``num_thresholds`` histogram bins of the positive
    score (the second column of a ``[N, 2]`` prediction)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        super().__init__()
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def update(self, preds, labels):
        p, lab = _np(preds), _np(labels).reshape(-1)
        if p.ndim == 2 and p.shape[1] == 2:
            p = p[:, 1]
        bins = np.minimum((p.reshape(-1) * self.num_thresholds)
                          .astype(np.int64), self.num_thresholds - 1)
        pos = lab.astype(bool)
        np.add.at(self._stat_pos, bins[pos], 1)
        np.add.at(self._stat_neg, bins[~pos], 1)

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds, np.int64)
        self._stat_neg = np.zeros(self.num_thresholds, np.int64)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if not tot_pos or not tot_neg:
            return 0.0
        # the TPR / FPR curve over the thresholds, from the highest down
        tpr = self._stat_pos[::-1].cumsum() / tot_pos
        fpr = self._stat_neg[::-1].cumsum() / tot_neg
        trapezoid = getattr(np, "trapezoid", None) or np.trapz
        return float(trapezoid(tpr, fpr))

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """Top-``k`` accuracy of one batch, an f32 scalar tensor on
    ``input``'s device."""
    m = Accuracy(topk=(k,))
    m.update(m.compute(input, label))
    dev = input.device if isinstance(input, torch.Tensor) else "cpu"
    return torch.tensor(m.accumulate(), dtype=torch.float32, device=dev)


__all__ = ["Accuracy", "Auc", "Metric", "Precision", "Recall", "accuracy"]
