"""Image transforms (counterpart of
``paddle_tpu/vision/transforms/__init__.py``): host numpy, run in the
``DataLoader``'s workers, with the reference's arithmetic and its draws
from Python's global ``random`` (so under one ``random.seed`` both
packages crop and flip alike). Images are HWC arrays (or tensors) until
``ToTensor``, which gives a CHW f32 host tensor.

Ported: ``Compose``, ``ToTensor``, ``Normalize``, ``Resize``,
``CenterCrop``, ``RandomResizedCrop``, ``RandomHorizontalFlip``,
``Transpose`` and the functionals ``to_tensor``, ``normalize``,
``resize``, ``center_crop``, ``crop``, ``hflip``. The other transforms
wait (ROADMAP.md §A.6)."""
from __future__ import annotations

import numbers
import random as _pyrandom

import numpy as np
import torch


def _to_np(img):
    if isinstance(img, torch.Tensor):
        return img.detach().cpu().numpy()
    return np.asarray(img)


class BaseTransform:
    def __init__(self, keys=None):
        self.keys = keys

    def __call__(self, inputs):
        return self._apply_image(inputs)

    def _apply_image(self, img):
        raise NotImplementedError


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class ToTensor(BaseTransform):
    """HWC (uint8 in [0, 255] scaled to [0, 1]; other dtypes as f32) to a
    CHW f32 host tensor (HWC with ``data_format="HWC"``)."""

    def __init__(self, data_format="CHW", keys=None):
        super().__init__(keys)
        self.data_format = data_format

    def _apply_image(self, img):
        a = _to_np(img)
        if a.ndim == 2:
            a = a[:, :, None]
        if a.dtype == np.uint8:
            a = a.astype(np.float32) / 255.0
        else:
            a = a.astype(np.float32)
        if self.data_format == "CHW":
            a = np.transpose(a, (2, 0, 1))
        return torch.from_numpy(np.ascontiguousarray(a))


class Normalize(BaseTransform):
    """``(img - mean) / std`` per channel; a tensor in gives a tensor."""

    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False,
                 keys=None):
        super().__init__(keys)
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.data_format = data_format

    def _apply_image(self, img):
        a = _to_np(img).astype(np.float32)
        shape = (-1, 1, 1) if self.data_format == "CHW" else (1, 1, -1)
        out = (a - self.mean.reshape(shape)) / self.std.reshape(shape)
        return torch.from_numpy(out) if isinstance(img, torch.Tensor) \
            else out


class Resize(BaseTransform):
    """To ``size`` (``(h, w)``, or the short side for an int, the long
    side scaled and truncated), bilinear or nearest, sampling at pixel
    centres; uint8 stays uint8."""

    def __init__(self, size, interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = size
        self.interpolation = interpolation

    def _apply_image(self, img):
        a = _to_np(img)  # HWC
        h, w = a.shape[:2]
        if isinstance(self.size, int):
            if h < w:
                nh, nw = self.size, int(w * self.size / h)
            else:
                nh, nw = int(h * self.size / w), self.size
        else:
            nh, nw = self.size
        ys = (np.arange(nh) + 0.5) * h / nh - 0.5
        xs = (np.arange(nw) + 0.5) * w / nw - 0.5
        ys = np.clip(ys, 0, h - 1)
        xs = np.clip(xs, 0, w - 1)
        if self.interpolation == "nearest":
            return a[np.round(ys).astype(int)[:, None],
                     np.round(xs).astype(int)[None, :]]
        y0 = np.floor(ys).astype(int)
        x0 = np.floor(xs).astype(int)
        y1 = np.minimum(y0 + 1, h - 1)
        x1 = np.minimum(x0 + 1, w - 1)
        wy = (ys - y0)[:, None, None] if a.ndim == 3 else (ys - y0)[:, None]
        wx = (xs - x0)[None, :, None] if a.ndim == 3 else (xs - x0)[None, :]
        f = a.astype(np.float32)
        out = (f[y0[:, None], x0[None, :]] * (1 - wy) * (1 - wx)
               + f[y1[:, None], x0[None, :]] * wy * (1 - wx)
               + f[y0[:, None], x1[None, :]] * (1 - wy) * wx
               + f[y1[:, None], x1[None, :]] * wy * wx)
        if a.dtype == np.uint8:
            out = np.clip(out, 0, 255).astype(np.uint8)
        return out


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, numbers.Number) \
            else tuple(size)

    def _apply_image(self, img):
        a = _to_np(img)
        h, w = a.shape[:2]
        th, tw = self.size
        i = max(0, (h - th) // 2)
        j = max(0, (w - tw) // 2)
        return a[i:i + th, j:j + tw]


class RandomResizedCrop(BaseTransform):
    """A crop of a random area share in ``scale`` and aspect ratio in
    ``ratio`` (log-uniform), resized to ``size``; after 10 failed draws,
    the central square."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3.0 / 4, 4.0 / 3),
                 interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, numbers.Number) \
            else tuple(size)
        self.scale = scale
        self.ratio = ratio
        self._resize = Resize(self.size, interpolation)

    def _apply_image(self, img):
        a = _to_np(img)
        h, w = a.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = area * _pyrandom.uniform(*self.scale)
            ar = np.exp(_pyrandom.uniform(np.log(self.ratio[0]),
                                          np.log(self.ratio[1])))
            tw = int(round(np.sqrt(target_area * ar)))
            th = int(round(np.sqrt(target_area / ar)))
            if 0 < tw <= w and 0 < th <= h:
                i = _pyrandom.randint(0, h - th)
                j = _pyrandom.randint(0, w - tw)
                return self._resize(a[i:i + th, j:j + tw])
        return self._resize(CenterCrop(min(h, w))(a))


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        a = _to_np(img)
        if _pyrandom.random() < self.prob:
            return a[:, ::-1].copy()
        return a


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        super().__init__(keys)
        self.order = order

    def _apply_image(self, img):
        a = _to_np(img)
        if a.ndim == 2:
            a = a[..., None]
        return np.transpose(a, self.order)


def to_tensor(img, data_format="CHW"):
    return ToTensor(data_format)(img)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    return Normalize(mean, std, data_format)(img)


def resize(img, size, interpolation="bilinear"):
    return Resize(size, interpolation)(img)


def hflip(img):
    return _to_np(img)[:, ::-1].copy()


def center_crop(img, output_size):
    return CenterCrop(output_size)(img)


def crop(img, top, left, height, width):
    return _to_np(img)[top:top + height, left:left + width]


__all__ = ["BaseTransform", "CenterCrop", "Compose", "Normalize",
           "RandomHorizontalFlip", "RandomResizedCrop", "Resize", "ToTensor",
           "Transpose", "center_crop", "crop", "hflip", "normalize",
           "resize", "to_tensor"]
