"""Vision datasets (counterpart of ``paddle_tpu/vision/datasets/``):
``FakeData`` (synthetic images, deterministic per index) and the folder
datasets ``DatasetFolder`` / ``ImageFolder`` over local files (``.npy``
through numpy, other image files through PIL where it is installed).
``MNIST``, ``Cifar10/100``, ``Flowers`` and ``VOC2012`` wait (ROADMAP.md
§A.6): they read archives no machine here holds."""
from __future__ import annotations

import os

import numpy as np

from ...io import Dataset

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".npy")


class FakeData(Dataset):
    """``size`` images of ``image_shape``, uniform in [0, 1) as f32, and a
    label in ``[0, num_classes)``, both drawn from
    ``np.random.RandomState(idx)``."""

    def __init__(self, size=1000, image_shape=(3, 224, 224),
                 num_classes=1000, transform=None):
        self.size = size
        self.image_shape = tuple(image_shape)
        self.num_classes = num_classes
        self.transform = transform

    def __getitem__(self, idx):
        rng = np.random.RandomState(idx)
        img = rng.rand(*self.image_shape).astype(np.float32)
        label = rng.randint(0, self.num_classes)
        if self.transform:
            img = self.transform(img)
        return img, np.asarray(label, np.int64)

    def __len__(self):
        return self.size


def _default_loader(path):
    if path.endswith(".npy"):
        return np.load(path)
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError("PIL unavailable; use .npy images") from e
    with open(path, "rb") as f:
        return np.asarray(Image.open(f).convert("RGB"))


def _files(root, extensions):
    """The image files under ``root``, walked in sorted order."""
    out = []
    for dirpath, _, files in sorted(os.walk(root)):
        for fn in sorted(files):
            if fn.lower().endswith(tuple(extensions)):
                out.append(os.path.join(dirpath, fn))
    return out


class DatasetFolder(Dataset):
    """``root/<class>/.../<image>``: samples ``(image, class index)``, the
    classes the sorted subdirectories of ``root``."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        self.loader = loader or _default_loader
        extensions = extensions or IMG_EXTENSIONS
        self.classes = sorted(d for d in os.listdir(root)
                              if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.samples = [(path, self.class_to_idx[c]) for c in self.classes
                        for path in _files(os.path.join(root, c),
                                           extensions)]

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        img = self.loader(path)
        if self.transform:
            img = self.transform(img)
        return img, np.asarray(target, np.int64)

    def __len__(self):
        return len(self.samples)


class ImageFolder(Dataset):
    """Every image under ``root``, unlabelled: samples ``[image]``."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        self.loader = loader or _default_loader
        self.samples = _files(root, extensions or IMG_EXTENSIONS)

    def __getitem__(self, idx):
        img = self.loader(self.samples[idx])
        if self.transform:
            img = self.transform(img)
        return [img]

    def __len__(self):
        return len(self.samples)


__all__ = ["DatasetFolder", "FakeData", "IMG_EXTENSIONS", "ImageFolder"]
