"""Vision transforms and datasets of the PyTorch port
(``paddle_tpu_torch/vision/transforms``, ``vision/datasets``) against the
reference's ``paddle_tpu.vision`` on the CPU: each transform and
functional on HWC float and uint8 images made with numpy from a seed (the
random ones under one ``random.seed`` on both sides), ``Compose`` of the
ImageNet training and evaluation pipelines, ``FakeData`` items,
``DatasetFolder`` / ``ImageFolder`` over a temporary tree of ``.npy``
images, and shuffled ``DataLoader`` batches of transformed ``FakeData``
under one ``random`` / numpy seed.

Tolerance: equal arrays (the same numpy arithmetic on both sides).
"""
import random

import numpy as np
import pytest
import torch

from paddle_tpu import io as rio
from paddle_tpu.framework.core import Tensor
from paddle_tpu.framework.op import raw
from paddle_tpu.vision import datasets as rds
from paddle_tpu.vision import transforms as rT
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.vision import datasets as tds
from paddle_tpu_torch.vision import transforms as tT

MEAN, STD = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, Tensor):
        return np.asarray(raw(x))
    return np.asarray(x)


def _img(kind, shape=(37, 50, 3), seed=0):
    rng = np.random.default_rng(seed)
    if kind == "uint8":
        return rng.integers(0, 256, shape).astype(np.uint8)
    return rng.random(shape).astype(np.float32)


# name -> constructor taking the transforms module
TRANSFORMS = {
    "Resize-int": lambda T: T.Resize(24),
    "Resize-int-tall": lambda T: T.Resize(20),
    "Resize-hw": lambda T: T.Resize((19, 31)),
    "Resize-nearest": lambda T: T.Resize((30, 17), "nearest"),
    "CenterCrop": lambda T: T.CenterCrop(21),
    "CenterCrop-hw": lambda T: T.CenterCrop((30, 12)),
    "RandomResizedCrop": lambda T: T.RandomResizedCrop(24),
    "RandomResizedCrop-narrow": lambda T: T.RandomResizedCrop(
        (16, 20), scale=(0.9, 1.0), ratio=(3.0, 4.0)),
    "RandomHorizontalFlip": lambda T: T.RandomHorizontalFlip(),
    "Transpose": lambda T: T.Transpose(),
    "ToTensor": lambda T: T.ToTensor(),
    "ToTensor-hwc": lambda T: T.ToTensor("HWC"),
    "Normalize-hwc": lambda T: T.Normalize(MEAN, STD, data_format="HWC"),
    "train": lambda T: T.Compose([T.RandomResizedCrop(24),
                                  T.RandomHorizontalFlip(), T.ToTensor(),
                                  T.Normalize(MEAN, STD)]),
    "eval": lambda T: T.Compose([T.Resize(28), T.CenterCrop(24),
                                 T.ToTensor(), T.Normalize(MEAN, STD)]),
}


@pytest.mark.parametrize("kind", ["float32", "uint8"])
@pytest.mark.parametrize("name", TRANSFORMS)
def test_transform_matches_reference(name, kind):
    ref, port = TRANSFORMS[name](rT), TRANSFORMS[name](tT)
    for i in range(4):  # several draws from the same seeded stream
        img = _img(kind, seed=i)
        random.seed(10 + i)
        want = ref(img)
        random.seed(10 + i)
        got = port(img)
        assert isinstance(got, torch.Tensor) == isinstance(want, Tensor)
        g, w = _np(got), _np(want)
        assert g.dtype == w.dtype and g.shape == w.shape, (g.shape, w.shape)
        np.testing.assert_array_equal(g, w)


def test_normalize_keeps_tensors_tensors():
    chw = _img("float32", (3, 5, 4))
    got = tT.Normalize(MEAN, STD)(torch.from_numpy(chw))
    want = rT.Normalize(MEAN, STD)(Tensor(chw))
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    np.testing.assert_array_equal(tT.Normalize(MEAN, STD)(chw), _np(want))


FUNCTIONALS = {
    "to_tensor": (lambda T, a: T.to_tensor(a), "uint8"),
    "normalize": (lambda T, a: T.normalize(a, MEAN, STD, "HWC"), "float32"),
    "resize": (lambda T, a: T.resize(a, (20, 33)), "uint8"),
    "center_crop": (lambda T, a: T.center_crop(a, 16), "float32"),
    "crop": (lambda T, a: T.crop(a, 3, 5, 10, 12), "uint8"),
    "hflip": (lambda T, a: T.hflip(a), "float32"),
}


@pytest.mark.parametrize("name", FUNCTIONALS)
def test_functional_matches_reference(name):
    fn, kind = FUNCTIONALS[name]
    img = _img(kind)
    np.testing.assert_array_equal(_np(fn(tT, img)), _np(fn(rT, img)))


def test_fake_data_matches_reference():
    args = (6, (12, 10, 3), 7)
    ref = rds.FakeData(*args)
    port = tds.FakeData(*args)
    assert len(port) == len(ref) == 6
    for i in range(6):
        (gi, gl), (wi, wl) = port[i], ref[i]
        np.testing.assert_array_equal(gi, wi)
        assert gl.dtype == np.int64 and gl == wl
    random.seed(1)
    want = rds.FakeData(*args, transform=TRANSFORMS["train"](rT))[3][0]
    random.seed(1)
    got = tds.FakeData(*args, transform=TRANSFORMS["train"](tT))[3][0]
    np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.fixture
def image_tree(tmp_path):
    """``root/<class>/[sub/]<name>.npy`` images and one file of another
    extension that the datasets skip."""
    rng = np.random.default_rng(4)
    for c, names in (("cat", ["b", "a", "sub/c"]), ("dog", ["x"]),
                     ("emu", ["y", "z"])):
        for n in names:
            path = tmp_path / c / f"{n}.npy"
            path.parent.mkdir(parents=True, exist_ok=True)
            np.save(path, rng.integers(0, 256, (9, 11, 3)).astype(np.uint8))
    (tmp_path / "dog" / "notes.txt").write_text("not an image")
    return tmp_path


def test_dataset_folder_matches_reference(image_tree):
    tf = lambda T: T.Compose([T.Resize(8), T.ToTensor()])  # noqa: E731
    ref = rds.DatasetFolder(str(image_tree), transform=tf(rT))
    port = tds.DatasetFolder(str(image_tree), transform=tf(tT))
    assert port.classes == ref.classes == ["cat", "dog", "emu"]
    assert port.class_to_idx == ref.class_to_idx
    assert port.samples == ref.samples and len(port) == 6
    for i in range(len(port)):
        (gi, gl), (wi, wl) = port[i], ref[i]
        np.testing.assert_array_equal(gi.numpy(), _np(wi))
        assert gl == wl


def test_image_folder_matches_reference(image_tree):
    ref = rds.ImageFolder(str(image_tree))
    port = tds.ImageFolder(str(image_tree))
    assert port.samples == ref.samples and len(port) == 6
    for i in range(len(port)):
        (g,), (w,) = port[i], ref[i]
        np.testing.assert_array_equal(g, w)


def test_loader_batches_of_transformed_images_match_reference():
    """Shuffled batches of ``FakeData`` through the ImageNet training
    pipeline: the sampler on numpy's RNG, the crops and flips on Python's
    ``random``, in one process."""
    def run(ds, T, io, **kw):
        data = ds.FakeData(10, (30, 34, 3), 5, TRANSFORMS["train"](T))
        random.seed(2)
        np.random.seed(2)
        return [[_np(f) for f in b] for b in io.DataLoader(
            data, batch_size=4, shuffle=True, **kw)]

    want = run(rds, rT, rio)
    got = run(tds, tT, tio, device="cpu")
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g[0].shape[1:] == (3, 24, 24)
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1].reshape(-1), w[1].reshape(-1))


def test_loader_worker_processes_carry_the_transforms():
    """Two worker processes return the same images as one process for a
    deterministic pipeline (the crops' draws happen in the workers)."""
    data = tds.FakeData(8, (30, 34, 3), 5, TRANSFORMS["eval"](tT))
    one = [b[0].numpy() for b in tio.DataLoader(data, batch_size=4,
                                                device="cpu")]
    two = [b[0].numpy() for b in tio.DataLoader(data, batch_size=4,
                                                num_workers=2, device="cpu")]
    for a, b in zip(one, two):
        np.testing.assert_array_equal(a, b)
