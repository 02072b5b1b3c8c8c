"""Vision datasets of the port (counterpart of
``paddle_tpu/vision/datasets.py``): MNIST, FashionMNIST, Cifar10,
Cifar100 and Flowers as ``torch.utils.data.Dataset``s of numpy arrays.

Each reads local files when given (IDX files for MNIST, the python
pickle tarball for Cifar, the distribution's tarball and ``.mat`` files
for Flowers) and otherwise synthesizes the reference's
class-separable surrogate: the same numpy draws from the same seeds, so
its images and labels equal the reference's. Nothing is downloaded.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np
from torch.utils.data import Dataset

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100", "Flowers"]


def _synthetic_images(n, shape, num_classes, seed):
    """Deterministic separable images: class-dependent template + noise
    (the reference's ``_synthetic_images``, draw for draw)."""
    rng = np.random.RandomState(seed)
    templates = rng.uniform(0, 1, (num_classes,) + shape).astype(np.float32)
    labels = rng.randint(0, num_classes, n).astype(np.int64)
    noise = rng.normal(0, 0.35, (n,) + shape).astype(np.float32)
    images = np.clip(templates[labels] + noise, 0, 1) * 255
    return images.astype(np.uint8), labels


class MNIST(Dataset):
    """``paddle.vision.datasets.MNIST``: the IDX files at ``image_path`` and
    ``label_path`` when given, else 6000 (train) or 1000 (test) synthetic
    28x28 images of 10 classes. An item is ``(image [1, 28, 28] f32 in
    [0, 1], label int64)``, or ``transform`` of the f32 image in [0, 255]."""

    def __init__(self, image_path=None, label_path=None, mode="train", transform=None,
                 download=True, backend=None):
        self.mode = mode
        self.transform = transform
        if image_path and label_path and os.path.exists(image_path):
            self.images = self._read_idx_images(image_path)
            self.labels = self._read_idx_labels(label_path)
        else:
            n = 6000 if mode == "train" else 1000
            self.images, self.labels = _synthetic_images(
                n, (28, 28), 10, seed=42 if mode == "train" else 43)

    @staticmethod
    def _read_idx_images(path):
        op = gzip.open if path.endswith(".gz") else open
        with op(path, "rb") as f:
            _, n, rows, cols = struct.unpack(">IIII", f.read(16))
            return np.frombuffer(f.read(), np.uint8).reshape(n, rows, cols)

    @staticmethod
    def _read_idx_labels(path):
        op = gzip.open if path.endswith(".gz") else open
        with op(path, "rb") as f:
            struct.unpack(">II", f.read(8))
            return np.frombuffer(f.read(), np.uint8).astype(np.int64)

    def __getitem__(self, idx):
        img = self.images[idx].astype(np.float32)
        label = np.asarray(self.labels[idx], np.int64)
        img = self.transform(img) if self.transform is not None else img[None] / 255.0
        return img.astype(np.float32), label

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    pass


class Cifar10(Dataset):
    """``paddle.vision.datasets.Cifar10``: the batches of the
    cifar-10-python tarball at ``data_file`` when given (pickles: open only
    a copy of the published archive), else 5000 (train) or 1000 (test)
    synthetic 3x32x32 images. An item is ``(image [3, 32, 32] f32 in
    [0, 1], label int64)``, ``transform`` applied to the image."""

    _NUM_CLASSES = 10
    _TRAIN_RE = r"data_batch"
    _TEST_RE = r"test_batch"
    _LABEL_KEY = b"labels"

    def __init__(self, data_file=None, mode="train", transform=None, download=True,
                 backend=None):
        self.transform = transform
        if data_file and os.path.exists(data_file):
            self.images, self.labels = self._read_tar(data_file, mode)
        else:
            n = 5000 if mode == "train" else 1000
            self.images, self.labels = _synthetic_images(
                n, (3, 32, 32), self._NUM_CLASSES,
                seed=(7 if mode == "train" else 8) + self._NUM_CLASSES)

    @classmethod
    def _read_tar(cls, path, mode):
        import pickle
        import re
        import tarfile

        pat = re.compile(cls._TRAIN_RE if mode == "train" else cls._TEST_RE)
        images, labels = [], []
        with tarfile.open(path, "r:*") as tf:
            for member in sorted(tf.getmembers(), key=lambda m: m.name):
                if member.isfile() and pat.search(member.name):
                    batch = pickle.load(tf.extractfile(member), encoding="bytes")
                    images.append(np.asarray(batch[b"data"], np.uint8))
                    labels.extend(batch[cls._LABEL_KEY])
        if not images:
            raise ValueError(f"{path} contains no {'train' if mode == 'train' else 'test'} "
                             "batches: expected the cifar python pickle tarball")
        return np.concatenate(images).reshape(-1, 3, 32, 32), np.asarray(labels, np.int64)

    def __getitem__(self, idx):
        img = self.images[idx].astype(np.float32) / 255.0
        if self.transform is not None:
            img = self.transform(img)
        return img.astype(np.float32), np.asarray(self.labels[idx], np.int64)

    def __len__(self):
        return len(self.images)


class Cifar100(Cifar10):
    _NUM_CLASSES = 100
    _TRAIN_RE = r"(^|/)train$"
    _TEST_RE = r"(^|/)test$"
    _LABEL_KEY = b"fine_labels"


class Flowers(Dataset):
    """``paddle.vision.datasets.Flowers`` (Oxford 102 flowers): the
    images of ``data_file`` (102flowers.tgz, ``jpg/image_NNNNN.jpg``) with
    the labels of ``label_file`` (imagelabels.mat) and the split of
    ``setid_file`` (setid.mat) when all three are given, else 1000 (train)
    or 200 (test, valid) synthetic 3x64x64 uint8 images of 102 classes
    (seed 11). As in the reference, "train" reads the split the files call
    ``tstid`` and "test" the one they call ``trnid`` (the larger and the
    smaller). An item is ``(image, label [1] int64)``: the image as HWC
    uint8 (a PIL image with ``backend="pil"``) from the files, CHW from
    the surrogate, ``transform`` applied. scipy and PIL are imported only
    to read the files."""

    _MODE_FLAG = {"train": "tstid", "test": "trnid", "valid": "valid"}

    def __init__(self, data_file=None, label_file=None, setid_file=None, mode="train",
                 transform=None, download=True, backend=None):
        if mode not in self._MODE_FLAG:
            raise ValueError(f"mode must be train/test/valid, got {mode!r}")
        if backend not in (None, "pil", "cv2"):
            raise ValueError(f"backend must be pil or cv2, got {backend!r}")
        self.mode = mode
        self.transform = transform
        self.backend = backend or "cv2"
        self._tar = None
        if data_file and label_file and setid_file and os.path.exists(data_file):
            import tarfile

            import scipy.io as sio

            labels = sio.loadmat(label_file)["labels"].ravel()   # 1-based, by image id
            self._ids = sio.loadmat(setid_file)[self._MODE_FLAG[mode]].ravel().astype(np.int64)
            self.labels = labels[self._ids - 1].astype(np.int64) - 1
            self._tar = tarfile.open(data_file, "r")
            self._members = {m.name: m for m in self._tar.getmembers()
                             if m.name.endswith(".jpg")}
            self.images = None
        else:
            n = 1000 if mode == "train" else 200
            self.images, self.labels = _synthetic_images(n, (3, 64, 64), 102, seed=11)

    def _load_image(self, i):
        import io

        from PIL import Image

        member = self._members[f"jpg/image_{int(self._ids[i]):05d}.jpg"]
        img = Image.open(io.BytesIO(self._tar.extractfile(member).read())).convert("RGB")
        return img if self.backend == "pil" else np.asarray(img)

    def __getitem__(self, i):
        img = self._load_image(i) if self._tar is not None else self.images[i]
        label = np.array([self.labels[i]]).astype(np.int64)
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return len(self.labels)
