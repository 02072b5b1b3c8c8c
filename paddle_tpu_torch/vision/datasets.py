"""Vision datasets of the port (counterpart of
``paddle_tpu/vision/datasets.py``): MNIST, FashionMNIST, Cifar10 and
Cifar100 as ``torch.utils.data.Dataset``s of numpy arrays.

Each reads local files when given (IDX files for MNIST, the python
pickle tarball for Cifar) and otherwise synthesizes the reference's
class-separable surrogate: the same numpy draws from the same seeds, so
its images and labels equal the reference's. Nothing is downloaded.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np
from torch.utils.data import Dataset

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100"]


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
