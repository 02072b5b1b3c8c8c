"""Vision transforms of the port (counterpart of
``paddle_tpu/vision/transforms.py``): numpy on the host, in the loader's
workers or thread, with the reference's behaviour:

- ``ToTensor`` divides by 255 only when the largest value exceeds 1.5,
  and moves a last axis of 1, 3 or 4 channels first (CHW);
- ``Resize`` picks the nearest source index (``floor(i * in / out)``)
  whatever ``interpolation`` says;
- ``RandomCrop`` takes and ignores its padding arguments;
- an image is CHW when it has 3 axes and the first is 1, 3 or 4.

The random transforms draw from numpy's global generator, as the
reference's do, or from the ``np.random.RandomState`` given as ``rng``.
"""

from __future__ import annotations

import numbers

import numpy as np

__all__ = ["Compose", "BaseTransform", "ToTensor", "Normalize", "Resize", "CenterCrop",
           "RandomCrop", "RandomHorizontalFlip", "RandomVerticalFlip", "Transpose",
           "to_tensor", "normalize", "resize"]


def _pair(size):
    return (size, size) if isinstance(size, numbers.Number) else tuple(size)


def _is_chw(a) -> bool:
    return a.ndim == 3 and a.shape[0] in (1, 3, 4)


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class BaseTransform:
    def __call__(self, img):
        raise NotImplementedError


class ToTensor(BaseTransform):
    """The image as f32 (in [0, 1] when its largest value exceeds 1.5),
    a 2-D image given a channel axis, HWC moved to CHW."""

    def __init__(self, data_format="CHW", keys=None):
        self.data_format = data_format

    def __call__(self, img):
        a = np.asarray(img, np.float32)
        if a.max() > 1.5:
            a = a / 255.0
        if a.ndim == 2:
            a = a[None] if self.data_format == "CHW" else a[..., None]
        elif a.ndim == 3 and self.data_format == "CHW" and a.shape[-1] in (1, 3, 4):
            a = np.transpose(a, (2, 0, 1))
        return a


class Normalize(BaseTransform):
    """``(img - mean) / std`` in f32, per channel (axis 0 for CHW)."""

    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False, keys=None):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.data_format = data_format

    def __call__(self, img):
        a = np.asarray(img, np.float32)
        if self.data_format == "CHW":
            m = self.mean.reshape(-1, 1, 1) if self.mean.ndim else self.mean
            s = self.std.reshape(-1, 1, 1) if self.std.ndim else self.std
        else:
            m, s = self.mean, self.std
        return (a - m) / s


class Resize(BaseTransform):
    """Nearest-index resize to ``size`` (an int: a square), f32."""

    def __init__(self, size, interpolation="bilinear", keys=None):
        self.size = _pair(size)

    def __call__(self, img):
        a = np.asarray(img, np.float32)
        chw = _is_chw(a)
        if chw:
            a = np.transpose(a, (1, 2, 0))
        h, w = a.shape[:2]
        th, tw = self.size
        yi = (np.arange(th) * (h / th)).astype(np.int64).clip(0, h - 1)
        xi = (np.arange(tw) * (w / tw)).astype(np.int64).clip(0, w - 1)
        out = a[yi][:, xi]
        return np.transpose(out, (2, 0, 1)) if chw else out


def _crop(a, i, j, th, tw):
    return a[:, i:i + th, j:j + tw] if _is_chw(a) else a[i:i + th, j:j + tw]


def _hw(a):
    return (a.shape[1], a.shape[2]) if _is_chw(a) else (a.shape[0], a.shape[1])


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        self.size = _pair(size)

    def __call__(self, img):
        a = np.asarray(img)
        h, w = _hw(a)
        th, tw = self.size
        return _crop(a, max((h - th) // 2, 0), max((w - tw) // 2, 0), th, tw)


class RandomCrop(BaseTransform):
    """A crop of ``size`` at a random corner (``padding``,
    ``pad_if_needed``, ``fill`` and ``padding_mode`` are ignored)."""

    def __init__(self, size, padding=None, pad_if_needed=False, fill=0,
                 padding_mode="constant", keys=None, *, rng=None):
        self.size = _pair(size)
        self.rng = rng

    def __call__(self, img):
        a = np.asarray(img)
        h, w = _hw(a)
        th, tw = self.size
        rng = np.random if self.rng is None else self.rng
        i = rng.randint(0, max(h - th, 0) + 1)
        j = rng.randint(0, max(w - tw, 0) + 1)
        return _crop(a, i, j, th, tw)


class RandomHorizontalFlip(BaseTransform):
    """The last axis reversed with probability ``prob``."""

    def __init__(self, prob=0.5, keys=None, *, rng=None):
        self.prob = prob
        self.rng = rng

    def __call__(self, img):
        a = np.asarray(img)
        if (np.random if self.rng is None else self.rng).rand() < self.prob:
            return a[..., ::-1].copy()
        return a


class RandomVerticalFlip(BaseTransform):
    """The rows reversed with probability ``prob``."""

    def __init__(self, prob=0.5, keys=None, *, rng=None):
        self.prob = prob
        self.rng = rng

    def __call__(self, img):
        a = np.asarray(img)
        if (np.random if self.rng is None else self.rng).rand() < self.prob:
            return (a[:, ::-1] if _is_chw(a) else a[::-1]).copy()
        return a


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        self.order = order

    def __call__(self, img):
        return np.transpose(np.asarray(img), self.order)


def to_tensor(img, data_format="CHW"):
    return ToTensor(data_format)(img)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    return Normalize(mean, std, data_format)(img)


def resize(img, size, interpolation="bilinear"):
    return Resize(size, interpolation)(img)
