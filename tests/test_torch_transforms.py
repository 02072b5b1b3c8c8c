"""PyTorch port: ``vision.transforms`` against the reference, on the CPU.

Every class and functional runs on the same numpy images on both sides:
HWC and CHW, 1, 3 and 4 channels, uint8 in [0, 255] and f32 in [0, 1]
(``ToTensor`` divides only past 1.5), gray 2-D images, upscaling and
downscaling ``Resize`` (nearest index whatever ``interpolation`` says),
crops larger and smaller than the image. The random transforms run with
``np.random`` seeded the same before each side, and with an explicit
``np.random.RandomState`` on the port's side. The outputs are compared
bit for bit, dtype and shape included: both sides run the same numpy
operations.
"""

import numpy as np
import pytest

from paddle_tpu.vision import transforms as RT
from paddle_tpu_torch.vision import transforms as PT

_RNG = np.random.RandomState(0)
IMAGES = {
    "hwc3_uint8": _RNG.randint(0, 256, (20, 14, 3)).astype(np.uint8),
    "chw3_f32": _RNG.rand(3, 20, 14).astype(np.float32),
    "chw1_uint8": _RNG.randint(0, 256, (1, 9, 12)).astype(np.uint8),
    "hwc4_f32": (_RNG.rand(9, 12, 4) * 255).astype(np.float32),
    "gray_uint8": _RNG.randint(0, 256, (28, 28)).astype(np.uint8),
}


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


DETERMINISTIC = [
    ("ToTensor", lambda T: T.ToTensor()),
    ("ToTensor_HWC", lambda T: T.ToTensor(data_format="HWC")),
    ("Normalize", lambda T: T.Normalize(mean=127.5, std=127.5)),
    ("Normalize_HWC", lambda T: T.Normalize([0.5, 0.4, 0.3], [0.2, 0.3, 0.4],
                                            data_format="HWC")),
    ("Resize_up", lambda T: T.Resize(33)),
    ("Resize_down", lambda T: T.Resize((7, 5), interpolation="nearest")),
    ("CenterCrop", lambda T: T.CenterCrop(8)),
    ("CenterCrop_large", lambda T: T.CenterCrop((30, 6))),
    ("Transpose", lambda T: T.Transpose()),
    ("Compose", lambda T: T.Compose([T.ToTensor(), T.Resize(16), T.Normalize(0.5, 0.25)])),
]


@pytest.mark.parametrize("name,make", DETERMINISTIC, ids=[d[0] for d in DETERMINISTIC])
def test_transforms_equal_the_references(name, make):
    for key, img in IMAGES.items():
        if name in ("Normalize_HWC",) and img.shape[-1] != 3:
            continue
        if name == "Transpose" and img.ndim != 3:
            continue
        _same(make(PT)(img), make(RT)(img))


def test_functionals_equal_the_references():
    for img in IMAGES.values():
        _same(PT.to_tensor(img), RT.to_tensor(img))
        _same(PT.resize(img, (11, 6), "bicubic"), RT.resize(img, (11, 6), "bicubic"))
    img = IMAGES["chw3_f32"]
    _same(PT.normalize(img, [0.1, 0.2, 0.3], [0.5, 0.5, 2.0]),
          RT.normalize(img, [0.1, 0.2, 0.3], [0.5, 0.5, 2.0]))


RANDOM = [
    ("RandomCrop", lambda T, **kw: T.RandomCrop(8, padding=4, **kw)),
    ("RandomCrop_large", lambda T, **kw: T.RandomCrop((30, 30), **kw)),
    ("RandomHorizontalFlip", lambda T, **kw: T.RandomHorizontalFlip(**kw)),
    ("RandomVerticalFlip", lambda T, **kw: T.RandomVerticalFlip(prob=0.7, **kw)),
]


@pytest.mark.parametrize("name,make", RANDOM, ids=[r[0] for r in RANDOM])
def test_random_transforms_draw_as_the_references(name, make):
    got, want = [], []
    np.random.seed(5)
    port = make(PT)
    for img in list(IMAGES.values()) * 4:
        got.append(port(img))
    np.random.seed(5)
    ref = make(RT)
    for img in list(IMAGES.values()) * 4:
        want.append(ref(img))
    for g, w in zip(got, want):
        _same(g, w)
    explicit = make(PT, rng=np.random.RandomState(5))
    for img, w in zip(list(IMAGES.values()) * 4, want):
        _same(explicit(img), w)
    if "Flip" in name:       # both outcomes were drawn
        flipped = [not np.array_equal(np.asarray(g), img)
                   for g, img in zip(got, list(IMAGES.values()) * 4)]
        assert any(flipped) and not all(flipped)
