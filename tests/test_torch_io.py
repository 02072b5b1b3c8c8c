"""PyTorch port: ``io`` (datasets, samplers, the collate function, the
``DataLoader`` and its worker processes) and ``save`` / ``load`` against
the reference, on the CPU.

- Samplers and splits: the sequential, batch and distributed samplers
  give the reference's index lists; ``random_split`` with
  ``np.random.RandomState(seed)`` gives the reference's split at
  ``paddle.seed(seed)``; the shuffling samplers repeat under a seeded
  generator (the reference's draw from an unseeded numpy generator and
  cannot be compared).
- Collate: the reference's dtypes and shapes, recursively (MNIST labels
  int32, Python floats f32, Flowers labels ``[N, 1]`` int32, uint8 and
  bool kept).
- The loader: ``shuffle=False`` batches equal the reference's bit for
  bit, over a map-style and an iterable dataset; 0 and 2 workers give the
  same batches; a worker sees ``get_worker_info()``; an exception in a
  worker reaches the consumer; the card is the default device and is
  required.
- ``vision.datasets.Flowers``: the synthetic surrogate equal to the
  reference's, item by item, in every mode, with and without transforms.
- ``save`` / ``load``: a reference-written ``.pdparams`` loads into the
  port's LeNet and a port-written one into the reference's, every tensor
  bit for bit, the port's logits within 1e-5 of their largest of the
  reference's (two f32 convolutions sum in different orders); nested
  objects, ``return_numpy`` and bf16 round-trip.

Every other comparison here is exact: the loader moves bits, it computes
nothing.
"""

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.io as rio
from paddle_tpu import vision as rvision
from paddle_tpu.vision import transforms as RT
from paddle_tpu_torch import io as pio
from paddle_tpu_torch import load as pload
from paddle_tpu_torch import save as psave
from paddle_tpu_torch import vision as pvision
from paddle_tpu_torch.models import load_reference_state_dict
from paddle_tpu_torch.models._weights import reference_state_dict
from paddle_tpu_torch.vision import transforms as PT


class _Items:
    """A map-style dataset of (image [2, 3] f32, label int64, weight float)."""

    def __init__(self, n=11):
        rng = np.random.RandomState(0)
        self.x = rng.randn(n, 2, 3).astype(np.float32)
        self.y = rng.randint(0, 5, n).astype(np.int64)

    def __getitem__(self, i):
        return self.x[i], self.y[i], float(i) / 3

    def __len__(self):
        return len(self.x)


class _PortItems(_Items, pio.Dataset):
    pass


class _RefItems(_Items, rio.Dataset):
    pass


def _host(b):
    if isinstance(b, (list, tuple)):
        return [_host(v) for v in b]
    if isinstance(b, dict):
        return {k: _host(v) for k, v in b.items()}
    if torch.is_tensor(b):
        return b.numpy()
    return np.asarray(getattr(b, "_data", b))


def _assert_same(got, want):
    got, want = _host(got), _host(want)
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_same(got[k], want[k])
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("batch_size", [1, 4, 11])
def test_batch_samplers_give_the_references_indices(batch_size, drop_last):
    ds = list(range(11))
    got = pio.BatchSampler(ds, batch_size=batch_size, drop_last=drop_last)
    want = rio.BatchSampler(ds, batch_size=batch_size, drop_last=drop_last)
    assert list(got) == list(want) and len(got) == len(want)
    seq = pio.BatchSampler(sampler=pio.SequenceSampler(ds), batch_size=batch_size,
                           drop_last=drop_last)
    assert list(seq) == list(want)


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_distributed_batch_sampler_gives_the_references_shards(shuffle, drop_last):
    ds = list(range(23))
    for rank in range(3):
        got = pio.DistributedBatchSampler(ds, 4, num_replicas=3, rank=rank, shuffle=shuffle,
                                          drop_last=drop_last)
        want = rio.DistributedBatchSampler(ds, 4, num_replicas=3, rank=rank, shuffle=shuffle,
                                           drop_last=drop_last)
        for epoch in (0, 5):
            got.set_epoch(epoch)
            want.set_epoch(epoch)
            assert list(got) == list(want) and len(got) == len(want)
    assert list(pio.DistributedBatchSampler(ds, 4)) == list(pio.BatchSampler(ds, batch_size=4))


@pytest.mark.parametrize("lengths", [[5, 8, 10], [0.5, 0.25, 0.25]])
def test_random_split_equals_the_reference_at_its_seed(lengths):
    ds = list(range(23))
    paddle.seed(7)
    want = rio.random_split(ds, lengths)
    got = pio.random_split(ds, lengths, generator=np.random.RandomState(7))
    assert [s.indices for s in got] == [s.indices for s in want]
    assert sorted(i for s in got for i in s.indices) == ds
    # a torch generator repeats at its seed
    a, b = (pio.random_split(ds, lengths, generator=torch.Generator().manual_seed(3))
            for _ in range(2))
    assert [s.indices for s in a] == [s.indices for s in b]


def test_random_samplers_draw_from_their_generator():
    ds = list(range(50))
    for make in (lambda: torch.Generator().manual_seed(1), lambda: np.random.default_rng(1),
                 lambda: np.random.RandomState(1)):
        a = list(pio.RandomSampler(ds, generator=make()))
        assert a == list(pio.RandomSampler(ds, generator=make()))
        assert sorted(a) == ds and a != ds
    rep = list(pio.RandomSampler(ds, replacement=True, num_samples=80,
                                 generator=torch.Generator().manual_seed(2)))
    assert len(rep) == 80 and set(rep) <= set(ds)
    for gen in (np.random.default_rng(0), torch.Generator().manual_seed(0)):
        w = pio.WeightedRandomSampler([0, 1, 0, 3], 40, generator=gen)
        assert len(list(w)) == 40 and set(w) <= {1, 3}
    unseeded = pio.BatchSampler(ds, shuffle=True, batch_size=7)
    assert sorted(i for b in unseeded for i in b) == ds


def test_collate_gives_the_references_dtypes_and_shapes():
    mnist = [pvision.datasets.MNIST(mode="test")[i] for i in range(3)]
    flowers = [pvision.datasets.Flowers(mode="test")[i] for i in range(3)]
    nested = [{"a": (np.full(2, i, np.uint8), True), "b": [i, 2.5 * i]} for i in range(3)]
    scalars = [np.float64(1.5), np.int64(3), np.float32(2.0)]
    for batch in (mnist, flowers, nested, [_Items()[i] for i in range(4)]):
        _assert_same(pio.default_collate_fn(batch), rio.default_collate_fn(batch))
    for s in scalars:
        _assert_same(pio.default_collate_fn([s, s]), rio.default_collate_fn([s, s]))
    x, y = pio.default_collate_fn(mnist)
    assert x.dtype == torch.float32 and tuple(x.shape) == (3, 1, 28, 28)
    assert y.dtype == torch.int32 and tuple(y.shape) == (3,)
    assert pio.default_collate_fn(flowers)[1].dtype == torch.int32
    assert tuple(pio.default_collate_fn(flowers)[1].shape) == (3, 1)
    assert pio.default_collate_fn([torch.arange(2), torch.arange(2)]).dtype == torch.int32
    assert pio.default_collate_fn(["a", "b"]) == ["a", "b"]


def test_datasets_give_the_references_items():
    t = [np.arange(12).reshape(6, 2), np.arange(6) * 0.5]
    _assert_same(list(pio.TensorDataset(t)[2]), list(rio.TensorDataset(t)[2]))
    assert len(pio.TensorDataset(t)) == 6
    a, b = _Items(5), _Items(7)
    got, want = pio.ComposeDataset([a, b]), rio.ComposeDataset([a, b])
    assert len(got) == len(want) == 5
    np.testing.assert_array_equal(got[3][3], want[3][3])
    assert [*iter(pio.ChainDataset([[1, 2], [3]]))] == [*iter(rio.ChainDataset([[1, 2], [3]]))]
    sub = pio.Subset(a, [4, 0])
    assert len(sub) == 2 and sub[0][1] == a[4][1]
    with pytest.raises(RuntimeError):
        len(pio.IterableDataset())


def test_loader_batches_equal_the_references():
    tf = PT.Normalize(mean=[127.5], std=[127.5])
    got = pio.DataLoader(pvision.datasets.MNIST(mode="test", transform=tf), batch_size=64,
                         device="cpu")
    want = rio.DataLoader(rvision.datasets.MNIST(mode="test", transform=tf), batch_size=64)
    assert len(got) == len(want) == 16
    for g, w in zip(got, want, strict=True):
        _assert_same(g, w)
    items = _Items()
    for drop_last in (False, True):
        got = pio.DataLoader(_PortItems(), batch_size=4, drop_last=drop_last, device="cpu")
        want = rio.DataLoader(_RefItems(), batch_size=4, drop_last=drop_last)
        _assert_same(list(got), list(want))

    class Stream(pio.IterableDataset):
        def __iter__(self):
            return (items[i] for i in range(len(items)))

    class RefStream(rio.IterableDataset):
        def __iter__(self):
            return (items[i] for i in range(len(items)))

    _assert_same(list(pio.DataLoader(Stream(), batch_size=3, device="cpu")),
                 list(rio.DataLoader(RefStream(), batch_size=3)))
    with pytest.raises(TypeError):
        len(pio.DataLoader(Stream(), batch_size=3, device="cpu"))


def test_loader_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pio.DataLoader(_PortItems(), batch_size=2)


class _WhoLoads(pio.Dataset):
    """Item i: (i, the id of the worker that loaded it, or -1)."""

    def __getitem__(self, i):
        info = pio.get_worker_info()
        return np.int64(i), np.int64(-1 if info is None else info.id)

    def __len__(self):
        return 20


class _Fails(pio.Dataset):
    def __getitem__(self, i):
        if i == 13:
            raise ValueError(f"item {i} is unreadable")
        return np.float32(i)

    def __len__(self):
        return 20


def test_workers_keep_the_single_process_order():
    ds = pvision.datasets.MNIST(mode="test", transform=PT.Normalize(127.5, 127.5))
    sampler = pio.BatchSampler(ds, shuffle=True, batch_size=50, drop_last=True,
                               generator=torch.Generator().manual_seed(0))
    fixed = list(sampler)

    class Fixed:
        batch_size = 50

        def __iter__(self):
            return iter(fixed)

        def __len__(self):
            return len(fixed)

    one = list(pio.DataLoader(ds, batch_sampler=Fixed(), device="cpu"))
    two = list(pio.DataLoader(ds, batch_sampler=Fixed(), num_workers=2, device="cpu"))
    _assert_same(two, one)
    assert pio.get_worker_info() is None
    ids, who = zip(*pio.DataLoader(_WhoLoads(), batch_size=3, num_workers=2, device="cpu"))
    assert torch.cat(ids).tolist() == list(range(20))
    # batch i comes from worker i % 2
    assert [w.unique().tolist() for w in who] == [[i % 2] for i in range(7)]


def test_a_workers_exception_reaches_the_consumer():
    for workers in (0, 2):
        loader = pio.DataLoader(_Fails(), batch_size=4, num_workers=workers, device="cpu")
        seen = []
        with pytest.raises(ValueError, match="item 13 is unreadable"):
            for x in loader:
                seen.append(x)
        assert len(seen) == 3


def test_reference_pdparams_load_into_the_port_and_back(tmp_path):
    paddle.seed(3)
    ref = rvision.LeNet()
    x = np.random.RandomState(0).rand(2, 1, 28, 28).astype(np.float32)
    paddle.save(ref.state_dict(), str(tmp_path / "ref.pdparams"))
    state = pload(str(tmp_path / "ref.pdparams"))
    assert all(v.dtype == torch.float32 and v.device.type == "cpu" for v in state.values())
    port = pvision.LeNet(device="cpu", generator=torch.Generator().manual_seed(9))
    load_reference_state_dict(port, state)
    for k, v in ref.state_dict().items():
        np.testing.assert_array_equal(reference_state_dict(port)[k].detach().numpy(),
                                      np.asarray(v._data))
    want = np.asarray(ref(paddle.to_tensor(x))._data)
    got = port(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())

    port2 = pvision.LeNet(device="cpu", generator=torch.Generator().manual_seed(4))
    psave(reference_state_dict(port2), str(tmp_path / "sub" / "port.pdparams"))
    back = rvision.LeNet()
    missing, unexpected = back.set_state_dict(paddle.load(str(tmp_path / "sub" /
                                                                "port.pdparams")))
    assert missing == [] and unexpected == []
    for k, v in back.state_dict().items():
        np.testing.assert_array_equal(np.asarray(v._data),
                                      reference_state_dict(port2)[k].detach().numpy())


def test_save_and_load_keep_nested_objects(tmp_path):
    obj = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3), "step": 4,
           "lists": [torch.ones(2, dtype=torch.int64), ("a", 1.5)],
           "half": torch.tensor([1.5, -2.25], dtype=torch.bfloat16)}
    psave(obj, str(tmp_path / "o.pdopt"))
    got = pload(str(tmp_path / "o.pdopt"))
    assert got["step"] == 4 and got["lists"][1] == ("a", 1.5)
    assert torch.equal(got["w"], obj["w"]) and torch.equal(got["lists"][0], obj["lists"][0])
    assert got["half"].dtype == torch.bfloat16 and torch.equal(got["half"], obj["half"])
    as_np = pload(str(tmp_path / "o.pdopt"), return_numpy=True)
    assert isinstance(as_np["w"], np.ndarray)
    # the reference reads the same file, bf16 as its own bf16 arrays
    ref = paddle.load(str(tmp_path / "o.pdopt"))
    np.testing.assert_array_equal(np.asarray(ref["w"]._data), obj["w"].numpy())
    assert ref["half"]._data.dtype == jax.numpy.bfloat16
    np.testing.assert_array_equal(np.asarray(ref["half"]._data, np.float32), [1.5, -2.25])
    paddle.save({"h": paddle.to_tensor(np.array([0.5, 3.0], np.float32)).astype("bfloat16")},
                str(tmp_path / "r.pdparams"))
    back = pload(str(tmp_path / "r.pdparams"))["h"]
    assert back.dtype == torch.bfloat16 and back.tolist() == [0.5, 3.0]


@pytest.mark.parametrize("mode", ["train", "test", "valid"])
def test_flowers_equals_the_reference(mode):
    tf_port = PT.Compose([PT.ToTensor(), PT.Resize(32)])
    tf_ref = RT.Compose([RT.ToTensor(), RT.Resize(32)])
    got = pvision.datasets.Flowers(mode=mode)
    want = rvision.datasets.Flowers(mode=mode)
    assert len(got) == len(want) == (1000 if mode == "train" else 200)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    for i in (0, 7, len(got) - 1):
        _assert_same(list(got[i]), list(want[i]))
    with_tf = pvision.datasets.Flowers(mode=mode, transform=tf_port)
    ref_tf = rvision.datasets.Flowers(mode=mode, transform=tf_ref)
    _assert_same(list(with_tf[3]), list(ref_tf[3]))
    with pytest.raises(ValueError):
        pvision.datasets.Flowers(mode="other")
