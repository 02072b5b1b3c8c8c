"""PyTorch port: the top level against the reference on the CPU.

``to_tensor``'s dtypes (the reference's: float64 data to the default dtype,
64-bit integers to 32 bits) and ``stop_gradient``; ``seed`` and the
generators' states (the port's own generators: the same seed gives the
same draws and a saved state replays; the bits are torch's, not the
reference's); the grad modes; ``grad`` with ``create_graph``,
``allow_unused`` and ``no_grad_vars`` against the reference's where it has
them; ``PyLayer`` against the reference's ``PyLayer`` (one user class per
package, the same body); ``finfo`` / ``iinfo`` exactly; the places; and
the default device: the card (``"gpu:0"``) unless ``set_device`` says
otherwise, with no fall back to the CPU when there is no card. Every test
runs with the CPU as the default device and restores the port's global
state (``torch_op_parity.port_globals``).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as port
from paddle_tpu_torch import device as pdevice
from torch_op_parity import port_globals  # noqa: F401


@pytest.mark.parametrize("data, dtype", [
    ([1, 2, 3], None), ([1.0, 2.5], None), (np.arange(4, dtype=np.float64), None),
    (np.arange(4, dtype=np.int64), None), ([True, False], None), (3, None), (2.5, None),
    ([1, 2], "float32"), ([1.5], "int64"), ([1, 2], "bfloat16"), (np.ones(2, np.uint8), None),
    ([1 + 2j], None), (np.float16(1.5), None)])
def test_to_tensor_dtypes_match_the_reference(data, dtype):
    got = port.to_tensor(data, dtype=dtype)
    want = paddle.to_tensor(data, dtype=dtype)
    assert port.dtype.dtype_name(got.dtype) == np.dtype(want._data.dtype).name
    assert tuple(got.shape) == tuple(want.shape) and got.device.type == "cpu"
    bf16 = got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy() if bf16 else got.numpy(),
                                  np.asarray(want._data, np.float32 if bf16 else None))


def test_to_tensor_gradient_flag_place_and_copy():
    x = port.to_tensor([1.0, 2.0], stop_gradient=False)
    assert x.requires_grad and not port.to_tensor([1.0]).requires_grad
    assert not port.to_tensor([1, 2], stop_gradient=False).requires_grad
    src = torch.ones(2)
    y = port.to_tensor(src, place=port.CPUPlace())
    src.add_(1)
    assert torch.equal(y, torch.ones(2)) and port.tensor is port.to_tensor
    port.set_default_dtype("float16")
    assert port.to_tensor([0.5]).dtype == torch.float16
    assert port.to_tensor(np.zeros(1, np.float32)).dtype == torch.float32
    assert port.Tensor is torch.Tensor


def test_the_default_device_is_the_card_and_nothing_falls_back():
    assert port.get_device() == "cpu"          # the fixture's
    pdevice._current = None
    assert port.get_device() == "gpu:0"
    if not torch.cuda.is_available():
        for make in (lambda: port.to_tensor([1.0]), lambda: port.zeros([2]),
                     lambda: port.create_parameter([2]), lambda: port.randn([2]),
                     lambda: port.nn.Layer().create_parameter([2])):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.set_device("gpu")
        assert not port.is_compiled_with_cuda() or torch.backends.cuda.is_built()
    assert port.set_device("cpu") == torch.device("cpu") and port.get_device() == "cpu"
    with pytest.raises(ValueError, match="unknown device"):
        port.set_device("tpu")
    assert port.zeros([2]).device.type == "cpu"
    assert pdevice.device_count() == torch.cuda.device_count()
    assert port.is_compiled_with_xpu() is False


def test_places():
    assert port.CPUPlace() == port.CPUPlace() and port.CUDAPlace(1) != port.CUDAPlace(0)
    assert repr(port.CUDAPlace(1)) == "Place(gpu:1)" and port.CUDAPinnedPlace() == \
        port.CUDAPinnedPlace()
    assert pdevice.place_device(port.CPUPlace()) == torch.device("cpu")
    assert pdevice.place_device(port.CUDAPinnedPlace()) == torch.device("cpu")
    assert pdevice.place_device("cpu") == torch.device("cpu")
    assert port.to_tensor([1], place="cpu").device.type == "cpu"


def test_seed_and_state_replay():
    port.seed(7)
    a = [port.randn([4]), port.rand([3]), port.randint(0, 9, [5])]
    port.seed(7)
    b = [port.randn([4]), port.rand([3]), port.randint(0, 9, [5])]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    port.seed(8)
    assert not torch.equal(port.randn([4]), a[0])
    state = port.get_rng_state()
    c = port.normal(shape=[6])
    port.set_rng_state(state)
    assert torch.equal(port.normal(shape=[6]), c)
    assert isinstance(state, list) and state[0].dtype == torch.uint8
    # torch's own generator is left alone
    torch.manual_seed(0)
    t0 = torch.rand(3)
    torch.manual_seed(0)
    port.seed(1)
    port.rand([3])
    assert torch.equal(torch.rand(3), t0)


def test_grad_modes():
    x = port.to_tensor([1.0], stop_gradient=False)
    with port.no_grad():
        assert not port.is_grad_enabled() and not port.multiply(x, 2.0).requires_grad
    with port.set_grad_enabled(False):
        with port.enable_grad():
            assert port.multiply(x, 2.0).requires_grad
    assert port.is_grad_enabled()

    @port.no_grad()
    def f(t):
        return t * 2

    assert not f(x).requires_grad
    assert port.autograd.is_grad_enabled is torch.is_grad_enabled


def test_grad_matches_the_reference():
    a = np.array([0.5, -1.5, 2.0], np.float32)
    rx = paddle.to_tensor(a, stop_gradient=False)
    (rg,) = paddle.grad([(rx * rx * rx).sum()], [rx])
    x = port.to_tensor(a, stop_gradient=False)
    (g,) = port.grad(port.sum(port.pow(x, 3)), x, create_graph=True)
    np.testing.assert_allclose(g.detach().numpy(), rg.numpy(), rtol=1e-6)
    (gg,) = port.grad(port.sum(g), x)
    np.testing.assert_allclose(gg.numpy(), 6 * a, rtol=1e-6)
    y = port.to_tensor([1.0], stop_gradient=False)
    out = port.grad(port.sum(x), [x, y], allow_unused=True)
    assert out[1] is None and torch.equal(out[0], torch.ones(3))
    with pytest.raises(RuntimeError):
        port.grad(port.sum(x), [x, y])
    ry = paddle.to_tensor(np.ones(1, np.float32), stop_gradient=False)
    assert paddle.grad([rx.sum()], [rx, ry], allow_unused=True)[1] is None
    h = port.multiply(x, 2.0)
    (gx,) = port.grad(port.sum(port.multiply(h, x)), x, no_grad_vars=[h])
    np.testing.assert_allclose(gx.numpy(), 2 * a, rtol=1e-6)
    z = port.multiply(x, 3.0)
    port.autograd.backward([port.sum(z)])
    np.testing.assert_allclose(x.grad.numpy(), [3.0, 3.0, 3.0])


def _layers(pkg):
    class ScaledTanh(pkg.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, w, scale=2.0):
            y = pkg.tanh(x) * scale
            ctx.save_for_backward(y, w)
            ctx.scale = scale
            return y * w

        @staticmethod
        def backward(ctx, dy):
            y, w = ctx.saved_tensor()
            dx = dy * w * (ctx.scale - y * y / ctx.scale)
            return dx, None           # no gradient for w: Paddle's None

    return ScaledTanh


def test_pylayer_matches_the_references():
    rng = np.random.RandomState(3)
    a, w = rng.randn(5).astype(np.float32), rng.randn(5).astype(np.float32)
    rx = paddle.to_tensor(a, stop_gradient=False)
    rout = _layers(paddle).apply(rx, paddle.to_tensor(w), scale=3.0)
    rout.sum().backward()
    x = port.to_tensor(a, stop_gradient=False)
    pw = port.to_tensor(w, stop_gradient=False)
    out = _layers(port).apply(x, pw, scale=3.0)
    port.sum(out).backward()
    np.testing.assert_allclose(out.detach().numpy(), rout.numpy(), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), rx.grad.numpy(), rtol=1e-5)
    assert pw.grad is None

    class Index(port.autograd.PyLayer):
        @staticmethod
        def forward(ctx, t):
            idx = torch.argmax(t)
            ctx.mark_non_differentiable(idx)
            return t * 1.0, idx

        @staticmethod
        def backward(ctx, dy, didx):
            return dy

    y, idx = Index.apply(x)
    assert y.requires_grad and not idx.requires_grad
    assert issubclass(port.autograd.PyLayerContext, torch.autograd.function.BackwardCFunction)


@pytest.mark.parametrize("name", ["float32", "bfloat16", "float16", "float64", "int32",
                                  "int8", "uint8", "int16", "int64", "bool"])
def test_finfo_and_iinfo_match_the_reference(name):
    if name in ("bool",):
        with pytest.raises(Exception):
            port.iinfo(name)
        return
    kind = port.finfo if "float" in name else port.iinfo
    ref_kind = paddle.finfo if "float" in name else paddle.iinfo
    got, want = kind(name), ref_kind(name)
    for key in ("bits", "min", "max", "eps", "tiny", "smallest_normal", "resolution", "dtype"):
        assert getattr(got, key, None) == getattr(want, key, None), key
    assert kind(getattr(port, name)).bits == got.bits


def test_the_top_level_names():
    names = {"to_tensor", "Tensor", "Parameter", "bfloat16", "float16", "float32", "float64",
             "int8", "int16", "int32", "int64", "uint8", "bool", "complex64", "complex128",
             "get_default_dtype", "set_default_dtype", "set_device", "get_device", "seed",
             "get_rng_state", "set_rng_state", "get_cuda_rng_state", "set_cuda_rng_state",
             "no_grad", "enable_grad", "set_grad_enabled", "is_grad_enabled", "grad",
             "finfo", "iinfo", "CPUPlace", "CUDAPlace", "CUDAPinnedPlace", "create_parameter",
             "tolist", "batch", "ParamAttr", "matmul", "concat", "reshape", "add_", "tanh_",
             "in_dynamic_mode", "disable_static", "LazyGuard", "check_shape", "nn",
             "autograd", "device", "framework", "optimizer"}
    assert names <= set(port.__all__)
    missing = sorted(n for n in names if not hasattr(port, n) or n not in dir(paddle))
    assert missing == [], missing
    assert port.tolist(port.to_tensor([[1, 2]])) == [[1, 2]]
    assert list(port.batch(lambda: iter(range(5)), 2)()) == [[0, 1], [2, 3], [4]]
    assert port.in_dynamic_mode()
    for stream in (pdevice.Stream, pdevice.Event):
        assert stream in (torch.cuda.Stream, torch.cuda.Event)
