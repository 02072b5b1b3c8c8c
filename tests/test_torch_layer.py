"""PyTorch port: ``nn.Layer``, ``ParamAttr`` and the initializers against
the reference's on the CPU.

The same layer tree, built with each package's classes, gives the same
``state_dict`` keys in the same order (every parameter, then every
persistable buffer); the same hooks, modes and containers behave alike;
``set_state_dict`` returns the same missing and unexpected lists and
refuses a shape; ``ParamAttr(trainable=False)``, ``learning_rate`` and
``need_clip=False`` are honoured through one AdamW step with a global-norm
clip, against the reference's step (f32, 1e-6). The deterministic
initializers (Constant, Assign) are held exactly against the reference's,
Dirac against Paddle's definition (the reference draws an orthogonal
block there), Orthogonal by orthogonality, fans and ``calculate_gain``
exactly, the random ones by their bounds and moments. Every layer class of
the port is an ``nn.Layer`` and a ``torch.nn.Module``.
"""

import importlib
import inspect
import math
import pkgutil

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as port
from paddle_tpu.nn import initializer as RI
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.nn import initializer as PI
from torch_op_parity import port_globals  # noqa: F401


def _ref_tree():
    class Tree(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = paddle.nn.Linear(4, 3)
            self.bn = paddle.nn.BatchNorm1D(3)
            self.seq = paddle.nn.Sequential(paddle.nn.Linear(3, 5), paddle.nn.ReLU(),
                                            paddle.nn.Linear(5, 2, bias_attr=False))
            self.blocks = paddle.nn.LayerList([paddle.nn.Linear(2, 2) for _ in range(2)])
            self.scale = self.create_parameter([2])
            self.register_buffer("steps", paddle.to_tensor(np.zeros(1, np.float32)))
            self.register_buffer("cache", paddle.to_tensor(np.zeros(2, np.float32)),
                                 persistable=False)

        def forward(self, x):
            x = self.seq(self.bn(self.fc(x)))
            for b in self.blocks:
                x = b(x)
            return x * self.scale

    return Tree()


def _port_tree():
    class Tree(pnn.Layer):
        def __init__(self):
            super().__init__()
            kw = {"device": "cpu"}
            self.fc = pnn.Linear(4, 3, **kw)
            self.bn = pnn.BatchNorm1D(3, **kw)
            self.seq = pnn.Sequential(pnn.Linear(3, 5, **kw), pnn.ReLU(),
                                      pnn.Linear(5, 2, bias_attr=False, **kw))
            self.blocks = pnn.LayerList([pnn.Linear(2, 2, **kw) for _ in range(2)])
            self.scale = self.create_parameter([2])
            self.register_buffer("steps", torch.zeros(1))
            self.register_buffer("cache", torch.zeros(2), persistable=False)

        def forward(self, x):
            x = self.seq(self.bn(self.fc(x)))
            for b in self.blocks:
                x = b(x)
            return x * self.scale

    return Tree()


def _carry(ref, layer):
    state = {k: np.asarray(v._data) for k, v in ref.state_dict().items()}
    assert layer.set_state_dict(state) == ([], [])
    return layer


def test_state_dict_keys_and_order_match_the_reference():
    ref, tree = _ref_tree(), _port_tree()
    assert list(tree.state_dict()) == list(ref.state_dict())
    assert "cache" not in tree.state_dict() and "steps" in tree.state_dict()
    assert [n for n, _ in tree.named_parameters()] == [n for n, _ in ref.named_parameters()]
    assert [n for n, _ in tree.named_sublayers()] == [n for n, _ in ref.named_sublayers()]
    assert len(tree.sublayers()) == len(ref.sublayers())
    _carry(ref, tree).eval()
    ref.eval()
    x = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    np.testing.assert_allclose(tree(torch.from_numpy(x)).detach().numpy(),
                               ref(paddle.to_tensor(x)).numpy(), rtol=1e-5, atol=1e-6)
    # torch's own machinery still sees torch's state dict and loads it
    twin = _port_tree()
    twin.load_state_dict(tree.state_dict(prefix=""))
    assert all(torch.equal(a, b) for a, b in zip(twin.parameters(), tree.parameters()))


def test_parameters_buffers_and_iteration_take_both_signatures():
    tree = _port_tree()
    params = tree.parameters()
    assert isinstance(params, list) and len(params) == 12
    assert len(tree.parameters(include_sublayers=False)) == 1
    assert len(tree.parameters(recurse=False)) == 1
    assert [n for n, _ in tree.named_parameters("m", False)] == ["m.scale"]
    assert isinstance(tree.buffers(), list) and len(tree.buffers()) == 4
    assert len(list(tree.named_buffers(include_sublayers=False))) == 2
    assert tree.full_name() == "tree" and tree._sub_layers is tree._modules
    tree.add_sublayer("extra", pnn.Linear(2, 2, device="cpu"))
    extra_w = tree.add_parameter("bias2", port.Parameter(torch.zeros(2)))
    assert tree.extra is tree._sub_layers["extra"] and tree.bias2 is extra_w


def test_a_buffer_reassigned_by_name_stays_a_buffer():
    tree = _port_tree()
    tree.steps = torch.ones(1)
    assert "steps" in dict(tree.named_buffers()) and torch.equal(tree.steps, torch.ones(1))
    assert "steps" in tree.state_dict() and "steps" not in dict(tree.named_parameters())
    tree.scale = port.Parameter(torch.full((2,), 3.0))
    assert torch.equal(dict(tree.named_parameters())["scale"], torch.full((2,), 3.0))


def test_hooks_and_modes_match_the_reference():
    ref, tree = _ref_tree(), _port_tree()
    _carry(ref, tree)
    x = np.random.RandomState(1).randn(3, 4).astype(np.float32)
    outs = []
    for model, t in ((ref, paddle.to_tensor(x)), (tree, torch.from_numpy(x))):
        pre = model.fc.register_forward_pre_hook(lambda layer, inputs: (inputs[0] * 2,))
        post = model.register_forward_post_hook(lambda layer, inputs, out: out + 1)
        model.eval()
        a = model(t)
        pre.remove()
        post.remove()
        b = model(t)
        outs.append([np.asarray(v.numpy() if hasattr(v, "numpy") and not isinstance(
            v, torch.Tensor) else v.detach().numpy()) for v in (a, b)])
    for got, want in zip(outs[1], outs[0]):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert tree.train() is tree and all(m.training for m in tree.sublayers())
    assert tree.eval() is tree and not any(m.training for m in tree.sublayers(include_self=True))
    tree.train(False)
    assert not tree.bn.training


def test_layer_dict_and_parameter_list():
    ref_d = paddle.nn.LayerDict({"a": paddle.nn.Linear(2, 3), "b": paddle.nn.Linear(3, 1)})
    d = pnn.LayerDict({"a": pnn.Linear(2, 3, device="cpu"), "b": pnn.Linear(3, 1,
                                                                             device="cpu")})
    assert list(d.keys()) == list(ref_d.keys()) and len(d) == 2 and "a" in d
    assert list(d.state_dict()) == list(ref_d.state_dict())
    d["c"] = pnn.ReLU()
    assert list(d) == ["a", "b", "c"] and isinstance(d, pnn.Layer)
    ref_p = paddle.nn.ParameterList([paddle.create_parameter([2], "float32")
                                     for _ in range(3)])
    p = pnn.ParameterList([port.create_parameter([2]) for _ in range(3)])
    assert list(p.state_dict()) == list(ref_p.state_dict()) == ["0", "1", "2"]
    p.append(port.create_parameter([4]))
    assert len(p) == 4 and p[3].shape == (4,) and len(p.parameters()) == 4


def test_set_state_dict_reports_and_refuses_as_the_reference():
    ref, tree = _ref_tree(), _port_tree()
    state = {k: np.asarray(v._data) for k, v in ref.state_dict().items()}
    del state["fc.bias"]
    state["nope"] = np.zeros(1, np.float32)
    assert tree.set_state_dict(state) == ref.set_state_dict(state)
    assert tree.load_dict is not None
    with pytest.raises(ValueError, match="shape mismatch for fc.weight"):
        tree.set_state_dict({"fc.weight": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError):
        ref.set_state_dict({"fc.weight": np.zeros((2, 2), np.float32)})
    half = _port_tree().astype("float16")
    half.set_state_dict({"fc.weight": np.ones((4, 3), np.float64)})
    assert half.fc.weight.dtype == torch.float16 and float(half.fc.weight.sum()) == 12.0
    assert half.steps.dtype == torch.float16 and half._dtype == torch.float16


def test_dtype_and_device_movement():
    tree = _port_tree()
    tree.register_buffer("count", torch.zeros(2, dtype=torch.int32))
    tree.to("cpu", "bfloat16")
    assert tree.fc.weight.dtype == torch.bfloat16 and tree.count.dtype == torch.int32
    tree.float()
    assert tree.fc.weight.dtype == torch.float32
    tree.half()
    assert tree.seq[0].weight.dtype == torch.float16
    tree.to(device=port.CPUPlace(), dtype="float32", blocking=True)
    assert tree.fc.weight.dtype == torch.float32 and tree.fc.weight.device.type == "cpu"
    w = tree.fc.weight
    tree.bfloat16()
    assert tree.fc.weight is w and isinstance(w, port.Parameter)


def test_param_attr_is_honoured_through_one_adamw_step():
    # nn.ParamAttr: the reference's layers take its nn class (its top-level
    # ParamAttr is another class, which they pass over)
    kw_ref = dict(weight_attr=paddle.nn.ParamAttr(learning_rate=0.5, need_clip=False),
                  bias_attr=paddle.nn.ParamAttr(trainable=False))
    kw = dict(weight_attr=pnn.ParamAttr(learning_rate=0.5, need_clip=False),
              bias_attr=pnn.ParamAttr(trainable=False))
    paddle.seed(4)
    ref = paddle.nn.Sequential(paddle.nn.Linear(6, 5, **kw_ref), paddle.nn.Linear(5, 2))
    model = pnn.Sequential(pnn.Linear(6, 5, device="cpu", **kw), pnn.Linear(5, 2,
                                                                            device="cpu"))
    _carry(ref, model)
    # the reference's create_parameter leaves need_clip off the parameter,
    # which its clip reads: set as its ParamAttr says
    ref[0].weight.need_clip = False
    assert ref[0].bias.stop_gradient and ref[0].weight.optimize_attr == {"learning_rate": 0.5}
    assert not model[0].bias.requires_grad and model[0].weight.optimize_attr == {
        "learning_rate": 0.5} and model[0].weight.need_clip is False
    rng = np.random.RandomState(2)
    x, y = rng.randn(8, 6).astype(np.float32), rng.randn(8, 2).astype(np.float32)
    ro = paddle.optimizer.AdamW(0.01, parameters=ref.parameters(), weight_decay=0.1,
                                grad_clip=paddle.nn.ClipGradByGlobalNorm(0.01))
    po = port.optimizer.AdamW(0.01, parameters=model.parameters(), weight_decay=0.1,
                              grad_clip=pnn.ClipGradByGlobalNorm(0.01))
    loss = ((ref(paddle.to_tensor(x)) - paddle.to_tensor(y)) ** 2).mean()
    loss.backward()
    ro.step()
    before = model[0].bias.detach().clone()
    ploss = ((model(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2).mean()
    ploss.backward()
    po.step()
    assert torch.equal(model[0].bias, before)
    for (n, p), (rn, rp) in zip(model.named_parameters(), ref.named_parameters()):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(rp._data), atol=1e-6,
                                   err_msg=n)


def test_create_parameter_defaults_and_the_global_initializer():
    holder = pnn.Layer()
    w = holder.create_parameter([30, 40])
    limit = math.sqrt(6.0 / 70)
    assert w.dtype == torch.float32 and w.device.type == "cpu" and w.requires_grad
    assert float(w.detach().abs().max()) <= limit and float(w.detach().abs().max()) > 0.9 * limit
    b = holder.create_parameter([4], is_bias=True)
    assert torch.equal(b, torch.zeros(4)) and b.is_bias
    assert holder.create_parameter([4], attr=False) is None
    named = port.create_parameter([3], name="w0", dtype="float16")
    assert named.paddle_name == "w0" and named.dtype == torch.float16
    PI.set_global_initializer(PI.Constant(0.25), PI.Constant(-1.0))
    assert torch.equal(holder.create_parameter([2]), torch.full((2,), 0.25))
    assert torch.equal(pnn.Linear(2, 2, device="cpu").bias, torch.full((2,), -1.0))
    assert torch.equal(holder.create_parameter([2], attr=pnn.ParamAttr(
        initializer=PI.Constant(2.0))), torch.full((2,), 2.0))
    PI.set_global_initializer(None)
    assert not torch.equal(holder.create_parameter([2, 2]), torch.full((2, 2), 0.25))


# each layer's default draw (no generator, no attr) comes from the port's
# generator of its device: ``seed(0)`` twice gives the same parameters, and
# torch's own global generator is neither read nor advanced
SEEDED_LAYERS = {
    "Linear": lambda: pnn.Linear(6, 5, device="cpu"),
    "Embedding": lambda: pnn.Embedding(7, 4, device="cpu"),
    "Conv2D": lambda: pnn.Conv2D(3, 4, 3, device="cpu"),
    "Conv1DTranspose": lambda: pnn.Conv1DTranspose(3, 2, 3, device="cpu"),
    "HSigmoidLoss": lambda: pnn.HSigmoidLoss(4, 6, device="cpu"),
    "AdaptiveLogSoftmaxWithLoss": lambda: pnn.AdaptiveLogSoftmaxWithLoss(8, 10, [4],
                                                                        device="cpu"),
    "MoELayer": lambda: port.distributed.fleet.MoELayer(4, 6, 2, device="cpu"),
}


@pytest.mark.parametrize("name", sorted(SEEDED_LAYERS))
def test_layer_default_draws_follow_the_ports_seed(name):
    def build():
        port.seed(0)
        return {k: v.detach().clone() for k, v in SEEDED_LAYERS[name]().state_dict().items()}

    saved = torch.get_rng_state()
    try:
        a = build()
        assert torch.equal(torch.get_rng_state(), saved)    # torch's generator untouched
        torch.manual_seed(12345)                            # and without a say
        b = build()
    finally:
        torch.set_rng_state(saved)
    port.seed(1)
    c = SEEDED_LAYERS[name]().state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    drawn = [k for k in a if a[k].numel() > 1 and a[k].std() > 0]
    assert drawn and all(not torch.equal(a[k], c[k]) for k in drawn)


@pytest.mark.parametrize("shape", [(7,), (5, 3), (8, 4, 3, 3), (6, 2, 5), (4, 4, 2, 2, 2)])
def test_fans_and_gains_are_the_references(shape):
    assert PI.Initializer._fan_in_out(shape) == RI.Initializer()._fan_in_out(shape)
    for nl, param in (("tanh", None), ("relu", None), ("leaky_relu", None),
                      ("leaky_relu", 0.2), ("selu", None), ("linear", None)):
        assert PI.calculate_gain(nl, param) == RI.calculate_gain(nl, param)


def test_deterministic_initializers():
    assert torch.equal(PI.Constant(1.5)([2, 3]), torch.full((2, 3), 1.5))
    np.testing.assert_array_equal(PI.Constant(1.5)([2, 3]).numpy(),
                                  np.asarray(RI.Constant(1.5)((2, 3), "float32")))
    vals = np.arange(6, dtype=np.float64).reshape(2, 3)
    np.testing.assert_array_equal(PI.Assign(vals)([3, 2], "float32").numpy(),
                                  np.asarray(RI.Assign(vals)((3, 2), "float32")))
    w = PI.Dirac(groups=2)([4, 3, 3, 3])
    want = np.zeros((4, 3, 3, 3), np.float32)
    for g in range(2):
        for i in range(2):
            want[g * 2 + i, i, 1, 1] = 1
    np.testing.assert_array_equal(w.numpy(), want)
    q = PI.Orthogonal(gain=2.0)([6, 4])
    np.testing.assert_allclose((q.T @ q).numpy(), 4 * np.eye(4), atol=1e-5)
    q = PI.Orthogonal()([3, 5])
    np.testing.assert_allclose((q @ q.T).numpy(), np.eye(3), atol=1e-5)


@pytest.mark.parametrize("name, init, lo, hi, std", [
    ("uniform", PI.Uniform(-0.3, 0.2), -0.3, 0.2, 0.5 / math.sqrt(12)),
    ("normal", PI.Normal(0.1, 0.02), None, None, 0.02),
    ("truncated", PI.TruncatedNormal(0.0, 0.5, -2.0, 2.0), -1.0, 1.0, None),
    ("xavier_uniform", PI.XavierUniform(), -math.sqrt(6 / 384), math.sqrt(6 / 384),
     math.sqrt(2 / 384)),
    ("xavier_normal", PI.XavierNormal(), None, None, math.sqrt(2 / 384)),
    ("kaiming_uniform", PI.KaimingUniform(), -math.sqrt(6 / 256), math.sqrt(6 / 256),
     math.sqrt(2 / 256)),
    ("kaiming_normal", PI.KaimingNormal(), None, None, math.sqrt(2 / 256))])
def test_random_initializers_by_bounds_and_moments(name, init, lo, hi, std):
    w = init([256, 128]).numpy().astype(np.float64)
    if lo is not None:
        assert w.min() >= lo and w.max() <= hi and w.min() < lo * 0.95
    if std is not None:
        assert abs(w.std() / std - 1) < 0.03, (name, w.std(), std)
    port.seed(1)
    again = init([256, 128])
    port.seed(1)
    assert torch.equal(init([256, 128]), again)


def _port_classes():
    import paddle_tpu_torch

    names = ["paddle_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
        paddle_tpu_torch.__path__, "paddle_tpu_torch.")]
    seen = {}
    for name in names:
        mod = importlib.import_module(name)
        for _, cls in inspect.getmembers(mod, inspect.isclass):
            if cls.__module__.startswith("paddle_tpu_torch") and issubclass(cls,
                                                                            torch.nn.Module):
                seen[f"{cls.__module__}.{cls.__qualname__}"] = cls
    return seen


def test_every_layer_class_of_the_port_is_a_layer():
    classes = _port_classes()
    assert len(classes) >= 80
    not_layers = sorted(n for n, c in classes.items() if not issubclass(c, pnn.Layer))
    assert not_layers == []
    model = port.models.LlamaForCausalLM(port.models.LlamaConfig.tiny(), device="cpu")
    assert isinstance(model, pnn.Layer) and isinstance(model.llama.layers, pnn.Layer)
    assert isinstance(port.vision.models.LeNet(device="cpu"), torch.nn.Module)
