"""``paddle.autograd`` (counterpart of ``paddle_tpu/autograd``) over
torch's autograd: the grad modes are torch's, ``grad`` and ``backward``
call ``torch.autograd``, and ``PyLayer`` is a ``torch.autograd.Function``
with Paddle's names (``ctx.save_for_backward``, ``ctx.saved_tensor()``,
``ctx.mark_non_differentiable``; ``apply`` takes keywords, and a backward
may return one gradient or None for an input)."""

from __future__ import annotations

import torch

__all__ = ["no_grad", "enable_grad", "set_grad_enabled", "is_grad_enabled", "grad",
           "backward", "PyLayer", "PyLayerContext"]

no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled
is_grad_enabled = torch.is_grad_enabled


def _as_list(x):
    if x is None:
        return None
    return [x] if isinstance(x, torch.Tensor) else list(x)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None, create_graph=False,
         only_inputs=True, allow_unused=False, no_grad_vars=None):
    """The gradients of ``outputs`` with respect to ``inputs`` (a list),
    ``torch.autograd.grad``'s: ``create_graph`` keeps the graph of the
    gradients for a higher derivative; an input the outputs do not reach
    raises unless ``allow_unused`` (then its gradient is None); no gradient
    flows through ``no_grad_vars``."""
    outputs, inputs = _as_list(outputs), _as_list(inputs)
    hooks = [v.register_hook(torch.zeros_like) for v in _as_list(no_grad_vars) or []]
    try:
        grads = torch.autograd.grad(outputs, inputs, _as_list(grad_outputs),
                                    retain_graph=retain_graph, create_graph=create_graph,
                                    allow_unused=allow_unused)
    finally:
        for h in hooks:
            h.remove()
    return list(grads)


def backward(tensors, grad_tensors=None, retain_graph=False):
    torch.autograd.backward(_as_list(tensors), _as_list(grad_tensors),
                            retain_graph=retain_graph)


class PyLayerContext(torch.autograd.function.BackwardCFunction):
    """What a ``PyLayer``'s ``forward`` and ``backward`` receive as
    ``ctx``: torch's function context (``save_for_backward``,
    ``mark_non_differentiable``, ``needs_input_grad``), with Paddle's
    ``saved_tensor()`` beside torch's ``saved_tensors``."""

    def saved_tensor(self):
        return self.saved_tensors


_Context = PyLayerContext


class PyLayer:
    """A user-defined autograd op::

        class Exp(PyLayer):
            @staticmethod
            def forward(ctx, x):
                y = torch.exp(x)
                ctx.save_for_backward(y)
                return y

            @staticmethod
            def backward(ctx, dy):
                (y,) = ctx.saved_tensor()
                return dy * y

        y = Exp.apply(x)
    """

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def _function(cls):
        fn = cls.__dict__.get("_torch_function")
        if fn is None:
            layer = cls

            def forward(ctx, *args):
                ctx.n_args = len(args)
                return layer.forward(ctx, *args[:-1], **args[-1])

            def backward(ctx, *grads):
                out = layer.backward(ctx, *grads)
                out = (out,) if out is None or isinstance(out, torch.Tensor) else tuple(out)
                return out + (None,) * (ctx.n_args - len(out))

            fn = type(cls.__name__ + "Function", (torch.autograd.Function,),
                      {"forward": staticmethod(forward), "backward": staticmethod(backward)})
            fn._backward_cls = type(cls.__name__ + "Backward", (_Context,), {"_forward_cls": fn})
            cls._torch_function = fn
        return fn

    @classmethod
    def apply(cls, *args, **kwargs):
        return cls._function().apply(*args, dict(kwargs))
