"""Functionals of the port (counterpart of ``paddle_tpu/nn/functional``):
plain functions on torch tensors, differentiable by torch autograd."""

from .activation import (celu, elu, gelu, glu, gumbel_softmax, hardshrink, hardsigmoid,
                         hardswish, hardtanh, leaky_relu, log_sigmoid, log_softmax, maxout,
                         mish, prelu, relu, relu6, rrelu, selu, sigmoid, silu, softmax,
                         softmax_, softplus, softshrink, softsign, swiglu, swish, tanh,
                         tanhshrink, thresholded_relu)
from .attention import flash_attention, scaled_dot_product_attention, sdpa_ref
from .common import alpha_dropout, dropout, dropout2d, dropout3d, embedding, linear
from .loss import cross_entropy
from .norm import layer_norm, rms_norm

__all__ = ["celu", "elu", "gelu", "glu", "gumbel_softmax", "hardshrink", "hardsigmoid",
           "hardswish", "hardtanh", "leaky_relu", "log_sigmoid", "log_softmax", "maxout",
           "mish", "prelu", "relu", "relu6", "rrelu", "selu", "sigmoid", "silu", "softmax",
           "softmax_", "softplus", "softshrink", "softsign", "swiglu", "swish", "tanh",
           "tanhshrink", "thresholded_relu",
           "flash_attention", "scaled_dot_product_attention", "sdpa_ref",
           "alpha_dropout", "dropout", "dropout2d", "dropout3d", "embedding", "linear",
           "cross_entropy", "layer_norm", "rms_norm"]
