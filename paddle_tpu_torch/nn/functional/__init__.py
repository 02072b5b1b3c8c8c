"""Functionals of the port (counterpart of ``paddle_tpu/nn/functional``):
plain functions on torch tensors, differentiable by torch autograd."""

from .activation import (celu, elu, gelu, glu, gumbel_softmax, hardshrink, hardsigmoid,
                         hardswish, hardtanh, leaky_relu, log_sigmoid, log_softmax, maxout,
                         mish, prelu, relu, relu6, rrelu, selu, sigmoid, silu, softmax,
                         softmax_, softplus, softshrink, softsign, swiglu, swish, tanh,
                         tanhshrink, thresholded_relu)
from .attention import flash_attention, scaled_dot_product_attention, sdpa_ref
from .common import alpha_dropout, dropout, dropout2d, dropout3d, embedding, linear
from .conv import (conv1d, conv1d_transpose, conv2d, conv2d_transpose, conv3d,
                   conv3d_transpose)
from .loss import cross_entropy
from .norm import batch_norm, layer_norm, rms_norm
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d, adaptive_avg_pool3d,
                      adaptive_max_pool1d, adaptive_max_pool2d, adaptive_max_pool3d,
                      avg_pool1d, avg_pool2d, avg_pool3d, max_pool1d, max_pool2d, max_pool3d)

__all__ = ["celu", "elu", "gelu", "glu", "gumbel_softmax", "hardshrink", "hardsigmoid",
           "hardswish", "hardtanh", "leaky_relu", "log_sigmoid", "log_softmax", "maxout",
           "mish", "prelu", "relu", "relu6", "rrelu", "selu", "sigmoid", "silu", "softmax",
           "softmax_", "softplus", "softshrink", "softsign", "swiglu", "swish", "tanh",
           "tanhshrink", "thresholded_relu",
           "flash_attention", "scaled_dot_product_attention", "sdpa_ref",
           "alpha_dropout", "dropout", "dropout2d", "dropout3d", "embedding", "linear",
           "conv1d", "conv1d_transpose", "conv2d", "conv2d_transpose", "conv3d",
           "conv3d_transpose",
           "cross_entropy", "batch_norm", "layer_norm", "rms_norm",
           "adaptive_avg_pool1d", "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d", "adaptive_max_pool3d",
           "avg_pool1d", "avg_pool2d", "avg_pool3d", "max_pool1d", "max_pool2d", "max_pool3d"]
