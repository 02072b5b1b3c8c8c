"""Layers of the port (counterpart of ``paddle_tpu/nn/layer``) as
``torch.nn.Module``s."""

from .activation import (CELU, ELU, GELU, GLU, SELU, Hardshrink, Hardsigmoid, Hardswish,
                         Hardtanh, LeakyReLU, LogSigmoid, LogSoftmax, Maxout, Mish, PReLU,
                         ReLU, ReLU6, RReLU, Sigmoid, Silu, Softmax, Softplus, Softshrink,
                         Softsign, Swish, Tanh, Tanhshrink, ThresholdedReLU)
from .common import AlphaDropout, Dropout, Dropout2D, Dropout3D, Embedding, Linear
from .layers import Identity, LayerList, Sequential
from .norm import LayerNorm, RMSNorm
from .transformer import (MultiHeadAttention, Transformer, TransformerDecoder,
                          TransformerDecoderLayer, TransformerEncoder, TransformerEncoderLayer)

__all__ = ["CELU", "ELU", "GELU", "GLU", "SELU", "Hardshrink", "Hardsigmoid", "Hardswish",
           "Hardtanh", "LeakyReLU", "LogSigmoid", "LogSoftmax", "Maxout", "Mish", "PReLU",
           "ReLU", "ReLU6", "RReLU", "Sigmoid", "Silu", "Softmax", "Softplus", "Softshrink",
           "Softsign", "Swish", "Tanh", "Tanhshrink", "ThresholdedReLU",
           "AlphaDropout", "Dropout", "Dropout2D", "Dropout3D", "Embedding", "Linear",
           "Identity", "LayerList", "Sequential", "LayerNorm", "RMSNorm",
           "MultiHeadAttention", "Transformer", "TransformerDecoder", "TransformerDecoderLayer",
           "TransformerEncoder", "TransformerEncoderLayer"]
