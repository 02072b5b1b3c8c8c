"""Layers of the port (counterpart of ``paddle_tpu/nn/layer``) as
``torch.nn.Module``s."""

from . import loss
from .activation import (CELU, ELU, GELU, GLU, SELU, Hardshrink, Hardsigmoid, Hardswish,
                         Hardtanh, LeakyReLU, LogSigmoid, LogSoftmax, Maxout, Mish, PReLU,
                         ReLU, ReLU6, RReLU, Sigmoid, Silu, Softmax, Softplus, Softshrink,
                         Softsign, Swish, Tanh, Tanhshrink, ThresholdedReLU)
from .common import AlphaDropout, Dropout, Dropout2D, Dropout3D, Embedding, Linear
from .conv import Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D, Conv3DTranspose
from .layers import Identity, LayerList, Sequential
from .loss import (AdaptiveLogSoftmaxWithLoss, BCELoss, BCEWithLogitsLoss, CosineEmbeddingLoss,
                   CrossEntropyLoss, CTCLoss, GaussianNLLLoss, HingeEmbeddingLoss, HSigmoidLoss,
                   KLDivLoss, L1Loss, MarginRankingLoss, MSELoss, MultiLabelSoftMarginLoss,
                   MultiMarginLoss, NLLLoss, PoissonNLLLoss, RNNTLoss, SmoothL1Loss,
                   SoftMarginLoss, TripletMarginLoss, TripletMarginWithDistanceLoss)
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, LayerNorm, RMSNorm,
                   SyncBatchNorm)
from .pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
                      AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
                      AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D, MaxPool3D)
from .transformer import (MultiHeadAttention, Transformer, TransformerDecoder,
                          TransformerDecoderLayer, TransformerEncoder, TransformerEncoderLayer)

__all__ = ["CELU", "ELU", "GELU", "GLU", "SELU", "Hardshrink", "Hardsigmoid", "Hardswish",
           "Hardtanh", "LeakyReLU", "LogSigmoid", "LogSoftmax", "Maxout", "Mish", "PReLU",
           "ReLU", "ReLU6", "RReLU", "Sigmoid", "Silu", "Softmax", "Softplus", "Softshrink",
           "Softsign", "Swish", "Tanh", "Tanhshrink", "ThresholdedReLU",
           "AlphaDropout", "Dropout", "Dropout2D", "Dropout3D", "Embedding", "Linear",
           "Conv1D", "Conv1DTranspose", "Conv2D", "Conv2DTranspose", "Conv3D", "Conv3DTranspose",
           "Identity", "LayerList", "Sequential", *loss.__all__,
           "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D", "LayerNorm", "RMSNorm",
           "SyncBatchNorm",
           "AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D", "AdaptiveMaxPool1D",
           "AdaptiveMaxPool2D", "AdaptiveMaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "MultiHeadAttention", "Transformer", "TransformerDecoder", "TransformerDecoderLayer",
           "TransformerEncoder", "TransformerEncoderLayer"]
