"""Functionals of the port (counterpart of ``paddle_tpu/nn/functional``):
plain functions on torch tensors, differentiable by torch autograd."""

from .activation import swiglu
from .attention import flash_attention, scaled_dot_product_attention, sdpa_ref
from .common import embedding, linear
from .loss import cross_entropy
from .norm import rms_norm

__all__ = ["swiglu", "flash_attention", "scaled_dot_product_attention", "sdpa_ref",
           "embedding", "linear", "cross_entropy", "rms_norm"]
