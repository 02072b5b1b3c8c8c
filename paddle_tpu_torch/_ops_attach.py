"""The registry's ``nn.functional`` rows, bound once ``nn`` is imported
(counterpart of ``paddle_tpu/_ops_attach.py``; ops and nn import in that
order)."""

from __future__ import annotations


def attach_nn_functional():
    from .nn.functional import activation, attention, common, conv, loss, norm, pooling
    from .ops.registry import attach_module_ops

    attach_module_ops({"nn_activation": activation, "nn_loss": loss, "nn_common": common,
                       "nn_conv": conv, "nn_pooling": pooling, "nn_norm": norm,
                       "nn_attention": attention})
