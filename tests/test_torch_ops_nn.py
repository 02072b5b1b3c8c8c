"""PyTorch port: the registry's ``nn.functional`` rows against the
reference on the CPU.

The registry binds its ``nn_*`` rows late to the port's
``nn.functional`` (``paddle_tpu_torch/_ops_attach.py``), with the
reference's row metadata (signature, dtype classes). Every case of
``paddle_tpu_torch.tools.op_cases`` for those rows runs through both
registries on the same numpy inputs (``torch_op_parity.check_case``: each
op's first case in tier 1, its further cases in the slow tier with the
first as their sibling; values to rtol 1e-4 / atol 1e-5 in f32, gradients
against the reference's ``jax.vjp``; a drawing op by shape, dtype, its
check of values and replay). The rows whose reference takes 1.5-5 s here
(most of it its first call) run in the slow tier (``SLOW``): their tier-1
siblings are the earlier slices' tests of the same functionals,
``tests/test_torch_loss.py`` (ctc, rnnt, npair, hsigmoid, cosine
embedding), ``tests/test_torch_transformer.py`` (layer_norm),
``tests/test_torch_fused_norm.py`` (rms_norm) and
``tests/test_torch_flash_attention.py`` (flash_attention,
scaled_dot_product_attention).
"""

import pytest
import torch

import paddle_tpu_torch as port
from paddle_tpu_torch.ops.registry import OP_REGISTRY
from torch_op_parity import case_params, check_case, port_globals  # noqa: F401

SLOW = ("ctc_loss", "rnnt_loss", "npair_loss", "hsigmoid_loss", "cosine_embedding_loss",
        "layer_norm", "rms_norm", "flash_attention", "scaled_dot_product_attention")


@pytest.mark.parametrize("case, seed", case_params(
    lambda c: OP_REGISTRY[c.op].module.startswith("nn_"), slow=SLOW))
def test_op_matches_reference(case, seed):
    check_case(case, seed)


def test_rows_are_the_functionals_behind_a_dtype_check():
    from paddle_tpu_torch.nn import functional as F

    assert OP_REGISTRY["conv2d"].fn is F.conv2d
    assert OP_REGISTRY["scaled_dot_product_attention"].fn is F.scaled_dot_product_attention
    with pytest.raises(TypeError, match="dice_loss expects dtype"):
        OP_REGISTRY["dice_loss"].fn(torch.ones(2, 3, dtype=torch.int32),
                                    torch.zeros(2, 1, dtype=torch.int32))
    assert port.nn.functional.rms_norm is F.rms_norm
