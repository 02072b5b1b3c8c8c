"""PyTorch port: the creation ops and the products and norms of the
registry against the reference on the CPU; the registry itself.

Every case of ``paddle_tpu_torch.tools.op_cases`` whose op lives in
``ops/creation.py`` or ``ops/linalg.py`` runs through
both packages on the same numpy inputs (``torch_op_parity.check_case``;
each op's first case in tier 1, its further cases in the slow tier with
the first as their sibling: values to rtol 1e-4 / atol 1e-5 in f32,
integer and boolean results exactly, dtype names equal, gradients against
the reference's ``jax.vjp``). A drawing op is held by shape and dtype
against the reference's, by range and moments, and by replay from
``seed``. Then the registry: the set of the reference's ops the port does
not have yet (``MISSING``, the list ROADMAP gives), the table-driven ops,
the in-place rows, the YAML subset's reader against a YAML library, and
the 32-bit creation dtypes.
"""

import numpy as np
import pytest
import torch
import yaml

import paddle_tpu as paddle
import paddle_tpu_torch as port
from paddle_tpu.ops import registry as ref_registry
from paddle_tpu_torch.ops import registry
from paddle_tpu_torch.ops.registry import OP_REGISTRY
from torch_op_parity import case_params, check_case, port_globals  # noqa: F401

#: the reference's ops the port has not ported: linalg's decompositions and
#: solvers, and the nn / vision functionals the port's nn.functional lacks.
#: (The reference's ``unfold`` row is nn's im2col, which shadows its tensor
#: ``unfold``; the port's ``unfold`` row is the tensor one, and im2col waits
#: with ``fold``.)
MISSING_LINALG = {
    "cholesky", "cholesky_solve", "qr", "svd", "svdvals", "svd_lowrank", "pca_lowrank", "eig",
    "eigh", "eigvals", "eigvalsh", "lu", "lu_unpack", "det", "slogdet", "inv", "inverse",
    "pinv", "solve", "triangular_solve", "lstsq", "matrix_power", "matrix_rank", "matrix_exp",
    "cond", "householder_product", "ormqr"}
MISSING_NN = {
    "bilinear", "channel_shuffle", "cosine_similarity", "fold", "interpolate", "label_smooth",
    "one_hot", "pairwise_distance", "pixel_shuffle", "pixel_unshuffle", "upsample",
    "sequence_mask", "gather_tree", "temporal_shift", "group_norm", "instance_norm",
    "local_response_norm", "normalize", "lp_pool2d", "max_unpool2d", "max_unpool3d",
    "fractional_max_pool2d", "fractional_max_pool3d", "grid_sample", "affine_grid"}
MISSING_VISION = {
    "nms", "roi_align", "roi_pool", "box_coder", "yolo_box", "yolo_loss", "prior_box",
    "matrix_nms", "psroi_pool", "deform_conv2d", "distribute_fpn_proposals",
    "generate_proposals"}


@pytest.mark.parametrize("case, seed", case_params(
    lambda c: OP_REGISTRY[c.op].module in ("creation", "linalg")))
def test_op_matches_reference(case, seed):
    check_case(case, seed)


def test_the_missing_set_is_exactly_what_is_left():
    missing = set(ref_registry.registered_ops()) - set(registry.registered_ops())
    assert missing == MISSING_LINALG | MISSING_NN | MISSING_VISION
    assert not set(registry.registered_ops()) - set(ref_registry.registered_ops())
    assert len(MISSING_LINALG) == 27 and len(MISSING_NN) + len(MISSING_VISION) == 37


def test_registry_rows_match_the_references():
    port_rows = {n: OP_REGISTRY[n] for n in registry.registered_ops()}
    ref_rows = ref_registry.OP_REGISTRY
    for name, info in port_rows.items():
        ref = ref_rows[name]
        if name == "unfold":
            continue
        assert info.kind == ref.kind and info.module == ref.module, name
        assert info.dtypes == ref.dtypes and info.inplace == ref.inplace, name
        if info.kind in ("structured", "wrapped"):
            assert info.sig == ref.sig and info.tensors == ref.tensors, name
        if info.kind in ("unary", "binary", "compare", "reduce"):
            assert info.args == ref.args, name
    assert set(registry.table_driven_ops()) == set(ref_registry.table_driven_ops())
    assert sorted(registry.inplace_op_names()) == sorted(ref_registry.inplace_op_names())
    assert set(registry.method_op_names()) <= set(ref_registry.method_op_names())
    assert registry.get_op_info("add").args == ("x", "y")
    assert registry.get_op_info("remainder") is registry.get_op_info("mod")


def test_register_custom_and_the_in_place_companions():
    @registry.register_custom("twice_port_test")
    def twice(x):
        return x * 2

    try:
        assert registry.get_op_info("twice_port_test").fn is twice
        assert "twice_port_test" in registry.registered_ops()
    finally:
        del OP_REGISTRY["twice_port_test"]
    for name in registry.inplace_op_names():
        assert callable(getattr(port, name + "_")), name
    for name in ("reshape_", "scatter_", "fill_diagonal_", "exponential_",
                 "normal_", "bernoulli_", "where_", "tril_", "cumsum_", "flatten_"):
        assert callable(getattr(port, name)), name


def test_the_table_reader_agrees_with_a_yaml_library():
    rows = registry.load_table()
    with open(registry._YAML_PATH) as f:
        assert rows == yaml.safe_load(f)


def test_creation_follows_the_references_dtypes():
    for got, want in ((port.arange(5), paddle.arange(5)), (port.full([2], 3), paddle.full([2], 3)),
                      (port.to_tensor([1, 2]), paddle.to_tensor([1, 2])),
                      (port.to_tensor(np.zeros(2)), paddle.to_tensor(np.zeros(2))),
                      (port.zeros([2], "int64"), paddle.zeros([2], "int64")),
                      (port.randint(0, 5, [3]), paddle.randint(0, 5, [3])),
                      (port.randperm(4), paddle.randperm(4)),
                      (port.eye(2), paddle.eye(2))):
        assert port.dtype.dtype_name(got.dtype) == np.dtype(want._data.dtype).name
    port.set_default_dtype("float16")
    assert port.ones([2]).dtype == torch.float16
    assert port.to_tensor([0.5]).dtype == torch.float16
    assert port.randn([2]).dtype == torch.float16


def test_random_ops_draw_from_the_ports_generators():
    port.seed(3)
    a = port.rand([5])
    b = port.randn([5])
    port.seed(3)
    assert torch.equal(port.rand([5]), a) and torch.equal(port.randn([5]), b)
    gen = torch.Generator()
    gen.manual_seed(0)
    c = port.rand([5], generator=gen)
    gen.manual_seed(0)
    assert torch.equal(port.rand([5], generator=gen), c)
    state = port.get_rng_state()
    d = port.uniform([4])
    port.set_rng_state(state)
    assert torch.equal(port.uniform([4]), d)
