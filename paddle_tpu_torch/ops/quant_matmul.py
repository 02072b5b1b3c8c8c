"""Int8 weight-only matmul: the Hopper kernels' wrappers, their plain
versions and the autograd ops.

Counterpart of ``paddle_tpu/ops/pallas/quant_matmul.py:116-201``:

- ``int8_matmul`` (:117, reached through ``matmul_gate``, :255) with
  ``int8_matmul_ref`` standing for the composed ``int8_matmul_xla``
  (:234). M <= 64 runs the weight stream of ``csrc/quant_matmul.cu`` (one
  launch; :func:`stream_plan` cuts K into slices where the column tiles
  leave a quarter of the SMs idle, and :func:`int8_matmul_blocked` repeats
  its sum order on the CPU); a larger M goes to
  :func:`int8_matmul_large_m`, the tensor-core kernel, as the reference's
  ``_fwd_blocks`` (:98-113) switches to compute-shaped blocks past M = 64;
- ``int8_matmul_dx`` (``_dx_pallas``, :143) with ``int8_matmul_dx_ref``;
- the differentiable ops: :func:`int8_matmul_frozen` (``_fwd_vjp`` /
  ``_bwd_vjp``, :139-176: dx only, the weights and scales are frozen) and
  :func:`int8_matmul_train_scales` (:179-201: dx and the scales'
  gradient).

On a CUDA tensor each wrapper launches its kernel or raises: the forward
takes bf16, fp16 or f32 activations of any M, dX bf16 or f32, with K and
N multiples of 16, and never declines to a composed path (which calls
reach a wrapper is the callers' rule: ``nn.quant.weight_only_linear``'s
gate, :func:`kernel_takes`). On a CPU tensor it runs the plain version.
fp16 activations run fp16 products with f32 sums (the weights widen to
fp16 exactly), as bf16 ones run bf16 products.

f32 activations (the reference's ``_dot`` at ``Precision.HIGHEST``) reach
the tensor-core kernel through an exact split (:func:`split3`): x = h + m
+ l in three bf16 pieces, summed as three bf16 products into one f32
accumulator. The plain versions compute the same three products, so the
CPU tests hold the split. A pre-pass kernel (:func:`int8_prepass`) writes
the split, and for dX the scaled ``dout * scales`` (in bf16, rounded as
the reference rounds it) that the tensor-core kernel then reduces. The
weight stream splits f32 x the same way, in registers as it stages x, and
adds each 16-deep step's three products in f32.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["int8_matmul", "int8_matmul_ref", "int8_matmul_large_m", "int8_matmul_dx",
           "int8_matmul_dx_ref", "int8_matmul_frozen", "int8_matmul_train_scales",
           "int8_prepass", "int8_matmul_blocked", "split3", "stream_plan", "stream_warps",
           "LARGE_M", "DTYPES"]

_COLS = 128          # output columns of a block of the weight stream (csrc kCols)
_SLICE_ROWS = 128    # K rows a slice holds a multiple of (csrc kSliceRows: whole stages)
_MAX_SPLIT = 8       # K slices of a column tile: the blocks of a cluster
_BLOCKS_PER_SM = 1.75  # the grid a split aims at (clusters of eight then fit one wave)
_FILL = 0.75         # column tiles that fill this share of the SMs are not split
LARGE_M = 64         # M above this runs the tensor-core forward
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}   # the forward's
DX_DTYPES = (torch.float32, torch.bfloat16)
_OUT_TYPES = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}


def kernel_takes(x, K: int, N: int) -> bool:
    """The rule by which ``weight_only_linear`` sends an int8 call to the
    kernels, as the reference's gate (``nn/quant.py:158-164``) sends f32
    and bf16 calls whose shapes its kernel takes: f32 or bf16 x, and K and
    N multiples of 16. fp16 and other shapes stay on the composed
    dequantize-then-matmul."""
    return x.dtype in DX_DTYPES and K % 16 == 0 and N % 16 == 0


def split3(x):
    """The exact split of f32 ``x`` into bf16 ``[3, *x.shape]``: h =
    bf16(x), m = bf16(x - h), l = bf16(x - h - m), each difference exact in
    f32, so that h + m + l == x."""
    h = x.bfloat16()
    r = x - h.float()
    m = r.bfloat16()
    return torch.stack((h, m, (r - m.float()).bfloat16()))


def _split_matmul(a, b):
    """f32 ``a @ b`` as the kernel computes it: the three bf16 pieces of
    ``a`` against ``b`` (exact in bf16), each product in f32, summed."""
    h, m, l = (p.float() for p in split3(a))
    return torch.matmul(h, b) + torch.matmul(m, b) + torch.matmul(l, b)


def int8_matmul_ref(x, w_int8, scales):
    """Plain version: ``x [M, K] @ w_int8 [K, N]`` with f32 accumulation,
    times the per-output-channel ``scales [N]`` in f32, cast to x's
    dtype; f32 x through its three bf16 pieces (:func:`split3`)."""
    w = w_int8.float()
    out = _split_matmul(x, w) if x.dtype == torch.float32 else torch.matmul(x.float(), w)
    return (out * scales.float()[None, :]).to(x.dtype)


def int8_matmul_dx_ref(dout, w_int8, scales):
    """Plain dX: ``bf16(dout * bf16(scales)) @ w_int8.T`` summed in f32 and
    cast to dout's dtype. The scale is cast to dout's dtype and the product
    rounds there before the sum, as ``_bwd_dx_kernel`` does; in f32 the
    product ``dout * scales`` goes through its three bf16 pieces."""
    scaled = dout * scales.to(dout.dtype)
    w_t = w_int8.float().T
    if dout.dtype == torch.float32:
        return _split_matmul(scaled, w_t)
    return torch.matmul(scaled.float(), w_t).to(dout.dtype)


def stream_plan(M: int, K: int, N: int, sms: int) -> tuple[int, int, int]:
    """``(kc, ksplit, blocks)`` of the weight stream: K rows of a slice (a
    multiple of 128, so of the kernel's stage), the slices, and the blocks
    of the launch (128 output columns each, ksplit of them a column tile:
    one thread-block cluster). K is cut only where the column tiles leave
    more than a quarter of the ``sms`` SMs idle, into at most 8 slices (a
    portable cluster) and at most 1.75 blocks an SM (two blocks share an
    SM, and clusters of eight then fit one wave); every slice holds rows.
    The plan does not depend on M."""
    tiles = -(-N // _COLS)
    blocks = -(-K // _SLICE_ROWS)
    ksplit = 1 if tiles >= _FILL * sms else max(
        1, min(_MAX_SPLIT, int(_BLOCKS_PER_SM * sms // tiles), blocks))
    kc = -(-blocks // ksplit) * _SLICE_ROWS
    ksplit = -(-K // kc)
    return kc, ksplit, tiles * ksplit


def stream_warps(M: int, dtype) -> int:
    """Consumer warps of a weight-stream block (csrc ``Geometry::kWarps``):
    eight up to 8 lanes, or 16 of bf16 or fp16 x, each one 16-deep step of a
    128-row stage; else four, each one step of a 64-row stage (past 32
    lanes two warps share a step, each for half the lanes)."""
    return 8 if M <= 8 or (dtype != torch.float32 and M <= 16) else 4


def int8_matmul_blocked(x, w_int8, scales, sms: int = 132):
    """The weight stream's sum order on the CPU: the K slices of
    :func:`stream_plan`, each summed as the kernel's consumer warps sum it
    (:func:`stream_warps`; warp class c takes the 16-deep steps c, c +
    classes, ... of K; past 32 lanes two warps a class), each 16-deep
    step's product one f32 term (for f32 x the three bf16 pieces'
    products, added together first), the classes then the slices added in
    order, times the scales, cast once. Same arguments and result as
    :func:`int8_matmul_ref`; M <= 64."""
    M, K = x.shape
    N = w_int8.shape[1]
    kc, ksplit, _ = stream_plan(M, K, N, sms)
    classes = stream_warps(M, x.dtype) // (2 if M > 32 else 1)
    w = w_int8.float()
    pieces = [p.float() for p in split3(x)] if x.dtype == torch.float32 else [x.float()]
    total = None
    for q in range(ksplit):
        sums = [torch.zeros((M, N), dtype=torch.float32) for _ in range(classes)]
        for k in range(q * kc, min(K, (q + 1) * kc), 16):
            d = pieces[0][:, k:k + 16] @ w[k:k + 16]
            for p in pieces[1:]:
                d = d + p[:, k:k + 16] @ w[k:k + 16]
            sums[k // 16 % classes] = sums[k // 16 % classes] + d
        part = sums[0]
        for s_ in sums[1:]:
            part = part + s_
        total = part if total is None else total + part
    return (total * scales.float()[None, :]).to(x.dtype)


_sms: dict = {}


def _fn(name, argtypes):
    fn = getattr(_build.load("quant_matmul"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _check(x, w_int8, scales, name="int8_matmul", along=0):
    """Refuse what the kernels do not take. ``x``'s columns run along
    ``w_int8``'s dimension ``along``: 0 (K) for the forward, 1 (N) for dX."""
    if x.dtype not in (DTYPES if along == 0 else DX_DTYPES):
        raise TypeError(f"{name} on the card takes "
                        f"{'bf16, fp16' if along == 0 else 'bf16'} or f32 activations, "
                        f"got {x.dtype}")
    if w_int8.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"{name}: weights must be int8 and scales float32")
    if x.dim() != 2 or w_int8.dim() != 2 or scales.dim() != 1:
        raise ValueError(f"{name}: x [M, K or N], w [K, N], scales [N]")
    K, N = w_int8.shape
    if x.shape[1] != w_int8.shape[along] or scales.shape[0] != N:
        raise ValueError(f"{name}: x {tuple(x.shape)} with w {tuple(w_int8.shape)} "
                         f"and scales {tuple(scales.shape)}")
    if K % 16 or N % 16:
        raise ValueError(f"{name}: K={K} and N={N} must be multiples of 16")
    for arg, t in (("x", x), ("w_int8", w_int8), ("scales", scales)):
        if t.device != x.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")


def _device_check(x, name):
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")


def int8_matmul(x, w_int8, scales):
    """``x [M, K] @ dequant(w_int8 [K, N], scales [N]) -> [M, N]`` in x's
    dtype. Counts launches of the weight stream (M <= 64, one kernel a
    call, nothing allocated but the output) in ``int8_matmul.launches``; a
    larger M is launched, and counted, by :func:`int8_matmul_large_m`."""
    if x.device.type == "cpu":
        return int8_matmul_ref(x, w_int8, scales)
    _device_check(x, "int8_matmul")
    _check(x, w_int8, scales)
    M, K = x.shape
    if M > LARGE_M:
        return int8_matmul_large_m(x, w_int8, scales)
    N = w_int8.shape[1]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    if dev not in _sms:
        _sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    kc, ksplit, _ = stream_plan(M, K, N, _sms[dev])
    fn = _fn("int8_matmul", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    rc = fn(x.data_ptr(), w_int8.data_ptr(), scales.data_ptr(), out.data_ptr(), M, K, N, kc,
            ksplit, DTYPES[x.dtype], _build.launch_stream(x.device))
    if rc != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: CUDA error {rc}")
    int8_matmul.launches += 1
    return out


def _check_prepass(x, scales):
    if x.dtype not in DX_DTYPES:
        raise TypeError(f"int8_prepass takes bf16 or f32, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"int8_prepass: x must be [rows, C], got {tuple(x.shape)}")
    if scales is None:
        if x.dtype != torch.float32:
            raise ValueError("int8_prepass: bf16 x (dX's dout) needs its scales")
    elif scales.dtype != torch.float32 or tuple(scales.shape) != (x.shape[1],):
        raise ValueError(f"int8_prepass: scales must be float32 [{x.shape[1]}], got "
                         f"{scales.dtype} {tuple(scales.shape)}")
    if x.device.type == "cpu":
        return
    _device_check(x, "int8_prepass")
    if x.shape[1] % 8:
        raise ValueError(f"int8_prepass: C={x.shape[1]} must be a multiple of 8")
    for arg, t in (("x", x), ("scales", scales)):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"int8_prepass: {arg} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"int8_prepass: {arg} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"int8_prepass: {arg} must be 16-byte aligned")


def int8_prepass(x, scales=None):
    """The pre-pass of the tensor-core kernel on the card. f32 ``x [rows,
    C]`` (times ``scales [C]`` in f32 when given) -> its split, bf16 ``[3,
    rows, C]``, equal to :func:`split3`; bf16 ``x`` (dX's dout) -> bf16
    ``x * bf16(scales)`` ``[rows, C]``, each product rounded once. On a CPU
    tensor it runs those plain expressions. It refuses what the kernel does
    not take: another dtype, bf16 without scales, scales that are not
    float32 ``[C]``, and on the card a tensor that is not contiguous,
    16-byte aligned and on x's device, or C not a multiple of 8."""
    _check_prepass(x, scales)
    f32 = x.dtype == torch.float32
    if x.device.type == "cpu":
        if f32:
            return split3(x if scales is None else x * scales)
        return x * scales.to(x.dtype)
    shape = (3, *x.shape) if f32 else tuple(x.shape)
    out = torch.empty(shape, dtype=torch.bfloat16, device=x.device)
    fn = _fn("int8_prepass", [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                                      ctypes.c_int, ctypes.c_void_p])
    rc = fn(x.data_ptr(), scales.data_ptr() if scales is not None else None, out.data_ptr(),
            x.shape[0], x.shape[1], DTYPES[x.dtype], _build.launch_stream(x.device))
    if rc != 0:
        raise RuntimeError(f"int8_prepass kernel launch failed: CUDA error {rc}")
    int8_prepass.launches += 1
    return out


def _tensor_core(act, w_int8, scales, out, dx: bool):
    """Launch the tensor-core kernel on ``act``: its pre-pass first for f32
    (the split) and for dX (the scaled dout)."""
    if dx:
        pieces = int8_prepass(act, scales)
    else:
        pieces = int8_prepass(act) if act.dtype == torch.float32 else act
    K, N = w_int8.shape
    fn = _fn("int8_matmul_tc", [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
             + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    rc = fn(pieces.data_ptr(), 3 if pieces.dim() == 3 else 1, w_int8.data_ptr(),
            scales.data_ptr(), out.data_ptr(), act.shape[0], K, N, int(dx),
            _OUT_TYPES[out.dtype], _build.launch_stream(act.device))
    if rc != 0:
        name = "int8_matmul_dx" if dx else "int8_matmul_large_m"
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def int8_matmul_large_m(x, w_int8, scales):
    """The tensor-core forward of :func:`int8_matmul` at any M
    (:func:`int8_matmul` sends it M > 64); f32 x runs as its three bf16
    pieces, after the split pre-pass; fp16 x as fp16 products."""
    if x.device.type == "cpu":
        return int8_matmul_ref(x, w_int8, scales)
    _device_check(x, "int8_matmul_large_m")
    _check(x, w_int8, scales, "int8_matmul_large_m")
    M = x.shape[0]
    out = torch.empty((M, w_int8.shape[1]), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    _tensor_core(x, w_int8, scales, out, dx=False)
    int8_matmul_large_m.launches += 1
    return out


def int8_matmul_dx(dout, w_int8, scales):
    """dX of ``x @ dequant(w_int8, scales)``: ``dout [M, N]`` against
    ``w_int8 [K, N]`` and ``scales [N]`` -> ``[M, K]`` in dout's dtype; the
    pre-pass forms ``dout * scales`` first (in bf16, or in f32 as its three
    bf16 pieces)."""
    if dout.device.type == "cpu":
        return int8_matmul_dx_ref(dout, w_int8, scales)
    _device_check(dout, "int8_matmul_dx")
    _check(dout, w_int8, scales, "int8_matmul_dx", along=1)
    M = dout.shape[0]
    dx = torch.empty((M, w_int8.shape[0]), dtype=dout.dtype, device=dout.device)
    if M == 0:
        return dx
    _tensor_core(dout, w_int8, scales, dx, dx=True)
    int8_matmul_dx.launches += 1
    return dx


#: kernel launches since the last reset (the CPU path never counts)
int8_matmul.launches = 0
int8_matmul_large_m.launches = 0
int8_matmul_dx.launches = 0
int8_prepass.launches = 0


# The ops call the wrappers through this module's globals, so that a test
# harness can route them to the plain versions by replacing the names.

class _Int8MatmulFrozen(torch.autograd.Function):
    """Frozen weights and scales: the backward is dx alone. Only the int8
    weights and the scales are saved (x's dtype and shape are dout's)."""

    @staticmethod
    def forward(ctx, x, w_int8, scales):
        ctx.save_for_backward(w_int8, scales)
        return int8_matmul(x, w_int8, scales)

    @staticmethod
    def backward(ctx, dout):
        w_int8, scales = ctx.saved_tensors
        dx = int8_matmul_dx(dout.contiguous(), w_int8, scales) if ctx.needs_input_grad[0] else None
        return dx, None, None


class _Int8MatmulTrainScales(torch.autograd.Function):
    """dx through the kernel and the scales' gradient
    ``sum_m dout * (x @ w_int8)`` in f32, composed as in the reference."""

    @staticmethod
    def forward(ctx, x, w_int8, scales):
        ctx.save_for_backward(x, w_int8, scales)
        return int8_matmul(x, w_int8, scales)

    @staticmethod
    def backward(ctx, dout):
        x, w_int8, scales = ctx.saved_tensors
        dout = dout.contiguous()
        dx = int8_matmul_dx(dout, w_int8, scales) if ctx.needs_input_grad[0] else None
        d_scales = None
        if ctx.needs_input_grad[2]:
            raw = torch.matmul(x.float(), w_int8.float())
            d_scales = (dout.float() * raw).sum(dim=0).to(scales.dtype)
        return dx, None, d_scales


def int8_matmul_frozen(x, w_int8, scales):
    """Differentiable ``x @ dequant(w_int8, scales)`` with frozen weights and
    scales: gradients reach x only."""
    return _Int8MatmulFrozen.apply(x, w_int8, scales)


def int8_matmul_train_scales(x, w_int8, scales):
    """Differentiable ``x @ dequant(w_int8, scales)`` whose backward also
    gives the per-channel scales' gradient (learned-scale training)."""
    return _Int8MatmulTrainScales.apply(x, w_int8, scales)
