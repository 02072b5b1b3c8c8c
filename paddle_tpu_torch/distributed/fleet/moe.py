"""Mixture of Experts on one device (counterpart of
``paddle_tpu/distributed/fleet/moe.py``).

Routing is GShard's: a softmax over every expert, the top-1 or top-2
choices, each expert's buffer bounded at ``capacity`` slots filled in
token order (second choices queue behind every first choice), and a
top-2 pair renormalised over the choices that were kept. Two formulations
compute the same layer:

- dense (:func:`top2_gating` / :func:`top1_gating`): one-hot dispatch and
  combine tensors ``[T, E, C]``, and the dispatch and combine as matrix
  products;
- sort (:func:`topk_routing` + :func:`sort_dispatch_moe`): one stable sort
  of the ``K T`` (expert, token) pairs, a scatter into the ``[E, C, H]``
  buffers and a scatter-add back, the same truncation decisions by
  construction (k-major order).

:func:`dispatch_mode` picks one: the ``moe_dispatch`` flag, else dense for
small shapes, else one measured probe a shape class. The expert FFN is
SwiGLU batched over the experts (``torch.bmm``), as the reference leaves
its einsums to its compiler: no hand-written kernel runs here. The expert
axis of the weights is annotated for expert parallelism (``shard_axes``);
on one device it is plain metadata.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ... import flags
from ...amp import cast_inputs
from ...device import resolve_device
from ...dtype import dtype_name
from ...nn.layer import Layer, Linear

__all__ = ["top2_gating", "top1_gating", "topk_routing", "sort_slots", "sort_gates",
           "sort_dispatch_moe", "dispatch_mode", "NaiveGate", "MoELayer"]


def _one_hot(idx, n: int, dtype=torch.float32):
    """One-hot rows of ``idx`` over ``n`` classes; an index outside
    ``[0, n)`` gives a row of zeros, as the reference's one-hot does (torch's
    ``one_hot`` raises there)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def top2_gating(gate_logits, capacity: int):
    """GShard top-2 gating of ``gate_logits [T, E]``: the combine weights
    ``[T, E, C]`` (f32), the dispatch mask (``combine > 0``) and the
    load-balance loss over the first choices."""
    E = gate_logits.shape[1]
    probs = torch.softmax(gate_logits.float(), dim=-1)

    g1_idx = probs.argmax(-1)
    mask1 = _one_hot(g1_idx, E)
    g1 = (probs * mask1).sum(-1)

    g2_idx = (probs * (1 - mask1)).argmax(-1)
    mask2 = _one_hot(g2_idx, E)
    g2 = (probs * mask2).sum(-1)

    aux_loss = (mask1.mean(0) * probs.mean(0)).sum() * E

    # positions within each expert's buffer; a dropped choice's position
    # is masked to 0, so no one-hot below sees an index outside [0, C)
    pos1 = torch.cumsum(mask1, 0) * mask1 - mask1
    mask1 = mask1 * (pos1 < capacity)
    pos1 = (pos1 * mask1).sum(-1)

    pos2 = (torch.cumsum(mask2, 0) - mask2 + mask1.sum(0, keepdim=True)) * mask2
    mask2 = mask2 * (pos2 < capacity)
    pos2 = (pos2 * mask2).sum(-1)

    has1 = mask1.sum(-1)
    has2 = mask2.sum(-1)
    denom = g1 * has1 + g2 * has2
    denom = torch.where(denom > 0, denom, torch.ones_like(denom))
    g1 = g1 * has1 / denom
    g2 = g2 * has2 / denom

    combine = (g1[:, None, None] * mask1[:, :, None]
               * _one_hot(pos1.long(), capacity)[:, None, :]
               + g2[:, None, None] * mask2[:, :, None]
               * _one_hot(pos2.long(), capacity)[:, None, :])
    return combine, combine > 0, aux_loss


def top1_gating(gate_logits, capacity: int):
    """Switch-style top-1 gating: combine ``[T, E, C]`` with the raw gate
    probability (no renormalisation), dispatch mask, load-balance loss."""
    E = gate_logits.shape[1]
    probs = torch.softmax(gate_logits.float(), dim=-1)
    mask = _one_hot(probs.argmax(-1), E)
    g = (probs * mask).sum(-1)
    aux_loss = (mask.mean(0) * probs.mean(0)).sum() * E
    pos = torch.cumsum(mask, 0) * mask - mask
    mask = mask * (pos < capacity)
    pos = (pos * mask).sum(-1)
    combine = g[:, None, None] * mask[:, :, None] * _one_hot(pos.long(), capacity)[:, None, :]
    return combine, combine > 0, aux_loss


def topk_routing(gate_logits, top_k: int):
    """Raw top-k routing in k-major order (every first choice, then every
    second), so that a stable sort by expert gives GShard's priority.
    Returns ids ``[K, T]`` (int64), gates ``[K, T]`` (f32, unnormalised)
    and the probabilities ``[T, E]``."""
    probs = torch.softmax(gate_logits.float(), dim=-1)
    E = probs.shape[-1]
    g1_idx = probs.argmax(-1)
    g1 = probs.gather(-1, g1_idx[:, None])[:, 0]
    if top_k == 1:
        return g1_idx[None], g1[None], probs
    g2_idx = (probs * (1 - _one_hot(g1_idx, E))).argmax(-1)
    g2 = probs.gather(-1, g2_idx[:, None])[:, 0]
    return torch.stack([g1_idx, g2_idx]), torch.stack([g1, g2]), probs


def _aux_loss(probs, ids):
    """GShard's load-balance loss from raw routing (first choices)."""
    E = probs.shape[-1]
    return (_one_hot(ids[0], E).mean(0) * probs.mean(0)).sum() * E


def sort_slots(ids, E: int, C: int):
    """The sort path's truncation decisions for ids ``[K, T]``: the stable
    order of the flattened (k, t) pairs by expert, and in that order each
    pair's expert, token, slot (clamped to ``[0, C)``) and whether it
    kept its slot. Slots fill in sort order, which is GShard's priority."""
    K, T = ids.shape
    flat_e = ids.reshape(-1).long()
    tok = torch.arange(T, device=ids.device).repeat(K)
    order = torch.sort(flat_e, stable=True).indices
    se = flat_e[order]
    stok = tok[order]
    counts = torch.bincount(flat_e, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(K * T, device=ids.device) - starts[se]
    valid = pos < C
    return order, se, stok, pos.clamp(0, C - 1), valid


def sort_gates(gates, order, valid):
    """The combine weight of each pair of :func:`sort_slots`' order: a
    dropped pair's is 0, a top-2 pair is renormalised over the choices
    that kept their slots (as the dense form's ``has1``/``has2``
    denominator), a top-1 gate stays raw."""
    K, T = gates.shape
    valid_kt = torch.zeros(K * T, dtype=torch.float32, device=gates.device)
    valid_kt = valid_kt.index_put((order,), valid.float()).reshape(K, T)
    g = gates * valid_kt
    if K > 1:
        denom = g.sum(0)
        g = g / torch.where(denom > 0, denom, torch.ones_like(denom))
    return g.reshape(-1)[order]


def sort_dispatch_moe(x, ids, gates, E: int, C: int, expert_fn):
    """Sort-based capacity-bounded dispatch and combine of ``x [T, H]``
    routed by ids and gates ``[K, T]``: one stable sort replaces the dense
    form's ``[T, E, C]`` one-hots, so the cost grows as ``K T log(K T) +
    E C H``, not ``T E C H``; the weights are :func:`sort_gates`'.
    ``expert_fn`` maps ``[E, C, H]`` to ``[E, C, H]``."""
    T = ids.shape[1]
    order, se, stok, cpos, valid = sort_slots(ids, E, C)
    sg = sort_gates(gates, order, valid)
    keep = valid[:, None]
    rows = x[stok]
    exp_in = torch.zeros((E, C) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    exp_in = exp_in.index_put((se, cpos), torch.where(keep, rows, torch.zeros_like(rows)),
                              accumulate=True)
    exp_out = expert_fn(exp_in)
    picked = exp_out[se, cpos] * sg[:, None].to(exp_out.dtype)
    out = torch.zeros((T,) + tuple(exp_out.shape[2:]), dtype=exp_out.dtype, device=x.device)
    return out.index_add(0, stok, torch.where(keep, picked, torch.zeros_like(picked)))


def _expert_ffn(h, w_gate, w_up, w_down):
    """SwiGLU over every expert at once: ``h [E, C, H]`` -> ``[E, C, H]``."""
    g = torch.bmm(h, w_gate)
    u = torch.bmm(h, w_up)
    return torch.bmm(torch.nn.functional.silu(g) * u, w_down)


def _dense_moe(x, logits, w_gate, w_up, w_down, top_k: int, E: int, C: int):
    combine, dispatch, aux = (top1_gating(logits, C) if top_k == 1
                              else top2_gating(logits, C))
    T, H = x.shape
    # dispatch [T, E, C] x [T, H] -> [E, C, H]; combine [T, E, C] x [E, C, H] -> [T, H]
    exp_in = (dispatch.to(x.dtype).reshape(T, E * C).T @ x).reshape(E, C, H)
    exp_out = _expert_ffn(exp_in, w_gate, w_up, w_down)
    return combine.to(x.dtype).reshape(T, E * C) @ exp_out.reshape(E * C, H), aux


def _sort_moe(x, logits, w_gate, w_up, w_down, top_k: int, E: int, C: int):
    ids, gates, probs = topk_routing(logits, top_k)
    out = sort_dispatch_moe(x, ids, gates, E, C,
                            lambda h: _expert_ffn(h, w_gate, w_up, w_down))
    return out.to(x.dtype), _aux_loss(probs, ids)


_MOE = {"dense": _dense_moe, "sort": _sort_moe}

#: the measured choice a shape class, under the reference's key
#: ``(T, E, C, H, dtype name, dh, top_k)``
_DISPATCH_CHOICE: dict = {}
#: the probe's best seconds of each path a shape class (``dense_s`` is
#: missing when the dense path ran out of memory)
_PROBE_TIMES: dict = {}
#: ``T E C H`` at or below which dense wins without a probe
_SMALL = 1 << 28


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _probe_dispatch(T: int, E: int, C: int, H: int, dtype, dh: int, top_k: int = 2,
                    device="cuda") -> str:
    """Time both whole expert programs (routing, dispatch, the SwiGLU
    experts and the combine, forward and backward with respect to ``x`` and
    the three expert weights; best of 3 after a warm-up) and return the
    faster. ``x`` and the logits are the reference's
    ``np.random.RandomState(0)`` draws; the expert weights (``E H dh``
    values each, billions at real widths) are drawn on the device from a
    generator seeded 0, scaled by 0.02: the time does not depend on their
    values. Only running out of memory on the dense path chooses sort
    without a time; any other failure raises.

    The probe runs during a forward, perhaps inside a recompute region:
    its own graph saves its tensors as they are, and no dispatch mode of
    the region sees its ops."""
    from torch.utils._python_dispatch import _disable_current_modes

    dev = resolve_device(device)
    key = (T, E, C, H, dtype_name(dtype), dh, top_k)
    rng = np.random.RandomState(0)
    x = torch.tensor(rng.randn(T, H), dtype=dtype, device=dev)
    logits = torch.tensor(rng.randn(T, E), dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    weights = [(torch.randn(shape, generator=gen, device=dev) * 0.02).to(dtype)
               for shape in ((E, H, dh), (E, H, dh), (E, dh, H))]

    def timed(path):
        def once():
            leaves = [x.requires_grad_(True)] + [w.requires_grad_(True) for w in weights]
            out, _ = _MOE[path](x, logits, *weights, top_k, E, C)
            torch.autograd.grad(out.float().sum(), leaves)
            _sync(dev)

        once()
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            once()
            best = min(best, time.perf_counter() - t0)
        return best

    times = {}
    with _disable_current_modes(), torch.enable_grad(), \
            torch.autograd.graph.saved_tensors_hooks(lambda t: t, lambda t: t):
        try:
            times["dense_s"] = timed("dense")
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
        times["sort_s"] = timed("sort")
    _PROBE_TIMES[key] = times
    dense = times.get("dense_s")
    return "dense" if dense is not None and dense <= times["sort_s"] else "sort"


def dispatch_mode(T: int, E: int, C: int, H: int, dtype=torch.float32, dh: int | None = None,
                  top_k: int = 2, device="cuda") -> str:
    """"dense" or "sort": the ``moe_dispatch`` flag where it names one;
    else the cached choice of this shape class; else dense where
    ``T E C H <= 2**28`` (no probe), or one probe on ``device``."""
    forced = flags.get_flag("moe_dispatch")
    if forced in ("dense", "sort"):
        return forced
    dh = dh if dh is not None else 4 * H
    key = (T, E, C, H, dtype_name(dtype), dh, top_k)
    if key not in _DISPATCH_CHOICE:
        if T * E * C * H <= _SMALL:
            _DISPATCH_CHOICE[key] = "dense"
        else:
            _DISPATCH_CHOICE[key] = _probe_dispatch(T, E, C, H, dtype, dh, top_k, device)
    return _DISPATCH_CHOICE[key]


class NaiveGate(Layer):
    """The router: a bias-free ``Linear(d_model, num_experts)``."""

    def __init__(self, d_model, num_experts, *, device="cuda", dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.gate = Linear(d_model, num_experts, bias_attr=False, device=device, dtype=dtype,
                           generator=generator)
        self.num_experts = num_experts

    def forward(self, x):
        return self.gate(x)


def _expert_weight(layer, shape, *, device, dtype, generator):
    """``layer.create_parameter``'s default, Xavier-uniform with Paddle's
    receptive-field rule for a 3-D shape ``[E, a, b]``: fan_in ``a b``,
    fan_out ``E b``; sharded over its expert axis."""
    p = layer.create_parameter(shape, dtype=dtype, device=device, generator=generator)
    # the expert axis over 'ep' where a mesh names it, else over 'dp'
    p.shard_axes = {0: ("ep", "dp")}
    return p


class MoELayer(Layer):
    """Paddle's ``MoELayer`` in the GShard formulation: the router
    ``gate.gate.weight [d_model, E]`` and the stacked SwiGLU experts
    ``w_up``, ``w_gate [E, d_model, d_hidden]`` and ``w_down [E, d_hidden,
    d_model]``. Each expert takes ``capacity = max(int(capacity_factor T
    top_k / E), 4)`` tokens of a call's ``T``. ``dispatch``: None (the
    measured policy, :func:`dispatch_mode`), "dense" or "sort". After a
    forward, ``aux_loss`` holds the load-balance loss (f32 scalar).
    ``gate`` and ``activation`` are taken and ignored, as the reference
    ignores them. Under ``amp`` the layer's inputs (``x``, the router's
    logits, the three expert weights) cast as the op ``moe``."""

    def __init__(self, d_model, d_hidden, num_experts, top_k=2, capacity_factor=1.25,
                 gate="gshard", activation=None, dispatch=None, *, device="cuda",
                 dtype=torch.float32, generator=None):
        super().__init__()
        if dispatch not in (None, "dense", "sort"):
            raise ValueError(f"dispatch must be None, 'dense' or 'sort', not {dispatch!r}")
        self.d_model = d_model
        self.d_hidden = d_hidden
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.dispatch = dispatch
        mk = dict(device=device, dtype=dtype, generator=generator)
        self.gate = NaiveGate(d_model, num_experts, **mk)
        self.w_up = _expert_weight(self, (num_experts, d_model, d_hidden), **mk)
        self.w_gate = _expert_weight(self, (num_experts, d_model, d_hidden), **mk)
        self.w_down = _expert_weight(self, (num_experts, d_hidden, d_model), **mk)
        self.aux_loss = None

    def capacity(self, tokens: int) -> int:
        return max(int(self.capacity_factor * tokens * self.top_k / self.num_experts), 4)

    def forward(self, x):
        shape = x.shape
        x2 = x.reshape(-1, shape[-1])
        T, E = x2.shape[0], self.num_experts
        C = self.capacity(T)
        logits = self.gate(x2)
        mode = self.dispatch or dispatch_mode(T, E, C, shape[-1], x2.dtype, dh=self.d_hidden,
                                              top_k=self.top_k, device=x2.device)
        xa, lg, wg, wu, wd = cast_inputs("moe", x2, logits, self.w_gate, self.w_up,
                                         self.w_down)
        out, aux = _MOE[mode](xa, lg, wg, wu, wd, self.top_k, E, C)
        self.aux_loss = aux.float()
        return out.reshape(shape)

    def extra_repr(self):
        return (f"d_model={self.d_model}, d_hidden={self.d_hidden}, "
                f"num_experts={self.num_experts}, top_k={self.top_k}")
