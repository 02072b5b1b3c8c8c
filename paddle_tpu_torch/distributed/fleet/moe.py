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

Across processes (the partitioning tier's ``PartitionedTrainStep`` and
``dist.parallelize``, which set each layer's :class:`ExpertPlan`) the
layer takes the reference's decisions on the global batch, as the
reference's one program over it does: every rank routes its own rows, and
an all-gather of each rank's per-expert counts of first and second
choices, its token count and its summed probabilities over the data ranks
(:func:`route_view`, in the global batch's order) gives each rank its
:class:`GlobalView`: the capacity from the global ``T``, the positions
after the earlier ranks' choices (second choices after the global count of
first choices), and the load-balance loss's density and proxy over the
global batch. The routing functions take the view (``view=``); without
one they route the tokens given. The experts are then

- whole on every rank (no axis cuts them);
- cut over an axis whose ranks hold the same rows (``tensor`` on the
  program mesh, ``ep`` on a legacy mesh): each rank runs its ``E / n``
  experts on the slots of the routing that every rank of the axis computes
  alike, and the partial outputs are summed over the axis (Megatron's
  ``f`` and ``g``, installed through :meth:`MoELayer.install_tensor_parallel`);
- cut over a data axis (``dp``): each rank sends the rows of its kept
  choices to the ranks that own their experts, one all-to-all with uneven
  splits (:mod:`._ep_a2a`), the owner scatters them into its ``[E / n, C,
  H]`` buffers at their global slots, runs its experts and sends the rows
  back, and the sender applies the gates. The pairs come from the sort's
  slots under either dispatch mode: the two forms' decisions and weights
  are the same bits, and the transport is the same.

The load-balance loss's all-gather has, as its backward, this rank's
share, and the loss's gradient is scaled by :attr:`ExpertPlan.aux_scale`
(the data ranks over the tensor ranks whose router gradients are summed),
so that the update's mean over the data ranks (and sum over the tensor
axis) counts it once. Under the measured dispatch policy each rank
chooses for the global batch's shape class; ranks that choose
differently round differently, as no collective depends on the
formulation.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ... import flags
from ...amp import cast_inputs
from ...device import resolve_device
from ...dtype import dtype_name
from ...nn.layer import Layer, Linear

__all__ = ["top2_gating", "top1_gating", "topk_routing", "sort_slots", "sort_gates",
           "sort_dispatch_moe", "dispatch_mode", "GlobalView",
           "route_view", "kept_counts", "ExpertPlan", "NaiveGate", "MoELayer"]


def _one_hot(idx, n: int, dtype=torch.float32):
    """One-hot rows of ``idx`` over ``n`` classes; an index outside
    ``[0, n)`` gives a row of zeros, as the reference's one-hot does (torch's
    ``one_hot`` raises there)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _balance_loss(mask1, probs, view):
    """GShard's load-balance loss: the share of first choices an expert
    times its mean probability, summed, times E; over the global batch when
    ``view`` is given."""
    E = probs.shape[-1]
    if view is None:
        return (mask1.mean(0) * probs.mean(0)).sum() * E
    return (view.total[0] / view.tokens * view.proxy).sum() * E


def top2_gating(gate_logits, capacity: int, view=None):
    """GShard top-2 gating of ``gate_logits [T, E]``: the combine weights
    ``[T, E, C]`` (f32), the dispatch mask (``combine > 0``) and the
    load-balance loss over the first choices. With ``view`` (a
    :class:`GlobalView`) the rows are this rank's part of the global batch:
    the positions follow the earlier ranks' choices and the loss is the
    global one."""
    E = gate_logits.shape[1]
    probs = torch.softmax(gate_logits.float(), dim=-1)

    g1_idx = probs.argmax(-1)
    mask1 = _one_hot(g1_idx, E)
    g1 = (probs * mask1).sum(-1)

    g2_idx = (probs * (1 - mask1)).argmax(-1)
    mask2 = _one_hot(g2_idx, E)
    g2 = (probs * mask2).sum(-1)

    aux_loss = _balance_loss(mask1, probs, view)

    # positions within each expert's buffer; a dropped choice's position
    # is masked to 0, so no one-hot below sees an index outside [0, C)
    pos1 = torch.cumsum(mask1, 0) * mask1 - mask1
    if view is not None:
        pos1 = pos1 + view.before[0] * mask1
    mask1 = mask1 * (pos1 < capacity)
    pos1 = (pos1 * mask1).sum(-1)

    # second choices queue behind the kept first choices (global ones)
    queue = (mask1.sum(0, keepdim=True) if view is None
             else torch.clamp_max(view.total[0], capacity) + view.before[1])
    pos2 = (torch.cumsum(mask2, 0) - mask2 + queue) * mask2
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


def top1_gating(gate_logits, capacity: int, view=None):
    """Switch-style top-1 gating: combine ``[T, E, C]`` with the raw gate
    probability (no renormalisation), dispatch mask, load-balance loss;
    ``view`` as :func:`top2_gating`'s."""
    E = gate_logits.shape[1]
    probs = torch.softmax(gate_logits.float(), dim=-1)
    mask = _one_hot(probs.argmax(-1), E)
    g = (probs * mask).sum(-1)
    aux_loss = _balance_loss(mask, probs, view)
    pos = torch.cumsum(mask, 0) * mask - mask
    if view is not None:
        pos = pos + view.before[0] * mask
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


def _aux_loss(probs, ids, view=None):
    """GShard's load-balance loss from raw routing (first choices); over
    the global batch when ``view`` is given."""
    return _balance_loss(_one_hot(ids[0], probs.shape[-1]), probs, view)


def sort_slots(ids, E: int, C: int, view=None):
    """The sort path's truncation decisions for ids ``[K, T]``: the stable
    order of the flattened (k, t) pairs by expert, and in that order each
    pair's expert, token, slot (clamped to ``[0, C)``) and whether it
    kept its slot. Slots fill in sort order, which is GShard's priority.
    With ``view`` the global sort's slots: a first choice after the
    earlier ranks' first choices of its expert, a second choice after every
    first choice of the global batch and the earlier ranks' second
    choices."""
    K, T = ids.shape
    flat_e = ids.reshape(-1).long()
    tok = torch.arange(T, device=ids.device).repeat(K)
    order = torch.sort(flat_e, stable=True).indices
    se = flat_e[order]
    stok = tok[order]
    counts = torch.bincount(flat_e, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(K * T, device=ids.device) - starts[se]
    if view is not None:
        # this rank's k-major pairs of an expert: its first choices, then
        # its second; each group moves to its global place
        shift = [view.before[0]]
        if K > 1:
            shift.append(view.total[0] + view.before[1]
                         - torch.bincount(ids[0].long(), minlength=E).to(view.total.dtype))
        pos = pos + torch.stack(shift).long()[order // T, se]
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


def sort_dispatch_moe(x, ids, gates, E: int, C: int, expert_fn, view=None, e0: int = 0,
                      local: int | None = None):
    """Sort-based capacity-bounded dispatch and combine of ``x [T, H]``
    routed by ids and gates ``[K, T]``: one stable sort replaces the dense
    form's ``[T, E, C]`` one-hots, so the cost grows as ``K T log(K T) +
    E C H``, not ``T E C H``; the weights are :func:`sort_gates`', the
    slots :func:`sort_slots`' (``view``: the global batch's). ``local``
    experts from ``e0`` run here (default every one): ``expert_fn`` maps
    ``[local, C, H]`` to ``[local, C, H]``, and the output sums the pairs of
    those experts only."""
    T = ids.shape[1]
    local = E if local is None else local
    order, se, stok, cpos, valid = sort_slots(ids, E, C, view)
    sg = sort_gates(gates, order, valid)
    keep = (valid & (se >= e0) & (se < e0 + local))[:, None]
    le = (se - e0).clamp(0, local - 1)
    rows = x[stok]
    exp_in = torch.zeros((local, C) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    exp_in = exp_in.index_put((le, cpos), torch.where(keep, rows, torch.zeros_like(rows)),
                              accumulate=True)
    exp_out = expert_fn(exp_in)
    picked = exp_out[le, cpos] * sg[:, None].to(exp_out.dtype)
    out = torch.zeros((T,) + tuple(exp_out.shape[2:]), dtype=exp_out.dtype, device=x.device)
    return out.index_add(0, stok, torch.where(keep, picked, torch.zeros_like(picked)))


def _expert_ffn(h, w_gate, w_up, w_down):
    """SwiGLU over every expert at once: ``h [E, C, H]`` -> ``[E, C, H]``."""
    g = torch.bmm(h, w_gate)
    u = torch.bmm(h, w_up)
    return torch.bmm(torch.nn.functional.silu(g) * u, w_down)


def _dense_moe(x, logits, w_gate, w_up, w_down, top_k: int, E: int, C: int, view=None,
               e0: int = 0):
    """The layer in the dense form on experts ``e0 ..`` (``w_gate``'s
    leading dim: every expert, or this rank's slice of an axis whose ranks
    hold the same rows, the output then partial over the axis), routed
    over ``view``'s global batch where it is given."""
    combine, dispatch, aux = (top1_gating(logits, C, view) if top_k == 1
                              else top2_gating(logits, C, view))
    T, H = x.shape
    El = w_gate.shape[0]
    # dispatch [T, E, C] x [T, H] -> [E, C, H]; combine [T, E, C] x [E, C, H] -> [T, H]
    exp_in = (dispatch[:, e0:e0 + El].to(x.dtype).reshape(T, El * C).T @ x).reshape(El, C, H)
    exp_out = _expert_ffn(exp_in, w_gate, w_up, w_down)
    return (combine[:, e0:e0 + El].to(x.dtype).reshape(T, El * C)
            @ exp_out.reshape(El * C, H)), aux


def _sort_moe(x, logits, w_gate, w_up, w_down, top_k: int, E: int, C: int, view=None,
              e0: int = 0, routed=None):
    """The layer in the sort form; ``view`` and ``e0`` as :func:`_dense_moe`'s,
    ``routed`` :func:`topk_routing`'s result where the caller has it."""
    ids, gates, probs = routed if routed is not None else topk_routing(logits, top_k)
    out = sort_dispatch_moe(x, ids, gates, E, C,
                            lambda h: _expert_ffn(h, w_gate, w_up, w_down), view, e0,
                            w_gate.shape[0])
    return out.to(x.dtype), _aux_loss(probs, ids, view)


_MOE = {"dense": _dense_moe, "sort": _sort_moe}


def _data_moe(x, ids, gates, weights, E: int, C: int, view, link):
    """The layer on experts cut over a data axis: this rank's kept pairs
    (the sort's slots, in expert order) go to their experts' owners through
    ``link``, each owner scatters the rows it receives into its ``[E / n,
    C, H]`` buffers at their global slots, runs its experts, and the rows go
    back to be weighted by their gates and summed per token."""
    T, H = x.shape
    El = weights[0].shape[0]
    order, se, stok, cpos, valid = sort_slots(ids, E, C, view)
    sg = sort_gates(gates, order, valid)
    keep = valid.nonzero().squeeze(1)
    ke, kt = se[keep], stok[keep]
    send = torch.bincount(ke // El, minlength=link.size).tolist()
    recv, slots = link.plan(view, C, El, x.device)
    rows = link.exchange(x[kt], send, recv)
    buf = torch.zeros((El * C, H), dtype=x.dtype, device=x.device)
    buf = buf.index_put((slots,), rows, accumulate=True)
    y = _expert_ffn(buf.reshape(El, C, H), *weights).reshape(El * C, H)
    back = link.exchange(y[slots], recv, send)
    picked = back * sg[keep][:, None].to(back.dtype)
    return torch.zeros((T, H), dtype=back.dtype, device=x.device).index_add(0, kt, picked)


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the gradient times ``scale`` backward."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None

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


class GlobalView:
    """This rank's place in the global batch of a layer's routing:
    ``counts [n, K, E]`` every data rank's choices an expert (k-major, the
    ranks in the global batch's order), ``tokens`` each rank's token count,
    ``index`` this rank's place and ``proxy [E]`` the mean probability of
    each expert over the global batch (differentiable in this rank's
    probabilities)."""

    def __init__(self, counts, tokens, index: int, proxy):
        self.counts, self.index, self.proxy = counts, index, proxy
        self.token_counts = [int(t) for t in tokens]
        self.before, self.total, self.tokens = self.of(index)

    def of(self, r: int) -> tuple:
        """``(before [K, E], total [K, E], tokens)`` as rank ``r`` sees them:
        the choices of the ranks before it, those of the global batch, and
        the global batch's ``T``."""
        return self.counts[:r].sum(0), self.counts.sum(0), sum(self.token_counts)


class _Share(torch.autograd.Function):
    """The all-gather of each rank's counts (``head``) and summed
    probabilities (``probsum``): forward the gathered counts and the
    probabilities summed over the ranks in rank order; backward this rank's
    share of the sum's gradient."""

    @staticmethod
    def forward(ctx, probsum, head, group):
        from .. import collective as _c

        row = torch.cat([head.float(), probsum.detach().float()])
        rows = torch.empty((group.nranks, row.numel()), dtype=row.dtype, device=row.device)
        _c.all_gather(rows, row, group=group)
        n = head.numel()
        counts = rows[:, :n].contiguous()
        ctx.mark_non_differentiable(counts)
        return counts, rows[:, n:].sum(0)

    @staticmethod
    def backward(ctx, _, g):
        return g, None, None


def route_view(ids, probs, group) -> GlobalView:
    """This rank's :class:`GlobalView` over ``group`` (the data ranks, in
    the global batch's order) from its routing ``ids [K, T]`` and
    ``probs [T, E]``: one all-gather of ``K E + 1 + E`` floats a rank (the
    counts exact below 2^24 tokens)."""
    K, T = ids.shape
    E = probs.shape[-1]
    counts = torch.stack([torch.bincount(ids[k].long(), minlength=E) for k in range(K)])
    head = torch.cat([counts.reshape(-1), counts.new_tensor([T])])
    gathered, probsum = _Share.apply(probs.sum(0), head, group)
    tokens = gathered[:, -1].tolist()
    counts = gathered[:, :-1].reshape(group.nranks, K, E)
    return GlobalView(counts, tokens, group.rank, probsum / sum(tokens))


def kept_counts(view: GlobalView, r: int, C: int):
    """``[K, E]`` the choices of rank ``r`` that keep their slots, and
    ``[K, E]`` the first slot of each group (host int64 arrays): a rank's
    first choices of an expert take the slots after the earlier ranks'
    first choices, its second choices those after every first choice of the
    global batch and the earlier ranks' second choices."""
    before, total, _ = view.of(r)
    mine = view.counts[r].cpu().numpy().astype(np.int64)
    start = before.cpu().numpy().astype(np.int64)
    if mine.shape[0] > 1:
        start[1] += total[0].cpu().numpy().astype(np.int64)
    return np.clip(C - start, 0, mine), start


@dataclasses.dataclass(eq=False)
class ExpertPlan:
    """How a layer runs across processes (set by the sharded update's
    planner): ``route`` the group of the data ranks whose rows make the
    global batch (None: this rank's rows are the batch), ``experts``
    "whole", "tensor" (cut over the layer's tensor axis, whose ranks hold
    the same rows) or "data" (cut over ``link``'s data axis, reached by the
    all-to-all), ``aux_scale`` the load-balance proxy's backward factor."""

    route: object = None
    experts: str = "whole"
    link: object = None
    aux_scale: float = 1.0


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
        self._tp, self._tp_cut = None, False    # the tensor axis (install_tensor_parallel)
        self._ep = None                         # the ExpertPlan across processes

    def capacity(self, tokens: int) -> int:
        """The slots of an expert for a batch of ``tokens`` (the global
        batch's across processes)."""
        return max(int(self.capacity_factor * tokens * self.top_k / self.num_experts), 4)

    def install_tensor_parallel(self, tp, is_cut) -> set:
        """Run on this rank's experts where the tensor axis ``tp`` cuts
        them (``is_cut(p)``): the input through ``f``, the partial output
        through ``g`` (under sequence parallelism the sequence's all-gather
        and reduce-scatter), as a Megatron MLP. Returns the ids of the
        parameters whose gradients are partial across the axis: the
        router's, whose combine weights meet only this rank's experts."""
        cut = is_cut(self.w_gate)
        if not (is_cut(self.w_up) == is_cut(self.w_down) == cut):
            raise ValueError("the experts' weights are cut unlike each other")
        self._tp, self._tp_cut = tp, cut
        return {id(self.gate.gate.weight)} if cut else set()

    def forward(self, x):
        tp = self._tp
        if tp is not None:
            x = tp.enter(x, self._tp_cut)
        shape = x.shape
        x2 = x.reshape(-1, shape[-1])
        if self._ep is None:
            out, aux = self._one_program(x2)
        else:
            out, aux = self._across(x2, self._ep)
        self.aux_loss = aux.float()
        out = out.reshape(shape)
        return out if tp is None else tp.exit(out, self._tp_cut)

    def _one_program(self, x2):
        T, E = x2.shape[0], self.num_experts
        C = self.capacity(T)
        logits = self.gate(x2)
        mode = self.dispatch or dispatch_mode(T, E, C, x2.shape[-1], x2.dtype, dh=self.d_hidden,
                                              top_k=self.top_k, device=x2.device)
        xa, lg, wg, wu, wd = cast_inputs("moe", x2, logits, self.w_gate, self.w_up,
                                         self.w_down)
        return _MOE[mode](xa, lg, wg, wu, wd, self.top_k, E, C)

    def _across(self, x2, plan):
        T, H = x2.shape
        E, K = self.num_experts, self.top_k
        logits = self.gate(x2)
        xa, lg, *weights = cast_inputs("moe", x2, logits, self.w_gate, self.w_up, self.w_down)
        ids, gates, probs = topk_routing(lg, K)
        view = route_view(ids, probs, plan.route) if plan.route is not None else None
        tokens = view.tokens if view is not None else T
        C = self.capacity(tokens)
        if plan.experts == "data":
            out, aux = _data_moe(xa, ids, gates, weights, E, C, view, plan.link), \
                _aux_loss(probs, ids, view)
        else:
            e0 = self._tp.rank * weights[0].shape[0] if plan.experts == "tensor" else 0
            mode = self.dispatch or dispatch_mode(tokens, E, C, H, x2.dtype, dh=self.d_hidden,
                                                  top_k=K, device=x2.device)
            out, aux = (_sort_moe(xa, lg, *weights, K, E, C, view, e0, (ids, gates, probs))
                        if mode == "sort" else _dense_moe(xa, lg, *weights, K, E, C, view, e0))
        return out.to(xa.dtype), _ScaleGrad.apply(aux, plan.aux_scale)

    def extra_repr(self):
        return (f"d_model={self.d_model}, d_hidden={self.d_hidden}, "
                f"num_experts={self.num_experts}, top_k={self.top_k}")
