"""Loss functionals (counterpart of ``paddle_tpu/nn/functional/loss.py``).

Each is the reference's formula on torch tensors, differentiable by torch
autograd, with the reference's clamps, masks and reductions. Under
``amp.auto_cast`` each first casts the tensors the reference's op takes
as inputs, by that op's name (``cross_entropy``, ``nll_loss`` and
``mse_loss`` are black-list ops: to f32; at O2 the others run in the amp
dtype). CTC and RNN-T run their recursions as a loop over time; the
hierarchical sigmoid builds its complete-binary-tree codes on the host
once per class count.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ...amp import cast_inputs

__all__ = ["cross_entropy", "softmax_with_cross_entropy", "nll_loss", "mse_loss", "l1_loss",
           "smooth_l1_loss", "binary_cross_entropy", "binary_cross_entropy_with_logits",
           "kl_div", "margin_ranking_loss", "hinge_embedding_loss", "cosine_embedding_loss",
           "triplet_margin_loss", "ctc_loss", "square_error_cost", "sigmoid_focal_loss",
           "log_loss", "dice_loss", "npair_loss", "gaussian_nll_loss", "poisson_nll_loss",
           "multi_margin_loss", "soft_margin_loss", "margin_cross_entropy", "hsigmoid_loss",
           "huber_loss", "hinge_loss", "rnnt_loss", "multi_label_soft_margin_loss",
           "triplet_margin_with_distance_loss", "adaptive_log_softmax_with_loss"]

# the reference's stand-in for -inf in its log-space recursions
_NEG = -1e30


def _reduce(val, reduction):
    if reduction == "mean":
        return val.mean()
    if reduction == "sum":
        return val.sum()
    return val


def _one_hot(idx, n, dtype):
    """One-hot rows of ``idx`` over ``n`` classes; an index outside
    ``[0, n)`` gives a row of zeros, as the reference's ``one_hot``."""
    return (idx.long()[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def cross_entropy(input, label, weight=None, ignore_index=-100, reduction="mean",
                  soft_label=False, axis=-1, use_softmax=True, label_smoothing=0.0,
                  name=None):
    """Softmax cross entropy with the reference's semantics (``loss.py:26``):
    log-softmax in f32 over ``axis``; hard labels with ``ignore_index``
    masked out of the loss and of the mean's denominator, an optional
    per-class ``weight`` (the mean then divides by the summed weights of the
    kept labels), uniform ``label_smoothing``; or ``soft_label``
    distributions. The hard-label loss gathers the label's column instead of
    building the reference's one-hot, which gives the same value and saves
    an [N, classes] f32 tensor. Under ``amp.auto_cast`` the input and the
    class weights are first cast as the op ``cross_entropy`` (black list:
    to f32)."""
    input, weight = cast_inputs("cross_entropy", input, weight)
    if use_softmax:
        logp = torch.log_softmax(input.float(), dim=axis)
    else:
        logp = torch.log(torch.clamp_min(input.float(), 1e-30))
    logp = logp.movedim(axis, -1)
    n_classes = logp.shape[-1]
    if soft_label:
        soft = label.float().movedim(axis, -1)
        if label_smoothing > 0:
            soft = soft * (1 - label_smoothing) + label_smoothing / n_classes
        return _reduce(-(soft * logp).sum(dim=-1), reduction)
    li = label
    if li.dim() == logp.dim():          # a trailing class axis of size 1
        li = li.squeeze(axis)
    li = li.long()
    keep = li != ignore_index
    safe = torch.where(keep, li, torch.zeros_like(li)).clamp(0, n_classes - 1)
    picked = logp.gather(-1, safe[..., None])[..., 0]
    if label_smoothing > 0:
        loss = -((1 - label_smoothing) * picked
                 + (label_smoothing / n_classes) * logp.sum(dim=-1))
    else:
        loss = -picked
    mask = keep.float()
    wv = None
    if weight is not None:
        wsel = weight.float()[safe]
        wv = wsel * mask
        loss = loss * wsel
    loss = loss * mask
    if reduction == "mean":
        denom = wv.sum() if wv is not None else mask.sum()
        return loss.sum() / torch.clamp_min(denom, 1e-12)
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False, ignore_index=-100,
                               numeric_stable_mode=True, return_softmax=False, axis=-1):
    """The unreduced :func:`cross_entropy`, and with ``return_softmax``
    the softmax of ``logits`` beside it."""
    loss = cross_entropy(logits, label, soft_label=soft_label, ignore_index=ignore_index,
                         reduction="none", axis=axis)
    if return_softmax:
        from .activation import softmax

        return loss, softmax(logits, axis=axis)
    return loss


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean", name=None):
    """Negative log likelihood of log-probabilities ``input [N, C, ...]``
    at ``label [N, ...]``; ``ignore_index`` masked out; the mean divides by
    the kept labels' weights (else their count, at least 1)."""
    input, weight = cast_inputs("nll_loss", input, weight)
    n_classes = input.shape[1]
    li = label.long()
    picked = input.gather(1, li.clamp(0, n_classes - 1).unsqueeze(1)).squeeze(1)
    inside = (li >= 0) & (li < n_classes)       # the reference's one-hot row is 0 outside
    mask = (li != ignore_index).to(input.dtype)
    loss = -(picked * inside.to(input.dtype)) * mask
    if weight is not None:
        wsel = weight[li.clamp(0, n_classes - 1)]
        loss = loss * wsel
        if reduction == "mean":
            return loss.sum() / torch.clamp_min((wsel * mask).sum(), 1e-12)
    if reduction == "mean":
        return loss.sum() / torch.clamp_min(mask.sum(), 1.0)
    return _reduce(loss, reduction)


def mse_loss(input, label, reduction="mean", name=None):
    input, label = cast_inputs("mse_loss", input, label)
    return _reduce(torch.square(input - label), reduction)


def l1_loss(input, label, reduction="mean", name=None):
    input, label = cast_inputs("l1_loss", input, label)
    return _reduce(torch.abs(input - label), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    """``0.5 d^2 / delta`` where ``d = |input - label| < delta``, else
    ``d - 0.5 delta``."""
    input, label = cast_inputs("smooth_l1_loss", input, label)
    d = torch.abs(input - label)
    return _reduce(torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta), reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean", name=None):
    """BCE of probabilities clipped to ``[1e-12, 1 - 1e-7]`` in f32."""
    input, label, weight = cast_inputs("binary_cross_entropy", input, label, weight)
    p = torch.clamp(input.float(), 1e-12, 1 - 1e-7)
    loss = -(label * torch.log(p) + (1 - label) * torch.log(1 - p))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None, reduction="mean",
                                     pos_weight=None, name=None):
    """BCE of ``sigmoid(logit)`` in the stable form, in f32; ``pos_weight``
    scales the positive term."""
    logit, label, weight, pos_weight = cast_inputs("bce_with_logits", logit, label, weight,
                                                   pos_weight)
    x = logit.float()
    soft = torch.log1p(torch.exp(-torch.abs(x)))
    if pos_weight is not None:
        log_w = (pos_weight - 1) * label + 1
        loss = (1 - label) * x + log_w * (soft + torch.clamp_min(-x, 0))
    else:
        loss = torch.clamp_min(x, 0) - x * label + soft
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def kl_div(input, label, reduction="mean", log_target=False, name=None):
    """``label * (log(max(label, 1e-12)) - input)`` (``exp(label) * (label -
    input)`` with ``log_target``); "batchmean" divides the sum by the
    batch."""
    input, label = cast_inputs("kl_div", input, label)
    if log_target:
        loss = torch.exp(label) * (label - input)
    else:
        loss = label * (torch.log(torch.clamp_min(label, 1e-12)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean", name=None):
    input, other, label = cast_inputs("margin_ranking_loss", input, other, label)
    return _reduce(torch.clamp_min(-label * (input - other) + margin, 0), reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean", name=None):
    input, label = cast_inputs("hinge_embedding_loss", input, label)
    return _reduce(torch.where(label == 1, input, torch.clamp_min(margin - input, 0)),
                   reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0, reduction="mean", name=None):
    input1, input2, label = cast_inputs("cosine_embedding_loss", input1, input2, label)
    norms = torch.linalg.vector_norm(input1, dim=-1) * torch.linalg.vector_norm(input2, dim=-1)
    cos = (input1 * input2).sum(-1) / torch.clamp_min(norms, 1e-12)
    return _reduce(torch.where(label == 1, 1 - cos, torch.clamp_min(cos - margin, 0)),
                   reduction)


def _p_dist(a, b, p, epsilon):
    return torch.pow(torch.pow(torch.abs(a - b) + epsilon, p).sum(-1), 1 / p)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0, epsilon=1e-6,
                        swap=False, reduction="mean", name=None):
    input, positive, negative = cast_inputs("triplet_margin_loss", input, positive, negative)
    dp = _p_dist(input, positive, p, epsilon)
    dn = _p_dist(input, negative, p, epsilon)
    if swap:
        dn = torch.minimum(dn, _p_dist(positive, negative, p, epsilon))
    return _reduce(torch.clamp_min(dp - dn + margin, 0), reduction)


def _ctc_forward(logits, labels, input_lengths, label_lengths, blank):
    """CTC negative log-likelihood of each sequence by the log-space forward
    recursion over the extended labels (blank, l1, blank, l2, ...,
    blank), a softmax applied to the scores first (warp-ctc's semantics);
    rows past their input length carry their values unchanged."""
    T, B, _ = logits.shape
    S = 2 * labels.shape[1] + 1
    dev = logits.device
    lp = torch.log_softmax(logits.float(), dim=-1)
    z = torch.full((B, S), blank, dtype=torch.long, device=dev)
    z[:, 1::2] = labels.long()
    emit = lp.gather(-1, z[None].expand(T, B, S))
    neg = torch.tensor(_NEG, device=dev)
    z_m2 = torch.cat([torch.full((B, 2), blank, dtype=torch.long, device=dev), z[:, :-2]], 1)
    can_skip = (z != blank) & (z != z_m2)
    alpha = torch.where(torch.arange(S, device=dev)[None] < 2, emit[0], neg)
    pad1 = torch.full((B, 1), _NEG, device=dev)
    pad2 = torch.full((B, 2), _NEG, device=dev)
    for t in range(1, T):
        a1 = torch.cat([pad1, alpha[:, :-1]], 1)
        a2 = torch.where(can_skip, torch.cat([pad2, alpha[:, :-2]], 1), neg)
        new = torch.logsumexp(torch.stack([alpha, a1, a2]), 0) + emit[t]
        alpha = torch.where((t < input_lengths)[:, None], new, alpha)
    end = 2 * label_lengths.long()          # the final blank
    a_end = alpha.gather(1, end[:, None])[:, 0]
    a_last = alpha.gather(1, torch.clamp_min(end - 1, 0)[:, None])[:, 0]
    a_last = torch.where(label_lengths > 0, a_last, neg)
    return -torch.logaddexp(a_end, a_last)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0, reduction="mean",
             norm_by_times=False):
    """Connectionist Temporal Classification loss of raw scores
    ``[max_logit_length, batch, num_classes + 1]`` (a softmax applied
    inside, as warp-ctc does). "mean" divides each sequence's loss by its
    label length, then averages; ``norm_by_times`` scales the gradients by
    1 / input length and leaves the values."""
    log_probs, = cast_inputs("ctc_loss", log_probs)
    loss = _ctc_forward(log_probs, labels, input_lengths, label_lengths, blank)
    if norm_by_times:
        scaled = loss / input_lengths.float()
        loss = (loss - scaled).detach() + scaled
    if reduction == "mean":
        return (loss / torch.clamp_min(label_lengths.float(), 1.0)).mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def square_error_cost(input, label):
    input, label = cast_inputs("square_error_cost", input, label)
    return torch.square(input - label)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0, reduction="sum",
                       name=None):
    logit, label, normalizer = cast_inputs("sigmoid_focal_loss", logit, label, normalizer)
    p = torch.sigmoid(logit.float())
    ce = torch.clamp_min(logit, 0) - logit * label + torch.log1p(torch.exp(-torch.abs(logit)))
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    loss = a_t * torch.pow(1 - p_t, gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


def log_loss(input, label, epsilon=1e-4, name=None):
    """Elementwise Bernoulli negative log likelihood (no reduction)."""
    input, label = cast_inputs("log_loss", input, label)
    return -label * torch.log(input + epsilon) - (1 - label) * torch.log(1 - input + epsilon)


def dice_loss(input, label, epsilon=1e-5, name=None):
    """``1 -`` the Dice coefficient of ``input`` and the one-hot of
    ``label [..., 1]``, per sample, averaged."""
    input, = cast_inputs("dice_loss", input)
    oh = _one_hot(label.squeeze(-1), input.shape[-1], input.dtype)
    red = tuple(range(1, input.dim()))
    inter = (input * oh).sum(red)
    union = input.sum(red) + oh.sum(red)
    return (1 - (2 * inter + epsilon) / (union + epsilon)).mean()


def npair_loss(anchor, positive, labels, l2_reg=0.002, name=None):
    """Cross entropy over the anchor-positive similarities, the targets
    spread over equal labels, plus ``l2_reg / 4`` times the embeddings'
    mean squared norms."""
    anchor, positive, labels = cast_inputs("npair_loss", anchor, positive, labels)
    sim = anchor @ positive.T
    same = (labels[:, None] == labels[None, :]).to(anchor.dtype)
    tgt = same / torch.clamp_min(same.sum(-1, keepdim=True), 1)
    xe = (torch.logsumexp(sim, 1) - (tgt * sim).sum(1)).mean()
    reg = l2_reg * ((anchor * anchor).sum(-1).mean() + (positive * positive).sum(-1).mean())
    return xe + reg * 0.25


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6, reduction="mean",
                      name=None):
    input, label, variance = cast_inputs("gaussian_nll_loss", input, label, variance)
    v = torch.clamp_min(variance, epsilon)
    loss = 0.5 * (torch.log(v) + (label - input) ** 2 / v)
    if full:
        loss = loss + 0.5 * math.log(2 * math.pi)
    return _reduce(loss, reduction)


def poisson_nll_loss(input, label, log_input=True, full=False, epsilon=1e-8, reduction="mean",
                     name=None):
    input, label = cast_inputs("poisson_nll_loss", input, label)
    if log_input:
        loss = torch.exp(input) - label * input
    else:
        loss = input - label * torch.log(input + epsilon)
    if full:
        stirling = (label * torch.log(label + epsilon) - label
                    + 0.5 * torch.log(2 * math.pi * (label + epsilon)))
        loss = loss + torch.where(label > 1, stirling, torch.zeros_like(stirling))
    return _reduce(loss, reduction)


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None, reduction="mean",
                      name=None):
    """The multi-class hinge ``max(margin - x[y] + x[j], 0) ** p`` summed
    over ``j != y`` and divided by the classes."""
    input, weight = cast_inputs("multi_margin_loss", input, weight)
    c = input.shape[1]
    li = label.long()
    m = torch.clamp_min(margin - input.gather(1, li[:, None]) + input, 0.0) ** p
    if weight is not None:
        m = m * weight[li][:, None]
    m = m * (1 - _one_hot(li, c, input.dtype))
    return _reduce(m.sum(-1) / c, reduction)


def soft_margin_loss(input, label, reduction="mean", name=None):
    input, label = cast_inputs("soft_margin_loss", input, label)
    return _reduce(torch.log1p(torch.exp(-label.to(input.dtype) * input)), reduction)


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5, margin3=0.0, scale=64.0,
                         group=None, return_softmax=False, reduction="mean", name=None):
    """The combined-margin softmax cross entropy (ArcFace / CosFace): the
    label's cosine becomes ``cos(margin1 * theta + margin2) - margin3``,
    every logit is scaled by ``scale``; one card (``group`` is ignored).
    With ``return_softmax`` also the softmax, without a gradient."""
    logits, = cast_inputs("margin_cross_entropy", logits)
    cos = torch.clamp(logits, -1.0, 1.0)
    target = torch.cos(margin1 * torch.arccos(cos) + margin2) - margin3
    oh = _one_hot(label, logits.shape[-1], logits.dtype)
    logp = torch.log_softmax(torch.where(oh > 0, target, cos) * scale, dim=-1)
    loss = _reduce(-(oh * logp).sum(-1), reduction)
    return (loss, torch.exp(logp).detach()) if return_softmax else loss


@functools.lru_cache(maxsize=64)
def _hsigmoid_tree(num_classes: int):
    """(path table, path code) of the complete binary tree over
    ``num_classes`` leaves: class c is the bits of ``c + num_classes``
    from the root down, internal nodes numbered from 0, rows padded with
    -1 and 0."""
    depth = max(1, int(math.ceil(math.log2(max(2, num_classes)))))
    tables, codes = [], []
    for c in range(num_classes):
        node, path, code = c + num_classes, [], []
        while node > 1:
            code.append(node & 1)
            node >>= 1
            path.append(node - 1)
        pad = depth - len(path)
        tables.append(path[::-1] + [-1] * pad)
        codes.append(code[::-1] + [0] * pad)
    return np.array(tables, np.int64), np.array(codes, np.float32)


def hsigmoid_loss(input, label, num_classes, weight, bias=None, path_table=None,
                  path_code=None, is_sparse=False, name=None):
    """Hierarchical sigmoid: the binary cross entropy of each edge on the
    label's path (code 1: right), summed to ``[N, 1]``. The default
    coding is the complete binary tree of :func:`_hsigmoid_tree`; a
    custom ``path_table`` / ``path_code`` ``[N, L]`` pads with -1.
    ``weight`` is ``[num_classes - 1, D]``, ``bias`` ``[num_classes - 1,
    1]`` (or flat)."""
    input, weight, bias = cast_inputs("hsigmoid_loss", input, weight, bias)
    if path_table is None:
        li = label.reshape(-1).long()
        tbl, cod = (torch.from_numpy(a).to(input.device) for a in _hsigmoid_tree(num_classes))
        pt, pc = tbl[li], cod[li]
    else:
        pt = torch.as_tensor(path_table).to(input.device).long()
        pc = torch.as_tensor(path_code).to(input.device, torch.float32)
    valid = pt >= 0
    nodes = torch.where(valid, pt, torch.zeros_like(pt))
    logit = torch.einsum("nd,nld->nl", input, weight[nodes])
    if bias is not None:
        b = bias[..., 0] if bias.dim() == 2 else bias
        logit = logit + b[nodes]
    edge = torch.logaddexp(torch.zeros_like(logit), torch.where(pc > 0, -logit, logit))
    return torch.where(valid, edge, torch.zeros_like(edge)).sum(-1, keepdim=True)


def huber_loss(input, label, delta=1.0, name=None):
    """Elementwise ``0.5 r^2`` for ``|r| <= delta``, else ``delta (|r| -
    0.5 delta)``, with ``r = label - input``."""
    input, label = cast_inputs("huber_loss", input, label)
    r = label - input
    a = torch.abs(r)
    return torch.where(a <= delta, 0.5 * r * r, delta * (a - 0.5 * delta))


def hinge_loss(input, label, name=None):
    """Elementwise ``max(0, 1 - input (2 label - 1))`` for labels in {0, 1}."""
    input, label = cast_inputs("hinge_loss", input, label)
    return torch.clamp_min(1.0 - input * (2.0 * label.to(input.dtype) - 1.0), 0.0)


def rnnt_loss(input, label, input_lengths, label_lengths, blank=0, fastemit_lambda=0.001,
              reduction="mean", name=None):
    """RNN-T loss over the ``[B, T, U + 1, D]`` lattice: a loop over time,
    each row a log-space prefix over the labels (``row[u] = E[u] +
    logcumsumexp(prev + blank - E)[u]``, E the emissions summed along u);
    FastEmit scales the emission terms' gradients by ``1 +
    fastemit_lambda`` and leaves the values."""
    input, = cast_inputs("rnnt_loss", input)
    lp = torch.log_softmax(input.float(), dim=-1)
    B, T, U1, D = lp.shape
    U = U1 - 1
    dev = lp.device
    blank_lp = lp[..., blank]
    lab = torch.clamp(label.long(), 0, D - 1)
    emit = lp[:, :, :U, :].gather(-1, lab[:, None, :, None].expand(B, T, U, 1))[..., 0]
    lam = float(fastemit_lambda)
    if lam:
        emit = (1.0 + lam) * emit - lam * emit.detach()
    neg = torch.tensor(_NEG, device=dev)
    valid = torch.arange(U1, device=dev)[None, :] <= label_lengths[:, None]
    ecum = torch.cat([torch.zeros((B, T, 1), device=dev), torch.cumsum(emit, -1)], -1)
    row = torch.where(valid, ecum[:, 0], neg)
    rows = [row]
    for t in range(1, T):
        e = ecum[:, t]
        new = torch.where(valid, e + torch.logcumsumexp(row + blank_lp[:, t - 1] - e, 1), neg)
        row = torch.where((t < input_lengths)[:, None], new, row)
        rows.append(row)
    rows = torch.stack(rows)                        # [T, B, U + 1]
    tb = torch.clamp(input_lengths.long() - 1, 0, T - 1)
    ub = torch.clamp(label_lengths.long(), 0, U)
    b = torch.arange(B, device=dev)
    loss = -(rows[tb, b, ub] + blank_lp[b, tb, ub])
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def multi_label_soft_margin_loss(input, label, weight=None, reduction="mean", name=None):
    """The mean over classes of each class's sigmoid cross entropy."""
    input, label, weight = cast_inputs("multi_label_soft_margin_loss", input, label, weight)
    y = label.to(input.dtype)
    term = (y * torch.nn.functional.logsigmoid(input)
            + (1 - y) * torch.nn.functional.logsigmoid(-input))
    if weight is not None:
        term = term * weight
    return _reduce(-term.mean(-1), reduction)


def triplet_margin_with_distance_loss(input, positive, negative, distance_function=None,
                                      margin=1.0, swap=False, reduction="mean", name=None):
    """The triplet loss under ``distance_function`` (called on the
    tensors; default the pairwise L2 distance ``sqrt(sum (u - v)^2 +
    1e-12)``)."""
    op = "triplet_margin_with_distance_loss"
    if distance_function is not None:
        dp = distance_function(input, positive)
        dn = distance_function(input, negative)
        if swap:
            dn = torch.minimum(dn, distance_function(positive, negative))
        dp, dn = cast_inputs(op, dp, dn)
    else:
        input, positive, negative = cast_inputs(op, input, positive, negative)

        def dist(u, v):
            return torch.sqrt(((u - v) ** 2).sum(-1) + 1e-12)

        dp, dn = dist(input, positive), dist(input, negative)
        if swap:
            dn = torch.minimum(dn, dist(positive, negative))
    return _reduce(torch.clamp_min(dp - dn + margin, 0.0), reduction)


def _adaptive_head(input, head_weight, head_bias):
    head = input @ head_weight
    if head_bias is not None:
        head = head + head_bias
    return torch.log_softmax(head, dim=-1)


def adaptive_log_softmax_with_loss(input, label, head_weight, tail_weights, cutoffs,
                                   head_bias=None, name=None):
    """The efficient softmax approximation (Grave et al.): the head covers
    the shortlist ``[0, cutoffs[0])`` and one logit per tail cluster;
    cluster i projects through ``tail_weights[i] = [w1 [in, h_i], w2 [h_i,
    size_i]]``. Every cluster's log-probabilities are computed for every
    row and selected by the label's range. Returns (the label's
    log-probability per row, the mean negative log-likelihood)."""
    flat = [w for pair in tail_weights for w in pair]
    input, head_weight, head_bias, *flat = cast_inputs(
        "adaptive_log_softmax_with_loss", input, head_weight, head_bias, *flat)
    shortlist = int(cutoffs[0])
    sizes = [int(w2.shape[-1]) for w2 in flat[1::2]]
    starts = np.concatenate([[shortlist], shortlist + np.cumsum(sizes)]).tolist()
    head_lp = _adaptive_head(input, head_weight, head_bias)
    y = label.long()
    in_head = y < shortlist
    out = torch.where(in_head, head_lp.gather(1, torch.clamp(y, 0, shortlist - 1)[:, None])[:, 0],
                      torch.zeros((), device=input.device, dtype=head_lp.dtype))
    for i, (w1, w2) in enumerate(zip(flat[0::2], flat[1::2])):
        clp = torch.log_softmax((input @ w1) @ w2, dim=-1)
        lo, hi = starts[i], starts[i + 1]
        local = torch.clamp(y - lo, 0, clp.shape[-1] - 1)
        val = head_lp[:, shortlist + i] + clp.gather(1, local[:, None])[:, 0]
        out = torch.where((y >= lo) & (y < hi), val, out)
    return out, -out.mean()
