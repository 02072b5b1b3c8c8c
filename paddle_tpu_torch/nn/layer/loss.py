"""Loss layers (counterpart of ``paddle_tpu/nn/layer/loss.py``): each calls
the functional of the same name with the arguments it was built with.
``HSigmoidLoss`` and ``AdaptiveLogSoftmaxWithLoss`` own parameters, with
the reference's names and layouts (Xavier-uniform weights, zero biases),
drawn from an explicit ``generator`` on ``device``."""

from __future__ import annotations

import torch

from ...amp import cast_inputs
from .. import functional as F
from ..functional.loss import _adaptive_head
from .layers import Layer

__all__ = ["CrossEntropyLoss", "MSELoss", "L1Loss", "NLLLoss", "BCELoss", "BCEWithLogitsLoss",
           "SmoothL1Loss", "KLDivLoss", "MarginRankingLoss", "HingeEmbeddingLoss",
           "CosineEmbeddingLoss", "TripletMarginLoss", "CTCLoss", "HSigmoidLoss",
           "PoissonNLLLoss", "RNNTLoss", "MultiLabelSoftMarginLoss",
           "TripletMarginWithDistanceLoss", "MultiMarginLoss", "SoftMarginLoss",
           "GaussianNLLLoss", "AdaptiveLogSoftmaxWithLoss"]


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean", soft_label=False,
                 axis=-1, use_softmax=True, label_smoothing=0.0, name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax
        self.label_smoothing = label_smoothing

    def forward(self, input, label):
        return F.cross_entropy(input, label, self.weight, self.ignore_index, self.reduction,
                               self.soft_label, self.axis, self.use_softmax,
                               self.label_smoothing)


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.mse_loss(input, label, self.reduction)


class L1Loss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.l1_loss(input, label, self.reduction)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean", name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction

    def forward(self, input, label):
        return F.nll_loss(input, label, self.weight, self.ignore_index, self.reduction)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):
        return F.binary_cross_entropy(input, label, self.weight, self.reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None, name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(logit, label, self.weight, self.reduction,
                                                  self.pos_weight)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self.reduction = reduction
        self.delta = delta

    def forward(self, input, label):
        return F.smooth_l1_loss(input, label, self.reduction, self.delta)


class KLDivLoss(Layer):
    def __init__(self, reduction="mean", log_target=False):
        super().__init__()
        self.reduction = reduction
        self.log_target = log_target

    def forward(self, input, label):
        return F.kl_div(input, label, self.reduction, self.log_target)


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, other, label):
        return F.margin_ranking_loss(input, other, label, self.margin, self.reduction)


class HingeEmbeddingLoss(Layer):
    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, label):
        return F.hinge_embedding_loss(input, label, self.margin, self.reduction)


class CosineEmbeddingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input1, input2, label):
        return F.cosine_embedding_loss(input1, input2, label, self.margin, self.reduction)


class TripletMarginLoss(Layer):
    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False, reduction="mean",
                 name=None):
        super().__init__()
        self.margin, self.p, self.epsilon, self.swap = margin, p, epsilon, swap
        self.reduction = reduction

    def forward(self, input, positive, negative):
        return F.triplet_margin_loss(input, positive, negative, self.margin, self.p,
                                     self.epsilon, self.swap, self.reduction)


class CTCLoss(Layer):
    """Over :func:`F.ctc_loss` (warp-ctc's semantics: a softmax inside)."""

    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank = blank
        self.reduction = reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths, norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths, self.blank,
                          self.reduction, norm_by_times)


class HSigmoidLoss(Layer):
    """Hierarchical sigmoid over :func:`F.hsigmoid_loss`, owning ``weight
    [num_classes - 1, feature_size]`` and ``bias [num_classes - 1, 1]``
    (``bias_attr=False``: none)."""

    def __init__(self, feature_size, num_classes, weight_attr=None, bias_attr=None,
                 is_custom=False, is_sparse=False, name=None, *, device="cuda",
                 dtype=torch.float32, generator=None):
        super().__init__()
        if num_classes < 2:
            raise ValueError("num_classes must be >= 2")
        self.num_classes = num_classes
        self.is_custom = is_custom
        self.is_sparse = is_sparse
        self.weight = self.create_parameter((num_classes - 1, feature_size), weight_attr,
                                            dtype, device=device, generator=generator)
        self.bias = self.create_parameter((num_classes - 1, 1), bias_attr, dtype, is_bias=True,
                                          device=device, generator=generator)

    def forward(self, input, label, path_table=None, path_code=None):
        return F.hsigmoid_loss(input, label, self.num_classes, self.weight, bias=self.bias,
                               path_table=path_table, path_code=path_code,
                               is_sparse=self.is_sparse)


class PoissonNLLLoss(Layer):
    def __init__(self, log_input=True, full=False, epsilon=1e-8, reduction="mean", name=None):
        super().__init__()
        self.log_input = log_input
        self.full = full
        self.epsilon = epsilon
        self.reduction = reduction

    def forward(self, input, label):
        return F.poisson_nll_loss(input, label, log_input=self.log_input, full=self.full,
                                  epsilon=self.epsilon, reduction=self.reduction)


class RNNTLoss(Layer):
    def __init__(self, blank=0, fastemit_lambda=0.001, reduction="mean", name=None):
        super().__init__()
        self.blank = blank
        self.fastemit_lambda = fastemit_lambda
        self.reduction = reduction

    def forward(self, input, label, input_lengths, label_lengths):
        return F.rnnt_loss(input, label, input_lengths, label_lengths, blank=self.blank,
                           fastemit_lambda=self.fastemit_lambda, reduction=self.reduction)


class MultiLabelSoftMarginLoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):
        return F.multi_label_soft_margin_loss(input, label, weight=self.weight,
                                              reduction=self.reduction)


class TripletMarginWithDistanceLoss(Layer):
    def __init__(self, distance_function=None, margin=1.0, swap=False, reduction="mean",
                 name=None):
        super().__init__()
        self.distance_function = distance_function
        self.margin = margin
        self.swap = swap
        self.reduction = reduction

    def forward(self, input, positive, negative):
        return F.triplet_margin_with_distance_loss(
            input, positive, negative, distance_function=self.distance_function,
            margin=self.margin, swap=self.swap, reduction=self.reduction)


class MultiMarginLoss(Layer):
    def __init__(self, p=1, margin=1.0, weight=None, reduction="mean", name=None):
        super().__init__()
        self.p = p
        self.margin = margin
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):
        return F.multi_margin_loss(input, label, p=self.p, margin=self.margin,
                                   weight=self.weight, reduction=self.reduction)


class SoftMarginLoss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.soft_margin_loss(input, label, reduction=self.reduction)


class GaussianNLLLoss(Layer):
    def __init__(self, full=False, epsilon=1e-6, reduction="mean", name=None):
        super().__init__()
        self.full = full
        self.epsilon = epsilon
        self.reduction = reduction

    def forward(self, input, label, variance):
        return F.gaussian_nll_loss(input, label, variance, full=self.full,
                                   epsilon=self.epsilon, reduction=self.reduction)


class AdaptiveLogSoftmaxWithLoss(Layer):
    """The efficient softmax approximation (Grave et al.) over
    :func:`F.adaptive_log_softmax_with_loss`, owning ``head_weight [in,
    shortlist + clusters]``, ``head_bias`` (with ``head_bias=True``) and per
    cluster ``tail_w1_{i} [in, in // div_value ** (i + 1)]`` and
    ``tail_w2_{i} [.., cluster size]``."""

    def __init__(self, in_features, n_classes, cutoffs, div_value=4.0, head_bias=False,
                 name=None, *, device="cuda", dtype=torch.float32, generator=None):
        super().__init__()
        cutoffs = list(cutoffs)
        if (cutoffs != sorted(cutoffs) or min(cutoffs) <= 0 or max(cutoffs) > n_classes - 1
                or len(set(cutoffs)) != len(cutoffs)):
            raise ValueError("cutoffs must be a sorted list of unique positive integers "
                             "< n_classes - 1")
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.in_features = in_features
        self.n_classes = n_classes
        self.cutoffs = cutoffs + [n_classes]
        self.div_value = div_value
        self.n_clusters = len(self.cutoffs) - 1
        head = cutoffs[0] + self.n_clusters
        self.head_weight = self.create_parameter((in_features, head), **kw)
        self.head_bias = (self.create_parameter((head,), is_bias=True, **kw) if head_bias
                          else None)
        self.tail_weights = []
        for i in range(self.n_clusters):
            hsz = max(1, int(in_features // (div_value ** (i + 1))))
            osz = self.cutoffs[i + 1] - self.cutoffs[i]
            w1 = self.create_parameter((in_features, hsz), **kw)
            w2 = self.create_parameter((hsz, osz), **kw)
            setattr(self, f"tail_w1_{i}", w1)
            setattr(self, f"tail_w2_{i}", w2)
            self.tail_weights.append([w1, w2])

    def forward(self, input, label):
        return F.adaptive_log_softmax_with_loss(input, label, self.head_weight,
                                                self.tail_weights, self.cutoffs[:-1],
                                                head_bias=self.head_bias)

    def log_prob(self, input):
        """The full ``[N, n_classes]`` log-probabilities."""
        flat = [w for pair in self.tail_weights for w in pair]
        input, head_weight, head_bias, *flat = cast_inputs(
            "adaptive_log_softmax_log_prob", input, self.head_weight, self.head_bias, *flat)
        head_lp = _adaptive_head(input, head_weight, head_bias)
        shortlist = self.cutoffs[0]
        parts = [head_lp[:, :shortlist]]
        for i, (w1, w2) in enumerate(zip(flat[0::2], flat[1::2])):
            clp = torch.log_softmax((input @ w1) @ w2, dim=-1)
            parts.append(head_lp[:, shortlist + i:shortlist + i + 1] + clp)
        return torch.cat(parts, dim=-1)

    def predict(self, input):
        return self.log_prob(input).argmax(-1)
