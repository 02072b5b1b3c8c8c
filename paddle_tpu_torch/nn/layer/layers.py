"""The containers (counterpart of ``paddle_tpu/nn/layer/layers.py:334-483``)
over torch's: their state-dict keys (``layers.0.weight``) are the
reference's."""

from __future__ import annotations

import collections

from torch import nn

__all__ = ["LayerList", "Sequential", "Identity"]


class LayerList(nn.ModuleList):
    """``paddle.nn.LayerList``: sublayers named ``"0"``, ``"1"``, ... in
    order (``append``, ``insert``, ``extend``, indexing and slicing as
    ``torch.nn.ModuleList``)."""

    def __init__(self, sublayers=None):
        super().__init__(sublayers)


class Sequential(nn.Sequential):
    """``paddle.nn.Sequential``: sublayers given in order (named ``"0"``,
    ``"1"``, ...), as ``(name, layer)`` pairs, or as one ``OrderedDict``;
    ``forward`` runs them in turn."""

    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0], collections.OrderedDict):
            super().__init__(layers[0])
            return
        super().__init__()
        for i, layer in enumerate(layers):
            if isinstance(layer, tuple):
                self.add_module(layer[0], layer[1])
            else:
                self.add_module(str(i), layer)


class Identity(nn.Module):
    """Returns its input; takes and ignores any arguments."""

    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x
