"""Describing a model as stages (counterpart of
``paddle_tpu/distributed/fleet/pp_layers.py:18-95``).

:class:`LayerDesc` builds a layer on demand, :class:`SharedLayerDesc`
builds one layer for a repeated key and hands the same one to every place
that names the key, and :class:`PipelineLayer` builds them all, cuts them
into ``num_stages`` uniform segments (``segment_parts``,
:meth:`PipelineLayer.get_stage_layers`; ``num_stages`` from the
topology's ``pipe`` dim when a topology is given) and runs them in order
as one eager forward, ending in ``loss_fn`` under ``labels=``. The
pipeline's runtime is :class:`~.pipeline_parallel.PipelineParallel`.
"""

from __future__ import annotations

from ...nn.layer.layers import Layer, LayerList

__all__ = ["LayerDesc", "SharedLayerDesc", "PipelineLayer"]


class LayerDesc:
    def __init__(self, layer_cls, *args, **kwargs):
        self.layer_cls = layer_cls
        self.args = args
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_cls(*self.args, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_cls.__name__})"


class SharedLayerDesc(LayerDesc):
    def __init__(self, key, layer_cls, forward_func=None, shared_weight_attr="weight",
                 *args, **kwargs):
        super().__init__(layer_cls, *args, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class PipelineLayer(Layer):
    """``PipelineLayer(layers, num_stages=None, topology=None,
    loss_fn=None, seg_method="uniform", ...)``: see the module docstring."""

    def __init__(self, layers, num_stages=None, topology=None, loss_fn=None,
                 seg_method="uniform", recompute_interval=0, recompute_ctx=None,
                 num_virtual_pipeline_stages=None):
        super().__init__()
        self._layer_descs = list(layers)
        self._topo = topology
        if num_stages is None and topology is not None:
            num_stages = topology.get_dim("pipe")
        self._num_stages = num_stages or 1
        self._loss_fn = loss_fn
        self._shared = {}
        built = []
        for desc in self._layer_descs:
            if isinstance(desc, SharedLayerDesc):
                if desc.layer_name in self._shared:
                    built.append(self._shared[desc.layer_name])
                else:
                    layer = desc.build_layer()
                    self._shared[desc.layer_name] = layer
                    built.append(layer)
            elif isinstance(desc, LayerDesc):
                built.append(desc.build_layer())
            elif isinstance(desc, Layer):
                built.append(desc)
            else:
                raise TypeError(f"unsupported layer desc {desc!r}")
        self.run_function = LayerList(built)
        self._segment()

    def _segment(self):
        """Uniform segments: stage i holds layers ``[parts[i], parts[i + 1])``."""
        n = len(self.run_function)
        P = self._num_stages
        self.segment_parts = [round(i * n / P) for i in range(P + 1)]

    def get_stage_layers(self, stage_id: int):
        lo, hi = self.segment_parts[stage_id], self.segment_parts[stage_id + 1]
        return [self.run_function[i] for i in range(lo, hi)]

    def forward(self, x, **kwargs):
        for layer in self.run_function:
            x = layer(x)
        if self._loss_fn is not None and "labels" in kwargs:
            return self._loss_fn(x, kwargs["labels"])
        return x

    @property
    def num_stages(self):
        return self._num_stages
