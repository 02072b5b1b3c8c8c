"""``ParamAttr`` (counterpart of ``paddle_tpu/nn/param_attr.py``): what a
layer's ``weight_attr`` / ``bias_attr`` says about one parameter."""

from __future__ import annotations

__all__ = ["ParamAttr"]


class ParamAttr:
    """The name, initializer, learning-rate factor (read by the optimizers
    as ``optimize_attr["learning_rate"]``), regularizer, ``trainable``
    (``requires_grad``) and ``need_clip`` of one parameter."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0, regularizer=None,
                 trainable=True, do_model_average=True, need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        """What a layer takes as ``weight_attr`` / ``bias_attr``, as a
        ``ParamAttr``: None (the defaults), a name, an initializer or a
        ``ParamAttr``; ``False`` (no parameter) stays ``False``."""
        if attr is None:
            return ParamAttr()
        if attr is False or isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if callable(attr):
            return ParamAttr(initializer=attr)
        raise TypeError(f"a parameter attribute is None, False, a name, an initializer or a "
                        f"ParamAttr, not {type(attr).__name__}")
