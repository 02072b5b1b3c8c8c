"""The fused optimizer step (counterpart of
``paddle_tpu/optimizer/fused_step.py``): the whole ``Optimizer.step`` as one
multi-tensor update.

The reference compiles its step into one XLA program; the port gathers
every parameter group's (parameter or f32 master, gradient, state,
hyperparameters, learning rate times the parameter's
``optimize_attr["learning_rate"]``) into :class:`~paddle_tpu_torch.ops.
fused_optimizer.Entry` rows, clips each group through the functional clip
layer (the global-norm clip as one scale tensor that the kernel applies to
the gradients with ``need_clip``; the other clips composed first), and
updates every entry in place:

- SGD, Momentum, Adam and AdamW through the hand-written kernel
  (``ops/fused_optimizer.py``), one launch for up to ``MAX_TENSORS``
  tensors (route "kernel");
- Adagrad, RMSProp, Adadelta, Adamax, Lamb and Lars through their composed
  ``update`` on each entry (route "composed"), the function the reference's
  fused program computes for them. The route is fixed by the class.

``run_fused_step`` returns False, and ``step()`` takes its per-parameter
loop, where the reference's does: nothing to update, or a clip callable
that the functional layer cannot express. ``PADDLE_OPT_FUSED=0`` (the
reference's own switch) selects that loop outright. Each step's static
metadata is cached under the reference's key (the optimizer class, each
entry's shapes, dtypes, state layout, hyperparameters and clip flag, and
each group's span and clip), so a changed set of gradients is a miss,
never an error. A kernel that fails to build or launch raises.
"""

from __future__ import annotations

import copy
import os

from ..nn.clip import clip_descriptor, functional_clip_leaves, global_norm_scale

__all__ = ["apply_update", "clear_cache", "clip", "fused_enabled", "run_fused_step", "stats"]

_cache: dict = {}
_stats = {"fused_cache_hits": 0, "fused_cache_misses": 0, "dispatches": 0, "fused_steps": 0,
          "by_route": {"kernel": 0, "composed": 0}}


def fused_enabled() -> bool:
    """The fused regime is on unless ``PADDLE_OPT_FUSED`` is 0, false or
    off (read at every call)."""
    return os.environ.get("PADDLE_OPT_FUSED", "1").lower() not in ("0", "false", "off")


def clear_cache() -> None:
    """Drop every cached step layout."""
    _cache.clear()


def stats() -> dict:
    """Counts since import: ``fused_cache_hits``, ``fused_cache_misses``,
    ``dispatches`` (a fused step is one; the per-parameter loop one per
    parameter), ``fused_steps`` and ``by_route`` (multi-tensor updates by
    route, "kernel" or "composed")."""
    return copy.deepcopy(_stats)


def count_dispatch() -> None:
    """One per-parameter update of the per-parameter loop."""
    _stats["dispatches"] += 1


def clip(desc, grads, need_clip):
    """``(grads, scale)`` for a multi-tensor update under the clip ``desc``
    (``clip_descriptor``): the global-norm clip as its scale tensor, which
    the update applies to the gradients with ``need_clip`` (None when no
    gradient has it); any other clip applied here, scale None."""
    if desc is not None and desc[0] == "global_norm":
        return grads, global_norm_scale(desc[1], grads, need_clip)
    return functional_clip_leaves(desc, grads, need_clip), None


def apply_update(cls, entries, t: int, lay=None):
    """Update ``entries`` in place with optimizer class ``cls`` at step
    ``t``, by the class's route; ``lay`` is the entries' layout on the
    kernel route (None to build it). Returns the layout, None on the
    composed route."""
    from ..ops import fused_optimizer as fo

    if fo.kernel_op(cls) is None:
        _stats["by_route"]["composed"] += 1
        fo.multi_tensor_update_plain(cls, entries, t)
        return None
    _stats["by_route"]["kernel"] += 1
    return fo.multi_tensor_update(cls, entries, t, lay)


def layout_of(cls, entries):
    """The kernel route's layout of ``entries``, None on the composed route."""
    from ..ops import fused_optimizer as fo

    return fo.layout(cls, entries) if fo.kernel_op(cls) is not None else None


def run_fused_step(opt) -> bool:
    """One whole ``opt.step()`` as a multi-tensor update; False when there
    is nothing to update or the clip has no functional form."""
    from ..ops import fused_optimizer as fo

    desc = clip_descriptor(opt._grad_clip)
    entries, sigs, groups = [], [], []
    for group in opt._param_groups:
        params_grads = [(p, p.grad) for p in group["params"]
                        if p.grad is not None and p.requires_grad]
        if not params_grads:
            continue
        if desc is NotImplemented:
            return False
        lr = group.get("learning_rate", None)
        base_lr = opt.get_lr() if lr is None else float(lr() if callable(lr) else lr)
        wd = group.get("weight_decay", None)
        flags = [bool(getattr(p, "need_clip", True)) for p, _ in params_grads]
        grads, scale = clip(desc, [g for _, g in params_grads], flags)
        start = len(entries)
        for (p, _), g, nc in zip(params_grads, grads, flags):
            state = opt._state_of(p)
            master = opt._master_weights.get(id(p))
            e = fo.Entry(param=p.detach() if master is None else master, grad=g, state=state,
                         lr=opt._lr_of(p, base_lr), hyper=opt._hyper(opt._resolve_wd(p, wd)),
                         scale=scale if nc else None,
                         low=None if master is None else p.detach())
            entries.append(e)
            sigs.append(fo.signature(e))
        groups.append((start, len(entries), desc))
    if not entries:
        return False
    cls = type(opt)
    key = (cls, tuple(sigs), tuple(groups))
    if key in _cache:
        _stats["fused_cache_hits"] += 1
    else:
        _stats["fused_cache_misses"] += 1
        _cache[key] = layout_of(cls, entries)
    _stats["dispatches"] += 1
    apply_update(cls, entries, opt._step_count, _cache[key])
    _stats["fused_steps"] += 1
    return True
