"""ZeRO sharding, stages 1 / 2 / 3 (counterpart of
``paddle_tpu/distributed/fleet/sharding.py:34-121``).

:func:`group_sharded_parallel` shards a model and its optimizer over the
``sharding`` axis of the current mesh (``fleet.init``'s), or over
``group``: level ``"os"`` (stage 1) slices the optimizer state, ``"os_g"``
(stage 2) the gradients too, ``"p_g_os"`` (stage 3) the parameters too.
The cut, each parameter on its own (``distributed._sharded``): stages 1
and 2 the first dim the group's size divides, stage 3 the largest one (a
parameter that no dim of divides stays whole and replicated). It returns
the model and a :class:`GroupShardedOptimizer`, whose ``step()`` (the
eager loop: ``loss.backward(); opt.step(); opt.clear_grad()``) and whose
use by ``TrainStep`` run the same sharded step: reduce over the data
ranks, clip over the whole parameters, one fused update of the slices,
gather. ``DygraphShardingOptimizer`` is stage 1 over fleet's sharding
group. Beside a tensor axis (``parallelize(mp_config=...,
sharding_config=...)``, fleet at ``mp_degree`` beside ``sharding_degree``)
the optimizer wraps the update of ``_sharded.plan_specs``, which keeps
each rank's state on its slice of its tensor slice.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _sharded
from .. import collective as _c
from ..mesh import get_mesh

__all__ = ["GroupShardedOptimizer", "DygraphShardingOptimizer", "group_sharded_parallel",
           "shard_optimizer_state", "save_group_sharded_model", "LEVELS"]

LEVELS = {"os": 1, "os_g": 2, "p_g_os": 3}
#: the mesh axes over which the batch is split
DATA_AXES = ("dcn", "dp", "sharding", "fsdp")


def data_groups(mesh, axis="sharding", group=None):
    """(shard group, replica group, reduce group, data ranks) over
    ``mesh``'s ``axis`` and its data axes, or over ``group`` alone. A
    context axis across processes (``sep``) joins the replica and reduce
    groups but not the divisor: the gradients, partial over it, are summed
    there and averaged over the data ranks."""
    if mesh is None or axis not in getattr(mesh, "dim_names", ()):
        g = _c._resolve(group)
        return g, None, g, g.nranks
    from ..mesh import context_axes

    data = tuple(n for n in mesh.dim_names if n in DATA_AXES)
    ctx = context_axes(mesh)
    rest = tuple(n for n in mesh.dim_names if (n in data and n != axis) or n in ctx)
    shard = mesh.get_group(axis)
    replicas = mesh.get_group(rest) if rest else None
    whole = mesh.get_group(tuple(n for n in mesh.dim_names if n in data or n in ctx))
    return shard, replicas, whole, int(np.prod([mesh.get_dim_size(n) for n in data]))


def plan(params, stage, shard, replicas, whole, divisor, model=None):
    """Cut ``params`` for ``stage`` (see the module docstring) and return
    their :class:`~paddle_tpu_torch.distributed._sharded.ShardedUpdate`;
    stage 3 installs ``model``'s gathers."""
    infos = {}
    for p in params:
        d = _sharded.divisible_dim(tuple(p.shape), shard.nranks, largest=stage == 3)
        if d is None:
            continue
        info = _sharded.ShardInfo(tuple(p.shape), d, shard, replicas, at_rest=stage == 3)
        _sharded.place(p, info)
        infos[id(p)] = info
    if stage == 3:
        _sharded.install_gathers(model, divisor)
    return _sharded.ShardedUpdate(infos, whole, divisor, stage)


class GroupShardedOptimizer:
    """An optimizer over a sharded model: :meth:`step` and
    :meth:`apply_sharded` (``TrainStep``'s) run the sharded step; every
    other attribute is the inner optimizer's."""

    def __init__(self, optimizer, update):
        if getattr(optimizer, "_multi_precision", False):
            raise NotImplementedError("f32 master weights under sharding wait for a later slice "
                                      "of the port")
        self.__dict__["_inner_opt"] = optimizer
        self.__dict__["_update"] = update

    def __getattr__(self, name):
        return getattr(self.__dict__["_inner_opt"], name)

    def __setattr__(self, name, value):
        setattr(self._inner_opt, name, value)

    @property
    def stage(self) -> int:
        return self._update.stage

    def _desc(self):
        from ...nn.clip import clip_descriptor

        desc = clip_descriptor(self._inner_opt._grad_clip)
        if desc is NotImplemented:
            raise TypeError(f"a sharded step clips by global norm, norm or value, not "
                            f"{type(self._inner_opt._grad_clip).__name__}")
        return desc

    @torch.no_grad()
    def step(self):
        opt = self._inner_opt
        opt._step_count += 1
        params, grads, lrs, hypers, clips = [], [], [], [], []
        for group in opt._param_groups:
            lr = group.get("learning_rate", None)
            base = opt.get_lr() if lr is None else float(lr() if callable(lr) else lr)
            wd = group.get("weight_decay", None)
            for p in group["params"]:
                if p.grad is None or not p.requires_grad:
                    continue
                params.append(p)
                grads.append(p.grad)
                lrs.append(opt._lr_of(p, base))
                hypers.append(opt._hyper(opt._resolve_wd(p, wd)))
                clips.append(bool(getattr(p, "need_clip", True)))
        if params:
            self._update.step(type(opt), params, grads, lrs, hypers, clips, self._desc(),
                              opt._step_count)

    def reduce_sharded(self, params, grads):
        """``TrainStep``'s gradients as the sharded update reads them: the
        mean over the data ranks, of the slice where the state is sliced."""
        return self._update._reduce(params, grads)

    def sentinel_parts(self, params: dict) -> tuple:
        """``{name: parameter}``'s parts and cross-rank fold for the
        numerics sentinels (:meth:`ShardedUpdate.sentinel_parts`)."""
        return self._update.sentinel_parts(params)

    def apply_sharded(self, params, grads, reduced: bool = False):
        """``TrainStep``'s update (its step count already advanced): one
        rate and hyperparameter tuple for every parameter, as there;
        ``reduced``: the gradients are :meth:`reduce_sharded`'s."""
        opt = self._inner_opt
        n = len(params)
        self._update.step(type(opt), params, grads, [opt.get_lr()] * n, [opt._hyper()] * n,
                          [True] * n, self._desc(), opt._step_count, reduced=reduced)

    def clear_grad(self, set_to_zero: bool = False):
        self._inner_opt.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    def state_dict(self) -> dict:
        """The inner optimizer's keys with each state's slice."""
        opt = self._inner_opt
        sd = {"_step_count": opt._step_count, "states": {}, "master_weights": {}}
        for i, p in enumerate(opt._parameter_list):
            st = self._update.states.get(id(p))
            if st is not None:
                sd["states"][opt._key(i, p)] = dict(st)
        return sd

    def set_state_dict(self, state_dict):
        opt = self._inner_opt
        opt._step_count = state_dict.get("_step_count", 0)
        for i, p in enumerate(opt._parameter_list):
            got = state_dict.get("states", {}).get(opt._key(i, p))
            if got is not None:
                st = self._update.state_of(type(opt), p)
                for k, v in got.items():
                    st[k].copy_(torch.as_tensor(v))


def DygraphShardingOptimizer(optimizer, hcg=None):
    """Stage 1 over fleet's sharding group (``hcg``, else the current
    mesh's): the optimizer state of each parameter on its slice."""
    from . import fleet as _fleet

    hcg = hcg or _fleet._hcg
    mesh = hcg.build_mesh() if hcg is not None else get_mesh()
    shard, replicas, whole, n = data_groups(mesh)
    return GroupShardedOptimizer(optimizer, plan(optimizer._parameter_list, 1, shard,
                                                 replicas, whole, n))


def group_sharded_parallel(model, optimizer, level="p_g_os", scaler=None, group=None,
                           offload=False, sync_buffers=False, buffer_max_size=2 ** 23,
                           segment_size=2 ** 20, sync_comm=False, dp_group=None,
                           exclude_layer=None):
    """``(model, optimizer[, scaler])`` sharded at ``level`` (see the module
    docstring). The buffers are broadcast from the group's first rank."""
    if level not in LEVELS:
        raise ValueError(f"level {level!r}: one of {sorted(LEVELS)}")
    if offload:
        raise NotImplementedError("offload waits for the port's autopilot module")
    shard, replicas, whole, n = data_groups(get_mesh() if group is None else None,
                                            group=group)
    with torch.no_grad():
        for b in model.buffers():
            _c.broadcast(b, src=whole.ranks[0], group=whole)
    update = plan(model.parameters(), LEVELS[level], shard, replicas, whole, n, model)
    opt = GroupShardedOptimizer(optimizer, update)
    return (model, opt, scaler) if scaler is not None else (model, opt)


def shard_optimizer_state(opt_state_tree, params, mesh, axis="sharding"):
    """``{name: {key: slice}}``: each state tensor of a parameter's shape
    cut, on its first divisible dim, to this rank's slice along ``axis``."""
    if axis not in mesh.dim_names or mesh.get_dim_size(axis) <= 1:
        return opt_state_tree
    group = mesh.get_group(axis)
    out = {}
    for name, state in opt_state_tree.items():
        shape = tuple(params[name].shape)
        d = _sharded.divisible_dim(shape, group.nranks)
        info = _sharded.ShardInfo(shape, d, group, None, at_rest=True)
        out[name] = {k: v[info.index].clone() if torch.is_tensor(v) and tuple(v.shape) == shape
                     and d is not None else v for k, v in state.items()}
    return out


def save_group_sharded_model(model, output, optimizer=None):
    """Rank 0 writes the whole parameters to ``output + ".pdmodel"`` (and
    the optimizer's whole state to ``output + ".pdopt"``); every rank
    takes part in the gathers."""
    from ... import framework
    from .. import env as _env

    state = {k: _sharded.gather_full(v) for k, v in model.state_dict().items()}
    opt_state = None
    if optimizer is not None:
        opt_state = optimizer.state_dict()
        opt_state["states"] = {k: {s: _sharded.gather_full(v) for s, v in st.items()}
                               for k, st in opt_state.get("states", {}).items()}
    if _env.get_rank() == 0:
        framework.io.save(state, output + ".pdmodel")
        if opt_state is not None:
            framework.io.save(opt_state, output + ".pdopt")
