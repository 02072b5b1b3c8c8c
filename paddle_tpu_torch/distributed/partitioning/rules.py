"""The logical-axis rule table (counterpart of
``paddle_tpu/distributed/partitioning/rules.py:1-161``).

Every weight dim of the model zoo carries a logical axis name ("vocab",
"embed", "heads", "mlp", ...), and one ordered table maps the names onto
the mesh's axes (``dp``, ``fsdp``, ``tensor``, ``pipe``). Resolution is
first match wins; two rules binding one name to different axes, or two
dims of one tensor landing on one mesh axis, raise
:class:`RuleConflictError` naming the rules. The port keeps its own copy
of the table. A resolved placement is a :class:`PartitionSpec`: one entry
a dim, None (replicated), an axis name, or a tuple of names.
"""

from __future__ import annotations

__all__ = ["DEFAULT_RULES", "PartitionSpec", "RuleConflictError", "RuleTable",
           "validate_rules", "mark_logical"]


class PartitionSpec(tuple):
    """One placement a dim: None, a mesh axis, or a tuple of mesh axes."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return "PartitionSpec(" + ", ".join(repr(p) for p in self) + ")"


#: The default catalog:
#:   batch  - activation batch dim over both data axes (dp x fsdp)
#:   seq    - sequence dim, replicated
#:   vocab  - embedding / head vocab dim -> tensor
#:   embed  - the hidden dim -> fsdp (the ZeRO-3 shard axis)
#:   heads  - attention heads dim -> tensor
#:   kv     - GQA key/value heads dim -> tensor
#:   mlp    - FFN intermediate dim -> tensor
#:   norm   - norm scales, replicated
#:   expert - MoE expert dim -> tensor
#:   stage  - pipeline stage dim -> pipe
DEFAULT_RULES = (
    ("batch", ("dp", "fsdp")),
    ("seq", None),
    ("vocab", "tensor"),
    ("embed", "fsdp"),
    ("heads", "tensor"),
    ("kv", "tensor"),
    ("mlp", "tensor"),
    ("norm", None),
    ("expert", "tensor"),
    ("stage", "pipe"),
)


class RuleConflictError(ValueError):
    """Two rules (or two resolved dims) clash; the message names them."""


def _norm_axes(axis) -> tuple:
    if axis is None:
        return ()
    if isinstance(axis, (list, tuple)):
        return tuple(str(a) for a in axis)
    return (str(axis),)


def validate_rules(rules) -> None:
    """Raise naming both rules when one logical name is bound to two
    different placements (first match wins would hide the second)."""
    seen: dict = {}
    for i, (name, axis) in enumerate(rules):
        axes = _norm_axes(axis)
        if name in seen and seen[name][1] != axes:
            j = seen[name][0]
            raise RuleConflictError(
                f"rule {i} ({name!r} -> {axis!r}) conflicts with rule {j} ({name!r} -> "
                f"{rules[j][1]!r}): one logical axis bound to two different mesh "
                "placements; remove one")
        seen.setdefault(name, (i, axes))


class RuleTable:
    """Ordered ``(logical name, axis | (axes...) | None)`` rules and their
    resolution against a mesh."""

    def __init__(self, rules=DEFAULT_RULES):
        rules = tuple((str(n), a) for n, a in rules)
        validate_rules(rules)
        self.rules = rules
        self._lookup: dict = {}
        for name, axis in rules:
            self._lookup.setdefault(name, _norm_axes(axis))

    def mesh_axes(self, logical_name: str) -> tuple:
        """The mesh axes of one logical name; an unknown name raises."""
        if logical_name not in self._lookup:
            raise KeyError(f"logical axis {logical_name!r} has no rule (known: "
                           f"{sorted(self._lookup)})")
        return self._lookup[logical_name]

    def spec(self, logical_axes, shape=None, mesh=None) -> PartitionSpec:
        """The :class:`PartitionSpec` of per-dim logical names: with
        ``mesh``, only its axes above size 1 are kept; with ``shape``, an
        axis that does not divide its dim is dropped (replicated); two dims
        on one mesh axis raise."""
        used: dict = {}
        out = []
        for dim, name in enumerate(logical_axes):
            if name is None:
                out.append(None)
                continue
            kept, size = [], 1
            for ax in self.mesh_axes(str(name)):
                if mesh is not None:
                    if ax not in mesh.dim_names or mesh.get_dim_size(ax) <= 1:
                        continue
                    ax_size = mesh.get_dim_size(ax)
                else:
                    ax_size = 1
                if shape is not None and ax_size > 1 and int(shape[dim]) % (size * ax_size):
                    continue
                if ax in used:
                    odim, oname = used[ax]
                    raise RuleConflictError(
                        f"rule ({name!r} -> {ax!r}) on dim {dim} clashes with rule "
                        f"({oname!r} -> {ax!r}) on dim {odim}: both dims of logical shape "
                        f"{tuple(logical_axes)} resolve onto mesh axis {ax!r}")
                used[ax] = (dim, name)
                kept.append(ax)
                size *= ax_size
            out.append(None if not kept else kept[0] if len(kept) == 1 else tuple(kept))
        return PartitionSpec(*out)

    def describe(self) -> list:
        """The rules, ready for JSON (the sharding manifest)."""
        return [[n, list(a) if isinstance(a, (list, tuple)) else a] for n, a in self.rules]


def mark_logical(param, logical_axes):
    """Give ``param`` its per-dim logical axis names (``logical_axes``),
    which :meth:`Partitioner.param_spec` reads."""
    if param is not None:
        param.logical_axes = tuple(None if a is None else str(a) for a in logical_axes)
    return param
