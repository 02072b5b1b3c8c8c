"""Global flag registry (counterpart of ``paddle_tpu/flags.py``).

Paddle's flags (``paddle.set_flags`` / ``paddle.get_flags``, settable with
``FLAGS_<name>`` environment variables) live in a process-global registry
seeded from the environment when each flag is defined, with the
reference's names and defaults. ``set_flags`` takes names with or without
the ``FLAGS_`` prefix; an unknown name raises ``KeyError``.

The port reads one of them so far: ``moe_dispatch``, which forces
``distributed.fleet.moe``'s dispatch ("dense" or "sort"; "" lets the
measured policy choose). The others are defined so that code setting them
runs, and change nothing yet.
"""

from __future__ import annotations

import os
from typing import Any, Callable

__all__ = ["define_flag", "get_flag", "get_flags", "set_flags"]

_REGISTRY: dict[str, "_Flag"] = {}


class _Flag:
    __slots__ = ("name", "value", "default", "help", "_type")

    def __init__(self, name: str, default: Any, help: str, type_: Callable):
        self.name = name
        self.default = default
        self.help = help
        self._type = type_
        env = os.environ.get("FLAGS_" + name)
        self.value = default if env is None else self._parse(env)

    def _parse(self, raw: Any) -> Any:
        if self._type is bool and isinstance(raw, str):
            return raw.lower() in ("1", "true", "yes", "on")
        return self._type(raw)


def define_flag(name: str, default: Any, help: str = "", type_: Callable | None = None):
    """Register a flag (a name already defined keeps its flag); its value
    is ``FLAGS_<name>`` from the environment, parsed as the default's type,
    or the default."""
    if name in _REGISTRY:
        return _REGISTRY[name]
    if type_ is None:
        type_ = type(default) if default is not None else str
    flag = _Flag(name, default, help, type_)
    _REGISTRY[name] = flag
    return flag


def get_flags(names=None) -> dict[str, Any]:
    """``{name: value}`` of every flag, or of ``names`` (a name or a list)."""
    if names is None:
        return {k: f.value for k, f in _REGISTRY.items()}
    if isinstance(names, str):
        names = [names]
    return {n: _REGISTRY[n].value for n in names}


def get_flag(name: str) -> Any:
    return _REGISTRY[name].value


def set_flags(flags: dict[str, Any]) -> None:
    """Set flags by name, with or without the ``FLAGS_`` prefix."""
    for name, value in flags.items():
        if name.startswith("FLAGS_"):
            name = name[len("FLAGS_"):]
        if name not in _REGISTRY:
            raise KeyError(f"unknown flag {name!r}")
        f = _REGISTRY[name]
        f.value = f._parse(value)


define_flag("check_nan_inf", False, "scan op outputs for NaN/Inf (debug)")
define_flag("check_nan_inf_level", 0, "0: fail on nan/inf; >=1: report only")
define_flag("benchmark", False, "block on every op for timing")
define_flag("use_deterministic_ops", False, "ask the compiler for deterministic ops")
define_flag("default_dtype", "float32", "default floating dtype")
define_flag("eager_op_cache", True, "cache per-op executables in eager mode")
define_flag("jit_static_shapes", True, "pad/bucket dynamic dims at jit boundaries")
define_flag("log_level", "WARNING", "framework log level")
define_flag("moe_dispatch", "", "force MoE dispatch path: ''(auto)|dense|sort")
define_flag("train_step_timeout_ms", 0,
            "native watchdog around jitted train steps; 0 disables "
            "(hang detection, as CommTaskManager's timeout)")
