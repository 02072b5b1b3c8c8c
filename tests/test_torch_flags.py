"""PyTorch port: the flag registry against the reference's, on the CPU.

The port keeps its own copy of ``paddle_tpu/flags.py``: the same flag
names, defaults and types, ``FLAGS_<name>`` read from the environment when
a flag is defined (parsed as the reference parses it), ``set_flags`` with
and without the prefix, and ``KeyError`` for a name it does not know.
"""

import pytest

import paddle_tpu as paddle
from paddle_tpu import flags as rflags
import paddle_tpu_torch
from paddle_tpu_torch import flags as pflags


def test_names_defaults_and_types_are_the_reference_s():
    want = {n: (f.default, f._type) for n, f in rflags._REGISTRY.items()}
    got = {n: (f.default, f._type) for n, f in pflags._REGISTRY.items()}
    assert got == want
    assert "moe_dispatch" in got
    assert pflags.get_flags() == {n: f.value for n, f in pflags._REGISTRY.items()}


@pytest.mark.parametrize("default,raw", [(False, "1"), (False, "On"), (True, "no"),
                                         (0, "7"), ("", "sort"), (1.5, "0.25")])
def test_the_environment_seeds_a_flag_as_the_reference_parses_it(monkeypatch, default, raw):
    monkeypatch.setenv("FLAGS_torch_flags_probe", raw)
    want = rflags._Flag("torch_flags_probe", default, "", type(default))
    got = pflags._Flag("torch_flags_probe", default, "", type(default))
    assert got.value == want.value and type(got.value) is type(want.value)
    monkeypatch.delenv("FLAGS_torch_flags_probe")
    assert pflags._Flag("torch_flags_probe", default, "", type(default)).value == default


def test_define_flag_registers_once_and_reads_the_environment(monkeypatch):
    monkeypatch.setenv("FLAGS_torch_flags_defined", "12")
    try:
        flag = pflags.define_flag("torch_flags_defined", 3, "a test flag")
        assert flag.value == 12 and pflags.get_flag("torch_flags_defined") == 12
        assert pflags.define_flag("torch_flags_defined", 5) is flag
    finally:
        pflags._REGISTRY.pop("torch_flags_defined", None)


def test_set_flags_with_and_without_the_prefix_and_unknown_names():
    try:
        paddle_tpu_torch.set_flags({"FLAGS_moe_dispatch": "dense"})
        paddle.set_flags({"FLAGS_moe_dispatch": "dense"})
        assert paddle_tpu_torch.get_flags("moe_dispatch") == paddle.get_flags(
            "moe_dispatch") == {"moe_dispatch": "dense"}
        pflags.set_flags({"check_nan_inf": "true", "log_level": "INFO"})
        assert pflags.get_flags(["check_nan_inf", "log_level"]) == {
            "check_nan_inf": True, "log_level": "INFO"}
    finally:
        pflags.set_flags({"moe_dispatch": "", "check_nan_inf": False, "log_level": "WARNING"})
        paddle.set_flags({"moe_dispatch": ""})
    for bad in ({"no_such_flag": 1}, {"FLAGS_no_such_flag": 1}):
        with pytest.raises(KeyError, match="unknown flag 'no_such_flag'"):
            pflags.set_flags(bad)
    with pytest.raises(KeyError):
        pflags.get_flag("no_such_flag")
    assert pflags.get_flag("moe_dispatch") == ""
