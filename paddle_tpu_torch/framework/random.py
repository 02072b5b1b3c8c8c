"""The generators of the op surface (counterpart of
``paddle_tpu/framework/random.py``).

The reference draws from one threefry key chain. Here the port owns one
``torch.Generator`` for the CPU and one for each card, made anew by
:func:`seed`; every drawing op of the surface (creation's random ops,
the initializers, ``create_parameter``) takes the generator of the device
it draws on unless the caller passes ``generator=``. The bits are
torch's (Philox on the card, Mersenne Twister on the CPU), not the
reference's; what holds is that one seed gives one sequence of draws and
that a saved state replays. Before any :func:`seed` the generators start
from seed 0, as the reference's key does. torch's own default generators
are left alone.
"""

from __future__ import annotations

import torch

__all__ = ["seed", "get_rng_state", "set_rng_state", "get_cuda_rng_state",
           "set_cuda_rng_state", "default_generator", "generator_for"]

_seed = 0
_generators: dict = {}           # torch.device -> torch.Generator


def _key(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def default_generator(device) -> torch.Generator:
    """The port's generator of ``device`` (made from the current seed at
    its first use)."""
    dev = _key(device)
    gen = _generators.get(dev)
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(_seed)
        _generators[dev] = gen
    return gen


def generator_for(device, generator=None) -> torch.Generator:
    """``generator`` when given, else the port's generator of ``device``:
    what every drawing function of the port draws from."""
    return generator if generator is not None else default_generator(device)


def seed(s: int) -> torch.Generator:
    """Reseed every generator of the port with ``s`` (the CPU's and each
    card's); returns the CPU generator."""
    global _seed
    _seed = int(s)
    for gen in _generators.values():
        gen.manual_seed(_seed)
    return default_generator("cpu")


def get_rng_state(device=None) -> list:
    """``[state]`` of the generator of ``device`` (None: the default device
    of :mod:`paddle_tpu_torch.device`), a uint8 tensor on the CPU."""
    from ..device import place_device

    return [default_generator(place_device(device)).get_state()]


def set_rng_state(state_list, device=None):
    from ..device import place_device

    state = state_list[0] if isinstance(state_list, (list, tuple)) else state_list
    default_generator(place_device(device)).set_state(state)


def get_cuda_rng_state() -> list:
    """One state a card, in the cards' order."""
    return [default_generator(torch.device("cuda", i)).get_state()
            for i in range(torch.cuda.device_count())]


def set_cuda_rng_state(state_list):
    states = state_list if isinstance(state_list, (list, tuple)) else [state_list]
    for i, state in enumerate(states):
        default_generator(torch.device("cuda", i)).set_state(state)
