"""Model-parallel RNG states (counterpart of
``paddle_tpu/distributed/fleet/random.py:21-84``).

:class:`RNGStatesTracker` keeps named generator states, each seeded once,
and :meth:`~RNGStatesTracker.rng_state` draws inside its block from one of
them through the port's generator of the default device
(:mod:`paddle_tpu_torch.framework.random`), then restores that generator:
so dropout can differ across tensor-parallel ranks and agree across data
ranks. :func:`model_parallel_random_seed` seeds the port's generators with
the seed every rank shares and the tracker's ``model_parallel_rng`` with
one that differs by tensor-parallel rank.
"""

from __future__ import annotations

import contextlib

import torch

from ...framework import random as _rng

__all__ = ["RNGStatesTracker", "get_rng_state_tracker", "model_parallel_random_seed",
           "MODEL_PARALLEL_RNG"]

MODEL_PARALLEL_RNG = "model_parallel_rng"


def _device():
    from ... import device as _device

    return _device.place_device(None)


class RNGStatesTracker:
    def __init__(self):
        self.states_ = {}
        self.seeds_ = set()

    def reset(self):
        self.states_ = {}
        self.seeds_ = set()

    def add(self, name, seed):
        if seed in self.seeds_:
            raise ValueError(f"seed {seed} already added")
        if name in self.states_:
            raise ValueError(f"state {name} already added")
        self.seeds_.add(seed)
        gen = torch.Generator(device=_device())
        gen.manual_seed(int(seed))
        self.states_[name] = gen.get_state()

    def get_states_tracker(self):
        return dict(self.states_)

    def set_states_tracker(self, states):
        self.states_ = dict(states)

    @contextlib.contextmanager
    def rng_state(self, name=MODEL_PARALLEL_RNG):
        if name not in self.states_:
            raise ValueError(f"state {name} not added")
        orig = _rng.get_rng_state()
        _rng.set_rng_state(self.states_[name])
        try:
            yield
        finally:
            self.states_[name] = _rng.get_rng_state()[0]
            _rng.set_rng_state(orig)


_RNG_STATE_TRACKER = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _RNG_STATE_TRACKER


def model_parallel_random_seed(seed=None):
    """Seed the port's generators with ``seed`` (2718 when None) and the
    tracker's ``model_parallel_rng`` with ``seed + 1024 + mp rank``."""
    from . import fleet as _fleet

    base = 2718 if seed is None else int(seed)
    hcg = _fleet._hcg
    mp_rank = hcg.get_model_parallel_rank() if hcg is not None else 0
    _RNG_STATE_TRACKER.reset()
    _RNG_STATE_TRACKER.add(MODEL_PARALLEL_RNG, base + 1024 + mp_rank)
    _rng.seed(base)
