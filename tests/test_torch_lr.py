"""PyTorch port: the learning-rate schedulers against the reference's.

Host arithmetic in Python floats on both sides, so each rate must equal the
reference's exactly (tolerance 0) over 30 epochs; a scheduler's state dict
must equal the reference's and, loaded into a fresh scheduler, continue
with the rates of a fresh reference scheduler loaded with it. ``ReduceOnPlateau`` is stepped with a fixed sequence
of metrics (improving, then flat, then improving again) in both modes.
"""

import pytest
import torch

import paddle_tpu.optimizer as ropt
from paddle_tpu_torch import optimizer as popt

EPOCHS = 30

SCHEDULERS = {
    "NoamDecay": lambda lr: lr.NoamDecay(d_model=512, warmup_steps=8, learning_rate=2.0),
    "PiecewiseDecay": lambda lr: lr.PiecewiseDecay([5, 12, 20], [0.1, 0.05, 0.01, 0.001]),
    "NaturalExpDecay": lambda lr: lr.NaturalExpDecay(0.1, gamma=0.15),
    "InverseTimeDecay": lambda lr: lr.InverseTimeDecay(0.1, gamma=0.3),
    "PolynomialDecay": lambda lr: lr.PolynomialDecay(0.1, decay_steps=12, end_lr=0.001,
                                                     power=2.0),
    "PolynomialDecay_cycle": lambda lr: lr.PolynomialDecay(0.1, decay_steps=7, power=1.5,
                                                           cycle=True),
    "ExponentialDecay": lambda lr: lr.ExponentialDecay(0.1, gamma=0.9),
    "MultiStepDecay": lambda lr: lr.MultiStepDecay(0.1, milestones=[4, 9, 21], gamma=0.3),
    "StepDecay": lambda lr: lr.StepDecay(0.1, step_size=4, gamma=0.7),
    "LambdaDecay": lambda lr: lr.LambdaDecay(0.1, lambda e: 0.95 ** e),
    "MultiplicativeDecay": lambda lr: lr.MultiplicativeDecay(0.1, lambda e: 0.9 + 0.001 * e),
    "CosineAnnealingWarmRestarts": lambda lr: lr.CosineAnnealingWarmRestarts(
        0.1, T_0=5, T_mult=2, eta_min=0.001),
    "OneCycleLR": lambda lr: lr.OneCycleLR(0.1, total_steps=25),
    "OneCycleLR_linear": lambda lr: lr.OneCycleLR(0.1, total_steps=25, phase_pct=0.4,
                                                  anneal_strategy="linear"),
    "CyclicLR": lambda lr: lr.CyclicLR(0.01, 0.1, step_size_up=4, step_size_down=6),
    "CyclicLR_triangular2": lambda lr: lr.CyclicLR(0.01, 0.1, step_size_up=3,
                                                   mode="triangular2"),
    "CyclicLR_exp_range": lambda lr: lr.CyclicLR(0.01, 0.1, step_size_up=3, mode="exp_range",
                                                 exp_gamma=0.97),
    "LinearLR": lambda lr: lr.LinearLR(0.1, total_steps=17, start_factor=0.2),
}


def _rates(sched, n):
    out = []
    for _ in range(n):
        out.append(sched())
        sched.step()
    return out


@pytest.mark.parametrize("name", list(SCHEDULERS))
def test_scheduler_matches_reference(name):
    make = SCHEDULERS[name]
    ref, port = make(ropt.lr), make(popt.lr)
    assert _rates(port, EPOCHS) == _rates(ref, EPOCHS)
    port.step(3)
    ref.step(3)
    assert port() == ref()


@pytest.mark.parametrize("name", list(SCHEDULERS))
def test_scheduler_state_dict_round_trip(name):
    make = SCHEDULERS[name]
    ref, port = make(ropt.lr), make(popt.lr)
    _rates(ref, 11)
    _rates(port, 11)
    state = port.state_dict()
    assert state == ref.state_dict()
    fresh, fresh_ref = make(popt.lr), make(ropt.lr)
    fresh.set_state_dict(state)
    fresh_ref.set_state_dict(ref.state_dict())
    assert fresh() == port() == fresh_ref()
    # as in the reference, only public state travels (MultiplicativeDecay's
    # running rate does not), so the loaded one continues as the reference's
    assert _rates(fresh, 10) == _rates(fresh_ref, 10)
    assert _rates(port, 10) == _rates(ref, 10)


METRICS = [5.0, 4.0, 3.5, 3.5, 3.49999, 3.5, 3.6, 3.5, 3.5, 2.0, 2.0, 2.0, 2.0, 2.0, 1.0,
           1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.5]


@pytest.mark.parametrize("kw", [dict(patience=2, factor=0.5),
                                dict(mode="max", patience=1, factor=0.3, cooldown=2,
                                     threshold_mode="abs", threshold=0.1, min_lr=0.01)])
def test_reduce_on_plateau_matches_reference(kw):
    ref = ropt.lr.ReduceOnPlateau(0.1, **kw)
    port = popt.lr.ReduceOnPlateau(0.1, **kw)
    seq_r, seq_p = [], []
    for m in METRICS:
        ref.step(m)
        port.step(torch.tensor(m, dtype=torch.float64))
        seq_r.append((ref(), ref.num_bad_epochs, ref.cooldown_counter, ref.best))
        seq_p.append((port(), port.num_bad_epochs, port.cooldown_counter, port.best))
    assert seq_p == seq_r
    assert len({r[0] for r in seq_r}) > 1   # the rate moved
    port.step()    # no metric: nothing changes
    assert port.last_epoch == len(METRICS)
    assert port.state_dict() == ref.state_dict()
