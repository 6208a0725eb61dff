"""Learning-rate schedules as plain `step -> lr` functions.

Port of `waveformer_tpu/training/schedules.py` (the reference's
`light_training/utils/lr_scheduler.py:22-222` and
`self_supervised/scheduler.py`), with optax's `linear_schedule`,
`polynomial_schedule`, `cosine_decay_schedule` and `join_schedules`
written out, since optax is not a dependency of the port.

A schedule is read at the update count before the step, as optax reads it:
step 0 uses `schedule(0)`. The trainer sets each step's rate into the
optimizer's param group itself (`param_group["lr"] = schedule(step)`)
rather than through `torch.optim.lr_scheduler`, whose `LambdaLR` counts
one step ahead of that unless it is driven with care.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

Schedule = Callable[[int], float]


def _polynomial(init_value: float, end_value: float, power: float,
                transition_steps: int) -> Schedule:
    """`optax.polynomial_schedule` (transition_begin 0)."""
    if transition_steps <= 0:
        return lambda step: init_value

    def fn(step):
        count = min(max(step, 0), transition_steps)
        frac = 1 - count / transition_steps
        return (init_value - end_value) * frac**power + end_value

    return fn


def _linear(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """`optax.linear_schedule`."""
    return _polynomial(init_value, end_value, 1, transition_steps)


def _cosine_decay(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """`optax.cosine_decay_schedule` (exponent 1)."""
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def fn(step):
        count = min(step, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)

    return fn


def _join(schedules: Sequence[Schedule], boundaries: Sequence[int]) -> Schedule:
    """`optax.join_schedules`: each later schedule counts from its boundary."""

    def fn(step):
        out = schedules[0](step)
        for boundary, schedule in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = schedule(step - boundary)
        return out

    return fn


def constant_schedule(value: float) -> Schedule:
    return lambda step: value


def poly_schedule(initial_lr: float, max_steps: int, exponent: float = 0.9) -> Schedule:
    """nnUNet PolyLR (`utils/lr_scheduler.py:22-38`):
    lr = initial * (1 - step/max_steps) ** exponent."""

    def fn(step):
        frac = 1.0 - min(max(step / max_steps, 0.0), 1.0)
        return initial_lr * frac**exponent

    return fn


def warmup_cosine_schedule(
    initial_lr: float,
    warmup_steps: int,
    total_steps: int,
    cycles: float = 0.5,
    end_value: float = 0.0,
) -> Schedule:
    """`WarmupCosineSchedule` (`self_supervised/scheduler.py`) / HF-style
    cosine-with-warmup (`utils/lr_scheduler.py:104-140`), as
    `optax.warmup_cosine_decay_schedule` from 0."""
    warmup = max(warmup_steps, 1)
    decay = max(total_steps, warmup_steps + 1)
    alpha = 0.0 if initial_lr == 0.0 else end_value / initial_lr
    return _join([_linear(0.0, initial_lr, warmup),
                  _cosine_decay(initial_lr, decay - warmup, alpha)], [warmup])


def polynomial_with_warmup_schedule(
    initial_lr: float,
    warmup_steps: int,
    total_steps: int,
    power: float = 1.0,
    end_lr: float = 1e-7,
) -> Schedule:
    """`get_polynomial_decay_schedule_with_warmup`
    (`utils/lr_scheduler.py:142-198`)."""
    warm = _linear(0.0, initial_lr, max(warmup_steps, 1))
    poly = _polynomial(initial_lr, end_lr, power, max(total_steps - warmup_steps, 1))
    return _join([warm, poly], [warmup_steps])


def constant_with_warmup_schedule(initial_lr: float, warmup_steps: int) -> Schedule:
    """`get_constant_schedule_with_warmup` (`utils/lr_scheduler.py:66-88`)."""
    warm = _linear(0.0, initial_lr, max(warmup_steps, 1))
    return _join([warm, constant_schedule(initial_lr)], [warmup_steps])


def make_schedule(
    name: Optional[str],
    initial_lr: float,
    total_steps: int,
    warmup_steps: int = 0,
) -> Schedule:
    """Scheduler dispatch mirroring `Trainer` (`light_training/trainer.py:370-405`)."""
    if name is None or name == "constant":
        return constant_schedule(initial_lr)
    if name in ("poly_decay", "poly"):
        return poly_schedule(initial_lr, total_steps)
    if name in ("cosine_with_warmup", "warmup_cosine"):
        return warmup_cosine_schedule(initial_lr, warmup_steps, total_steps)
    if name == "poly_with_warmup":
        return polynomial_with_warmup_schedule(initial_lr, warmup_steps, total_steps)
    if name == "constant_with_warmup":
        return constant_with_warmup_schedule(initial_lr, warmup_steps)
    raise ValueError(f"unknown scheduler {name!r}")
