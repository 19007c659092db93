"""Learning-rate schedules: step -> rate functions.

Counterpart of cosyvoice_tpu/train/schedulers.py, covering the reference
policies the shipped recipes use and the NeMo-lineage family. Each policy
returns a function of the update count (an int) to a Python float; the
trainer (train/trainer.py) sets Adam's rate from it before each update, at
the count of updates applied so far (0 on the first, as optax's
scale_by_schedule evaluates it). Resuming is passing the restored count.
The JAX package evaluates these in float32; here they are float64.
"""

import math


def warmup_lr(lr: float, warmup_steps: int = 25000, **_):
    """WarmupLR: lr * w^0.5 * min(s^-0.5, s * w^-1.5), s clamped to >= 1."""

    def sched(step):
        s = max(float(step), 1.0)
        return lr * warmup_steps**0.5 * min(s**-0.5, s * warmup_steps**-1.5)

    return sched


def constant_lr(lr: float, **_):
    return lambda step: float(lr)


def noam_hold_annealing(lr: float, warmup_steps: int = 2500, hold_steps: int = 25000, decay_rate: float = 0.5,
                        min_lr: float = 0.0, **_):
    """NoamHoldAnnealing: linear warmup, hold, then polynomial decay."""

    def sched(step):
        s = max(float(step), 1.0)
        if s <= warmup_steps:
            return lr * s / warmup_steps
        if s <= warmup_steps + hold_steps:
            return float(lr)
        decay_span = max(s - warmup_steps - hold_steps, 1.0)
        return max(lr * (warmup_steps / (warmup_steps + decay_span)) ** decay_rate, min_lr)

    return sched


def _warm(lr, s, warmup_steps):
    return lr * max(s, 1.0) / max(warmup_steps, 1)


def cosine_annealing(lr: float, warmup_steps: int = 0, max_steps: int = 100000, min_lr: float = 0.0, **_):
    def sched(step):
        s = float(step)
        if s < warmup_steps:
            return _warm(lr, s, warmup_steps)
        progress = min(max((s - warmup_steps) / max(max_steps - warmup_steps, 1), 0.0), 1.0)
        return min_lr + 0.5 * (lr - min_lr) * (1 + math.cos(math.pi * progress))

    return sched


def _power_annealing(power: float):
    def policy(lr: float, warmup_steps: int = 0, max_steps: int = 100000, min_lr: float = 0.0, **_):
        def sched(step):
            s = float(step)
            if warmup_steps > 0 and s <= warmup_steps:
                return _warm(lr, s, warmup_steps)
            frac = max(max_steps - min(s, float(max_steps)), 0.0) / max(max_steps, 1)
            return max(lr * frac**power, min_lr)

        return sched

    return policy


square_annealing = _power_annealing(2.0)  # SquareAnnealing: warmup then (1 - p)^2 decay
squareroot_annealing = _power_annealing(0.5)  # SquareRootAnnealing: warmup then (1 - p)^0.5 decay


def noam_annealing(lr: float, d_model: int = 512, warmup_steps: int = 0, min_lr: float = 0.0, **_):
    """NoamAnnealing: lr * d^-0.5 * min(s^-0.5, s * w^-1.5)."""

    def sched(step):
        s = max(float(step), 1.0)
        norm = d_model**-0.5
        mult = norm * (min(s**-0.5, s * warmup_steps**-1.5) if warmup_steps > 0 else s**-0.5)
        out = lr * mult
        return max(out, min_lr) if s > warmup_steps else out

    return sched


def polynomial_decay(lr: float, decay_steps: int = 100000, power: float = 1.0, min_lr: float = 0.0,
                     cycle: bool = False, warmup_steps: int = 0, **_):
    """PolynomialDecayAnnealing."""

    def sched(step):
        s0 = float(step)
        if warmup_steps > 0 and s0 <= warmup_steps:
            return _warm(lr, s0, warmup_steps)
        s = s0 - warmup_steps
        d = float(decay_steps)
        if cycle:
            d = d * max(1.0, math.ceil(s / d))
        else:
            s = min(s, d)
        return (lr - min_lr) * min(max(1.0 - s / d, 0.0), 1.0) ** power + min_lr

    return sched


def warmup_annealing(lr: float, warmup_steps: int = 0, max_steps: int = 100000, min_lr: float = 0.0, **_):
    """Linear warmup, then linear decay to min_lr at max_steps."""

    def sched(step):
        s = float(step)
        if warmup_steps > 0 and s <= warmup_steps:
            return _warm(lr, s, warmup_steps)
        frac = min(max((max_steps - s) / max(max_steps - warmup_steps, 1), 0.0), 1.0)
        return (lr - min_lr) * frac + min_lr

    return sched


def linear_warmup_cosine_annealing(lr: float, warmup_steps: int = 0, decay_steps: int = 100000,
                                   min_lr: float = 0.0, **_):
    """Linear warmup, then cosine decay over decay_steps, then min_lr."""

    def sched(step):
        s = float(step)
        if warmup_steps > 0 and s <= warmup_steps:
            return lr * s / max(warmup_steps, 1)
        if s > warmup_steps + decay_steps:
            return float(min_lr)
        ratio = min(max((s - warmup_steps) / max(decay_steps, 1), 0.0), 1.0)
        return min_lr + 0.5 * (math.cos(math.pi * ratio) + 1.0) * (lr - min_lr)

    return sched


def squareroot_constant(lr: float, constant_steps: int = 0, min_lr: float = 0.0, **_):
    """SquareRootConstantPolicy: lr, then lr / sqrt(s) after constant_steps."""

    def sched(step):
        s = max(float(step), 1.0)
        return float(lr) if s <= constant_steps else max(lr / s**0.5, min_lr)

    return sched


def warmup_cosine_decay(init_value: float, peak_value: float, warmup_steps: int, decay_steps: int,
                        end_value: float = 0.0):
    """optax.warmup_cosine_decay_schedule (exponent 1): linear from
    init_value to peak_value over warmup_steps, then a cosine from
    peak_value to end_value over decay_steps - warmup_steps, then
    end_value. The HiFT generator's pretrain schedule (bin/train.py)."""
    if not decay_steps - warmup_steps > 0:
        raise ValueError(f"warmup_cosine_decay needs decay_steps > warmup_steps, got {decay_steps}, {warmup_steps}")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    span = float(decay_steps - warmup_steps)

    def sched(step):
        if step < warmup_steps:
            frac = 1.0 - min(max(float(step), 0.0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        count = min(float(step - warmup_steps), span)
        return peak_value * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * count / span)) + alpha)

    return sched


SCHEDULERS = {
    "warmuplr": warmup_lr,
    "constantlr": constant_lr,
    "NoamHoldAnnealing": noam_hold_annealing,
    "cosine_annealing": cosine_annealing,
    "SquareAnnealing": square_annealing,
    "SquareRootAnnealing": squareroot_annealing,
    "NoamAnnealing": noam_annealing,
    "PolynomialDecayAnnealing": polynomial_decay,
    "WarmupAnnealing": warmup_annealing,
    "linear_warmup_cosine_annealing": linear_warmup_cosine_annealing,
    "SquareRootConstantPolicy": squareroot_constant,
}


def get_scheduler(name: str, lr: float, **conf):
    if name not in SCHEDULERS:
        raise ValueError(f"unknown scheduler {name}; available: {list(SCHEDULERS)}")
    return SCHEDULERS[name](lr, **conf)
