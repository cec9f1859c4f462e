"""Learning-rate schedule (counterpart of
``splatfields_tpu/utils/schedules.py::expon_lr_func``)."""
from __future__ import annotations

import numpy as np


def expon_lr_func(lr_init: float, lr_final: float, lr_delay_steps: int = 0,
                  lr_delay_mult: float = 1.0, max_steps: int = 1000000):
    """Log-linear interpolation from lr_init to lr_final with an optional
    delayed warm-up, continuous in step. Returns a host-side callable
    ``step -> lr`` (a float fed to the optimizer each step)."""

    def helper(step):
        if step < 0 or (lr_init == 0.0 and lr_final == 0.0):
            return 0.0
        if lr_delay_steps > 0:
            delay_rate = lr_delay_mult + (1 - lr_delay_mult) * np.sin(
                0.5 * np.pi * np.clip(step / lr_delay_steps, 0, 1))
        else:
            delay_rate = 1.0
        t = np.clip(step / max_steps, 0, 1)
        log_lerp = np.exp(np.log(lr_init) * (1 - t) + np.log(lr_final) * t)
        return delay_rate * log_lerp

    return helper
