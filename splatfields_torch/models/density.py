"""SDF -> volume-density transfer functions (counterpart of
``splatfields_tpu/models/density.py``; the reference's
``scene/tripFields.py:18-55``).

Imported by the reference's ``utils/time_utils.py`` but built by no
released configuration; the learnable scalars are ``nn.Parameter``s
named as the flax params (``beta``, ``lamb``, ``gamma``), so
``interop`` carries them both ways.
"""
from __future__ import annotations

import torch
import torch.nn as nn


class LaplaceDensity(nn.Module):
    """density(sdf) = (1/beta) Laplace(0, beta).cdf(-sdf), beta = |beta
    param| + beta_min."""

    def __init__(self, beta_init: float = 0.1, beta_min: float = 1e-4):
        super().__init__()
        self.beta_min = beta_min
        self.beta = nn.Parameter(torch.tensor(beta_init, dtype=torch.float32))

    def get_beta(self) -> torch.Tensor:
        return self.beta.abs() + self.beta_min

    def inv_s(self) -> torch.Tensor:
        return 1.0 / self.get_beta()

    def forward(self, sdf: torch.Tensor, beta=None) -> torch.Tensor:
        if beta is None:
            beta = self.get_beta()
        alpha = 1.0 / beta
        # 0.5 + 0.5 sign(x) expm1(-|x| / beta): the Laplace cdf at -sdf
        return alpha * (0.5 + 0.5 * torch.sign(sdf)
                        * torch.expm1(-sdf.abs() / beta))


class BellDensity(nn.Module):
    """density(sdf) = gamma e^(-lamb sdf) / (1 + e^(-lamb sdf))^2, the
    derivative-of-sigmoid bell."""

    def __init__(self):
        super().__init__()
        self.lamb = nn.Parameter(torch.tensor(1.0))
        self.gamma = nn.Parameter(torch.tensor(1.0))

    def inv_s(self) -> torch.Tensor:
        return self.lamb

    def forward(self, sdf: torch.Tensor, beta=None) -> torch.Tensor:
        arg = torch.exp(-self.lamb * sdf)
        return self.gamma * arg / torch.square(1.0 + arg)
