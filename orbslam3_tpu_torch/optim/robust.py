"""Robust weighting + chi2 gates shared by the solvers."""
from __future__ import annotations

import torch

# chi2 95% quantiles
CHI2_MONO = 5.991  # 2 dof
CHI2_STEREO = 7.815  # 3 dof


def huber_weight(chi2, delta2):
    """Huber IRLS weight for squared error chi2 with squared threshold delta2."""
    return torch.where(chi2 <= delta2, torch.ones_like(chi2),
                       torch.sqrt(delta2 / torch.clamp(chi2, min=1e-12)))


def octave_sigma2_inv(octave, scale=1.2):
    """Per-observation information scale: 1 / scale^(2*octave)."""
    base = torch.tensor(scale, dtype=torch.float32, device=octave.device)
    return 1.0 / torch.pow(base, 2.0 * octave.to(torch.float32))


def chi2_gate(ur):
    """delta^2 per observation: stereo (ur >= 0) or mono."""
    return torch.where(ur >= 0, torch.full_like(ur, CHI2_STEREO), torch.full_like(ur, CHI2_MONO))
