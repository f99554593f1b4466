"""Privacy accounting for DP-SGD training (a copy of
``p2pfl_tpu/learning/privacy.py``: the standard library only).

Conservative Renyi-DP composition for the Gaussian mechanism (Mironov
2017): each DP-SGD step with noise multiplier sigma is a Gaussian mechanism
with sensitivity equal to the clip norm, whose RDP at order ``alpha`` is
``alpha / (2 sigma^2)``; T steps compose additively and the RDP bound
converts to (epsilon, delta)-DP via
``epsilon = T alpha / (2 sigma^2) + log(1/delta) / (alpha - 1)``. No
privacy amplification by subsampling is claimed, so the epsilon is an upper
bound for any batching scheme.
"""

from __future__ import annotations

import math
import secrets
import warnings
from typing import Optional


def resolve_seed(seed: Optional[int], dp_noise_multiplier: float = 0.0) -> int:
    """Entropy-or-pinned base RNG seed for a trainer.

    ``None`` draws the base from OS entropy, which a DP-SGD epsilon claim
    needs: noise derived from a public seed can be regenerated and
    subtracted. Pinning an int is a reproducibility opt-in; with DP on it
    warns, because the epsilon then holds only while the seed stays secret.
    """
    if seed is None:
        return secrets.randbits(31)
    if dp_noise_multiplier > 0.0:
        warnings.warn(
            "DP-SGD with a pinned seed: the Gaussian noise is recomputable "
            "by anyone who knows the seed, so the reported epsilon only "
            "holds while the seed stays secret. Pass seed=None (default) "
            "for entropy-derived noise.",
            stacklevel=3,
        )
    return int(seed)


def gaussian_rdp_epsilon(noise_multiplier: float, steps: int, delta: float) -> float:
    """(epsilon, delta)-DP bound for ``steps`` composed Gaussian mechanisms,
    at the closed-form optimal order ``alpha* = 1 + sqrt(2 sigma^2
    log(1/delta) / T)``. ``inf`` when ``noise_multiplier <= 0``, ``0`` when
    ``steps == 0``."""
    if steps <= 0:
        return 0.0
    if noise_multiplier <= 0.0:
        return math.inf
    if not (0.0 < delta < 1.0):
        raise ValueError(f"delta must be in (0, 1), got {delta}")
    sigma2 = noise_multiplier**2
    log1d = math.log(1.0 / delta)
    alpha = 1.0 + math.sqrt(2.0 * sigma2 * log1d / steps)
    return steps * alpha / (2.0 * sigma2) + log1d / (alpha - 1.0)


def dp_sgd_privacy_spent(
    noise_multiplier: float,
    clip_norm: float,
    steps: int,
    delta: float = 1e-5,
    nonprivate_steps: int = 0,
) -> dict:
    """Summary dict for a completed DP-SGD run. Any ``nonprivate_steps`` on
    the same released model void the guarantee: epsilon is then ``inf``."""
    eps = gaussian_rdp_epsilon(noise_multiplier, steps, delta)
    if nonprivate_steps > 0:
        eps = math.inf
    return {
        "mechanism": "gaussian-rdp-conservative",
        "noise_multiplier": float(noise_multiplier),
        "clip_norm": float(clip_norm),
        "steps": int(steps),
        "nonprivate_steps": int(nonprivate_steps),
        "delta": float(delta),
        "epsilon": eps,
    }
