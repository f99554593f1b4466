"""Process-wide settings the port reads (counterpart of the part of
``p2pfl_tpu/config.py`` that the fused round uses).

Same names, defaults and ``P2PFL_TPU_<NAME>`` environment overrides as the
JAX package's ``Settings``, so one environment configures both.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Iterator

import torch


def _env_override(name: str, default: Any) -> Any:
    raw = os.environ.get(f"P2PFL_TPU_{name}")
    if raw is None:
        return default
    if isinstance(default, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    return raw


class Settings:
    """Process-wide tunables (the subset the port reads)."""

    # Committee size per round (the reference's TRAIN_SET_SIZE).
    TRAIN_SET_SIZE: int = _env_override("TRAIN_SET_SIZE", 4)
    # Dtype of training compute; parameters and aggregation stay float32.
    COMPUTE_DTYPE: str = _env_override("COMPUTE_DTYPE", "bfloat16")

    @classmethod
    def snapshot(cls) -> dict[str, Any]:
        """Copy of all current settings (upper-case attributes only)."""
        return {k: getattr(cls, k) for k in dir(cls) if k.isupper()}

    @classmethod
    def restore(cls, snap: dict[str, Any]) -> None:
        for k, v in snap.items():
            setattr(cls, k, v)

    @classmethod
    @contextlib.contextmanager
    def overridden(cls, **kwargs: Any) -> Iterator[None]:
        """Scoped settings override (mainly for tests)."""
        snap = cls.snapshot()
        try:
            for k, v in kwargs.items():
                if k not in snap:
                    raise AttributeError(f"unknown setting {k!r}")
                setattr(cls, k, v)
            yield
        finally:
            cls.restore(snap)


def compute_dtype() -> torch.dtype:
    """``Settings.COMPUTE_DTYPE`` as a torch dtype (``"bfloat16"`` ->
    ``torch.bfloat16``); raises ``ValueError`` for a name torch lacks."""
    dtype = getattr(torch, str(Settings.COMPUTE_DTYPE), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"COMPUTE_DTYPE {Settings.COMPUTE_DTYPE!r} is not a torch dtype")
    return dtype
