"""Process-wide settings the port reads (counterpart of the part of
``p2pfl_tpu/config.py`` that the fused round, the wire codec, the learner,
the aggregators and the ledger use).

Same names, defaults, ``P2PFL_TPU_<NAME>`` environment overrides and
fail-fast validation as the JAX package's ``Settings``, so one environment
configures both.
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


def _env_int(name: str, default: int, lo: int, hi: int) -> int:
    """Fail-fast integer env override with a range check."""
    try:
        v = int(_env_override(name, default))
    except ValueError:
        raise ValueError(
            f"P2PFL_TPU_{name}={os.environ.get(f'P2PFL_TPU_{name}')!r} is not an integer"
        ) from None
    if not lo <= v <= hi:
        raise ValueError(f"P2PFL_TPU_{name}={v} must be in [{lo}, {hi}]")
    return v


def _env_float(name: str, default: float, lo: float, hi: float) -> float:
    """Fail-fast float env override with a range check."""
    try:
        v = float(_env_override(name, default))
    except ValueError:
        raise ValueError(
            f"P2PFL_TPU_{name}={os.environ.get(f'P2PFL_TPU_{name}')!r} is not a number"
        ) from None
    if not lo <= v <= hi:
        raise ValueError(f"P2PFL_TPU_{name}={v} must be in [{lo}, {hi}]")
    return v


def _env_choice(name: str, default: str, choices: tuple) -> str:
    """Fail-fast enumerated env override."""
    v = str(_env_override(name, default))
    if v not in choices:
        raise ValueError(f"P2PFL_TPU_{name}={v!r} is not one of {choices}")
    return v


class Settings:
    """Process-wide tunables (the subset the port reads)."""

    # --- transport limits -----------------------------------------------------
    MAX_MESSAGE_BYTES: int = _env_override("MAX_MESSAGE_BYTES", 1 << 30)  # 1 GiB

    # --- wire compression (ops/compression.py, comm/delta.py) -------------------
    # "none" | "bf16" | "int8" | "topk"; sender-local (the codec spec rides in
    # the frame). "topk" is the sparse delta wire path.
    WIRE_COMPRESSION: str = _env_choice("WIRE_COMPRESSION", "none", ("none", "bf16", "int8", "topk"))
    # Fraction of each delta tensor's elements shipped under "topk".
    WIRE_TOPK_RATIO: float = _env_override("WIRE_TOPK_RATIO", 0.1)
    if not 0.0 < WIRE_TOPK_RATIO <= 1.0:
        raise ValueError(f"P2PFL_TPU_WIRE_TOPK_RATIO={WIRE_TOPK_RATIO!r} must be in (0, 1]")
    # Wire dtype of the transmitted top-k values.
    WIRE_TOPK_VALUES: str = _env_choice("WIRE_TOPK_VALUES", "bf16", ("bf16", "float32", "int8", "int4"))
    # Tensors whose top-k keeps fewer values than this ship bf16, not int8/int4.
    QUANT_MIN_VALUES: int = _env_int("QUANT_MIN_VALUES", 16, 1, 1 << 20)
    # Coalesce all sparse tensors of a frame into two byte planes, DEFLATEd at
    # this level (0: off).
    COALESCE_ENABLED: bool = _env_override("COALESCE_ENABLED", True)
    COALESCE_DEFLATE_LEVEL: int = _env_int("COALESCE_DEFLATE_LEVEL", 6, 0, 9)

    # --- buffered async aggregation (learning/aggregators/async_buffer.py) -------
    ASYNC_WINDOW_TIMEOUT: float = _env_float("ASYNC_WINDOW_TIMEOUT", 30.0, 0.1, 3600.0)
    # A lag-l contribution weighs num_samples * (1 + l) ** -alpha.
    ASYNC_STALENESS_ALPHA: float = _env_float("ASYNC_STALENESS_ALPHA", 0.5, 0.0, 16.0)
    # Contributions lagging more windows than this are dropped (0: no limit).
    ASYNC_MAX_STALENESS: int = _env_int("ASYNC_MAX_STALENESS", 10, 0, 1 << 20)

    # --- privacy plane defaults of the learner ------------------------------------
    PRIVACY_DP_CLIP: float = _env_float("PRIVACY_DP_CLIP", 0.0, 0.0, 1e6)
    PRIVACY_DP_SIGMA: float = _env_float("PRIVACY_DP_SIGMA", 0.0, 0.0, 1e3)

    # --- learning round -------------------------------------------------------------
    # Committee size per round (the reference's TRAIN_SET_SIZE).
    TRAIN_SET_SIZE: int = _env_override("TRAIN_SET_SIZE", 4)
    # Hard deadline of Aggregator.wait_and_get_aggregation (seconds).
    AGGREGATION_TIMEOUT: float = _env_override("AGGREGATION_TIMEOUT", 300.0)
    # Aggregate what arrived once nothing advanced the round for this long
    # (seconds; 0 disables).
    AGGREGATION_STALL_PATIENCE: float = _env_float("AGGREGATION_STALL_PATIENCE", 60.0, 0.0, 3600.0)
    # Dtype of training compute; parameters and aggregation stay float32.
    COMPUTE_DTYPE: str = _env_override("COMPUTE_DTYPE", "bfloat16")

    # --- telemetry ------------------------------------------------------------------
    LEDGER_ENABLED: bool = _env_override("LEDGER_ENABLED", True)
    LEDGER_CAPACITY: int = _env_int("LEDGER_CAPACITY", 4096, 16, 1 << 22)

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
