"""Process-wide settings the port reads (counterpart of the part of
``p2pfl_tpu/config.py`` that the fused round, the wire codec, the
transport, the chaos plane, the learner, the aggregators, the telemetry
plane, the profiler and the wire ``Node`` (its stages, admission, executor,
recovery and logger) use).

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

    # --- transport (comm/grpc/) ----------------------------------------------------
    GRPC_TIMEOUT: float = _env_override("GRPC_TIMEOUT", 10.0)
    USE_SSL: bool = _env_override("USE_SSL", False)
    SSL_SERVER_KEY: str = _env_override("SSL_SERVER_KEY", "")
    SSL_SERVER_CRT: str = _env_override("SSL_SERVER_CRT", "")
    SSL_CLIENT_KEY: str = _env_override("SSL_CLIENT_KEY", "")
    SSL_CLIENT_CRT: str = _env_override("SSL_CLIENT_CRT", "")
    SSL_CA_CRT: str = _env_override("SSL_CA_CRT", "")
    MAX_MESSAGE_BYTES: int = _env_override("MAX_MESSAGE_BYTES", 1 << 30)  # 1 GiB

    # --- membership / failure detection (comm/heartbeater.py) -------------------
    HEARTBEAT_PERIOD: float = _env_override("HEARTBEAT_PERIOD", 2.0)
    HEARTBEAT_TIMEOUT: float = _env_override("HEARTBEAT_TIMEOUT", 5.0)
    WAIT_HEARTBEATS_CONVERGENCE: float = _env_override("WAIT_HEARTBEATS_CONVERGENCE", 4.0)

    # --- gossip (comm/gossiper.py, comm/protocol.py) -----------------------------
    TTL: int = _env_override("TTL", 10)
    GOSSIP_PERIOD: float = _env_override("GOSSIP_PERIOD", 0.1)
    GOSSIP_MESSAGES_PER_PERIOD: int = _env_override("GOSSIP_MESSAGES_PER_PERIOD", 100)
    GOSSIP_MODELS_PERIOD: float = _env_override("GOSSIP_MODELS_PERIOD", 1.0)
    GOSSIP_MODELS_PER_ROUND: int = _env_override("GOSSIP_MODELS_PER_ROUND", 2)
    GOSSIP_EXIT_ON_X_EQUAL_ROUNDS: int = _env_override("GOSSIP_EXIT_ON_X_EQUAL_ROUNDS", 10)
    AMOUNT_LAST_MESSAGES_SAVED: int = _env_override("AMOUNT_LAST_MESSAGES_SAVED", 100)
    # A failed gossip send is retried this many times, backing off from
    # GOSSIP_SEND_BACKOFF seconds (doubling, seeded jitter), before the
    # neighbor is written off and the death callbacks fire.
    GOSSIP_SEND_RETRIES: int = _env_int("GOSSIP_SEND_RETRIES", 2, 0, 16)
    GOSSIP_SEND_BACKOFF: float = _env_float("GOSSIP_SEND_BACKOFF", 0.1, 0.0, 10.0)

    # --- chaos / fault injection (chaos/plane.py) --------------------------------
    # Seeded faults on the transport send path; rates are per-send
    # probabilities, delays seconds. Validated here, at import.
    CHAOS_ENABLED: bool = _env_override("CHAOS_ENABLED", False)
    CHAOS_SEED: int = _env_int("CHAOS_SEED", 0, -(2**63), 2**63 - 1)
    CHAOS_DROP_RATE: float = _env_float("CHAOS_DROP_RATE", 0.0, 0.0, 1.0)
    CHAOS_DELAY_S: float = _env_float("CHAOS_DELAY_S", 0.0, 0.0, 10.0)
    CHAOS_DELAY_JITTER_S: float = _env_float("CHAOS_DELAY_JITTER_S", 0.0, 0.0, 10.0)
    CHAOS_DUPLICATE_RATE: float = _env_float("CHAOS_DUPLICATE_RATE", 0.0, 0.0, 1.0)

    # --- wire admission control (comm/admission.py) -------------------------------
    # Inbound model frames are screened between decode and the aggregator /
    # adoption: structure, NaN/Inf, and an adaptive update-norm bound (median
    # of recently admitted norms x ADMISSION_NORM_MULT; the local model's own
    # norm until enough history exists).
    ADMISSION_ENABLED: bool = _env_override("ADMISSION_ENABLED", True)
    ADMISSION_NORM_MULT: float = _env_float("ADMISSION_NORM_MULT", 5.0, 1.0, 1e6)
    ADMISSION_NORM_WINDOW: int = _env_int("ADMISSION_NORM_WINDOW", 16, 4, 4096)
    # Cap on the wire-supplied (unauthenticated) num_samples claim.
    MAX_CLAIMED_SAMPLES: int = _env_int("MAX_CLAIMED_SAMPLES", 1_000_000, 1, 2**53)

    # --- recovery (stages/recovery.py) ---------------------------------------------
    # Live fraction (self included) of the session's known membership a node
    # needs to make vote/window progress; below it the node parks (0: never).
    RECOVERY_QUORUM_FRACTION: float = _env_float("RECOVERY_QUORUM_FRACTION", 0.0, 0.0, 1.0)
    RECOVERY_PARK_POLL_S: float = _env_float("RECOVERY_PARK_POLL_S", 0.5, 0.05, 60.0)
    # Hard cap on one park (0: park forever).
    RECOVERY_PARK_MAX_S: float = _env_float("RECOVERY_PARK_MAX_S", 300.0, 0.0, 86400.0)
    # Write-ahead node-state journal (management/checkpoint.py): snapshots
    # retained and the cadence in rounds.
    RECOVERY_JOURNAL_KEEP: int = _env_int("RECOVERY_JOURNAL_KEEP", 3, 1, 100)
    RECOVERY_JOURNAL_EVERY: int = _env_int("RECOVERY_JOURNAL_EVERY", 1, 1, 1000)
    # Rounds/windows of lead before the ahead side of a healed split ships its
    # round anchor as a dense catch-up, and the least seconds between reconcile
    # pings to one peer.
    RECOVERY_RECONCILE_MIN_LEAD: int = _env_int("RECOVERY_RECONCILE_MIN_LEAD", 1, 1, 1000)
    RECOVERY_RECONCILE_COOLDOWN_S: float = _env_float("RECOVERY_RECONCILE_COOLDOWN_S", 1.0, 0.0, 3600.0)

    # --- heal detection (comm/protocol.py::_probe_departed) ----------------------
    # The heartbeater's sweep re-probes up to RECOVERY_PROBE_MAX peers that
    # left the table through a failure path.
    RECOVERY_PROBE_ENABLED: bool = _env_override("RECOVERY_PROBE_ENABLED", True)
    RECOVERY_PROBE_MAX: int = _env_int("RECOVERY_PROBE_MAX", 8, 1, 1024)

    # --- engine supervisor (population/supervisor.py) -------------------------------
    # Journal cadence in chunks (engine launches): 1 journals after every chunk.
    SUPERVISOR_JOURNAL_EVERY: int = _env_int("SUPERVISOR_JOURNAL_EVERY", 1, 1, 1000)
    # Retries of a failed chunk (each rolls back to the last journal) before
    # the degrade ladder engages, and the exponential backoff base between
    # them (sleep = base * 2**attempt).
    SUPERVISOR_MAX_RETRIES: int = _env_int("SUPERVISOR_MAX_RETRIES", 3, 0, 100)
    SUPERVISOR_BACKOFF_S: float = _env_float("SUPERVISOR_BACKOFF_S", 0.1, 0.0, 300.0)
    # After the retries: "off" parks; "chunks" halves the chunk toward 1;
    # "cohort" then also halves K down to the plan's min_size before parking.
    SUPERVISOR_DEGRADE: str = _env_choice("SUPERVISOR_DEGRADE", "cohort", ("off", "chunks", "cohort"))

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
    # Train<->diffuse overlap (stages/base_node.py): model diffusion runs on
    # background drain threads while the stage machine goes on to the
    # aggregation wait and the next round's fit; drains left at teardown are
    # joined for at most OVERLAP_DRAIN_JOIN_S seconds.
    OVERLAP_TRAIN_DIFFUSE: bool = _env_override("OVERLAP_TRAIN_DIFFUSE", True)
    OVERLAP_DRAIN_JOIN_S: float = _env_float("OVERLAP_DRAIN_JOIN_S", 5.0, 0.0, 300.0)

    # --- buffered async aggregation (learning/aggregators/async_buffer.py,
    # stages/async_node.py) -----------------------------------------------------
    # A window closes once min(ASYNC_BUFFER_K, countable live peers + 1)
    # distinct contributors are folded, or at ASYNC_WINDOW_TIMEOUT.
    ASYNC_BUFFER_K: int = _env_int("ASYNC_BUFFER_K", 3, 1, 4096)
    ASYNC_WINDOW_TIMEOUT: float = _env_float("ASYNC_WINDOW_TIMEOUT", 30.0, 0.1, 3600.0)
    # A lag-l contribution weighs num_samples * (1 + l) ** -alpha.
    ASYNC_STALENESS_ALPHA: float = _env_float("ASYNC_STALENESS_ALPHA", 0.5, 0.0, 16.0)
    # Contributions lagging more windows than this are dropped (0: no limit).
    ASYNC_MAX_STALENESS: int = _env_int("ASYNC_MAX_STALENESS", 10, 0, 1 << 20)
    # Round anchors the delta codec keeps under async (a lagging peer's frame
    # may be anchored several windows back).
    ASYNC_ANCHOR_HISTORY: int = _env_int("ASYNC_ANCHOR_HISTORY", 4, 1, 64)
    # Peers whose suspect score reaches the gate are not solicited and their
    # contributions dropped; stragglers past theirs are never waited on (0: off).
    ASYNC_SUSPECT_GATE: float = _env_float("ASYNC_SUSPECT_GATE", 1.0, 0.0, 1e9)
    ASYNC_STRAGGLER_GATE: float = _env_float("ASYNC_STRAGGLER_GATE", 2.0, 0.0, 1e9)

    # --- privacy plane (p2pfl_tpu_torch/privacy/) ----------------------------------
    # Committee secure aggregation: pairwise masks (DH key agreement on the
    # gossip wire -> per-(round, pair) PRG streams) that cancel exactly in the
    # integer-lattice sum of the committee's frames.
    PRIVACY_SECAGG: bool = _env_override("PRIVACY_SECAGG", False)
    # Fraction of each delta tensor shipped on masked rounds, on a support
    # shared by the committee (rand-k from public round state: no index bytes).
    PRIVACY_MASK_RATIO: float = _env_float("PRIVACY_MASK_RATIO", 0.1, 1e-6, 1.0)
    # Ring width of the masked lattice (12-bit values pack two per three bytes).
    PRIVACY_RING_BITS: int = _env_int("PRIVACY_RING_BITS", 12, 12, 32)
    if PRIVACY_RING_BITS not in (12, 16, 32):
        raise ValueError(
            f"P2PFL_TPU_PRIVACY_RING_BITS={PRIVACY_RING_BITS} is not one of "
            "(12, 16, 32)"
        )
    # Per-coordinate clamp at the sender before quantization (the lattice
    # scale is RANGE / qmax); what it cuts rides the error-feedback residual.
    PRIVACY_VALUE_RANGE: float = _env_float("PRIVACY_VALUE_RANGE", 0.25, 1e-9, 1e3)
    # Committee-side range check on the unmasked sum: committee * qmax * MULT.
    PRIVACY_RANGE_MULT: float = _env_float("PRIVACY_RANGE_MULT", 1.0, 1.0, 1e6)
    # Largest masked committee (beyond it qmax falls below 1).
    PRIVACY_MAX_COMMITTEE: int = _env_int("PRIVACY_MAX_COMMITTEE", 256, 2, 16384)
    # Bounded wait for the committee's public keys at session start (seconds).
    PRIVACY_KEY_WAIT_S: float = _env_float("PRIVACY_KEY_WAIT_S", 10.0, 0.0, 600.0)
    # DP-SGD defaults of the learner: per-example L2 clip (0: off) and noise.
    PRIVACY_DP_CLIP: float = _env_float("PRIVACY_DP_CLIP", 0.0, 0.0, 1e6)
    PRIVACY_DP_SIGMA: float = _env_float("PRIVACY_DP_SIGMA", 0.0, 0.0, 1e3)
    # Target delta of the reported (epsilon, delta) privacy budget.
    PRIVACY_DELTA: float = _env_float("PRIVACY_DELTA", 1e-5, 1e-12, 0.5)

    # --- learning round -------------------------------------------------------------
    # Committee size per round (the reference's TRAIN_SET_SIZE).
    TRAIN_SET_SIZE: int = _env_override("TRAIN_SET_SIZE", 4)
    # Deadline of the committee vote (seconds).
    VOTE_TIMEOUT: float = _env_override("VOTE_TIMEOUT", 60.0)
    # Hard deadline of Aggregator.wait_and_get_aggregation (seconds).
    AGGREGATION_TIMEOUT: float = _env_override("AGGREGATION_TIMEOUT", 300.0)
    # Aggregate what arrived once nothing advanced the round for this long
    # (seconds; 0 disables).
    AGGREGATION_STALL_PATIENCE: float = _env_float("AGGREGATION_STALL_PATIENCE", 60.0, 0.0, 3600.0)
    # Dtype of training compute; parameters and aggregation stay float32.
    COMPUTE_DTYPE: str = _env_override("COMPUTE_DTYPE", "bfloat16")
    # Disable the native (C++) PFLT frame assembly (native/) and take the
    # byte-identical pure-Python path of ops/serialization.py.
    NO_NATIVE: bool = _env_override("NO_NATIVE", False)

    # --- nodes-mode learner executor (parallel/executor.py) -----------------------
    # Concurrent fit/eval jobs across all in-process nodes (0: inline fits).
    EXECUTOR_MAX_WORKERS: int = _env_override("EXECUTOR_MAX_WORKERS", max(2, min(32, os.cpu_count() or 4)))

    # --- cohort sampling of the wire schedulers (population/cohort.py) --------------
    POP_COHORT_ENABLED: bool = _env_override("POP_COHORT_ENABLED", False)
    POP_COHORT_FRACTION: float = _env_float("POP_COHORT_FRACTION", 1.0, 0.0, 1.0)
    POP_COHORT_MIN: int = _env_int("POP_COHORT_MIN", 1, 1, 1 << 20)
    POP_COHORT_SEED: int = _env_int("POP_COHORT_SEED", 0, 0, 2**31 - 1)
    POP_CHURN_RATE: float = _env_float("POP_CHURN_RATE", 0.0, 0.0, 1.0)
    # Stall patience (seconds) of a population scenario's honest aggregators
    # while an adaptive adversary's frames are rejected.
    CAMPAIGN_STALL_PATIENCE: float = _env_float("CAMPAIGN_STALL_PATIENCE", 2.0, 0.1, 3600.0)

    # --- async population windows (population/async_engine.py, arrivals.py) -------
    # Fill target: FILL_FRACTION of the solicited cohort (>= 1). A window short
    # of it closes "timeout" (TIMEOUT_TICKS virtual ticks); an empty one closes
    # "stall", and solicitation pauses while the pending queue is deeper than
    # STALL_PATIENCE * K. MAX_LAG bounds the anchor history ring and the fold
    # (older contributions are dropped and counted).
    ASYNCPOP_FILL_FRACTION: float = _env_float("ASYNCPOP_FILL_FRACTION", 0.5, 0.0, 1.0)
    ASYNCPOP_TIMEOUT_TICKS: int = _env_int("ASYNCPOP_TIMEOUT_TICKS", 8, 1, 1 << 16)
    ASYNCPOP_STALL_PATIENCE: int = _env_int("ASYNCPOP_STALL_PATIENCE", 4, 1, 1 << 16)
    ASYNCPOP_MAX_LAG: int = _env_int("ASYNCPOP_MAX_LAG", 4, 1, 64)
    # History-ring dtype: float32 for parity, bfloat16 for vnode-ceiling probes.
    ASYNCPOP_STATE_DTYPE: str = _env_choice("ASYNCPOP_STATE_DTYPE", "float32", ("float32", "bfloat16"))
    # Arrival trace of the window stream and its shape: the period in windows
    # (diurnal / regional / flash) and the flash crowd's spike multiple.
    ASYNCPOP_ARRIVAL_TRACE: str = _env_choice(
        "ASYNCPOP_ARRIVAL_TRACE", "uniform", ("uniform", "diurnal", "regional", "flash"))
    ARRIVAL_TRACE_PERIOD: int = _env_int("ARRIVAL_TRACE_PERIOD", 24, 2, 1 << 16)
    ARRIVAL_FLASH_MULT: float = _env_float("ARRIVAL_FLASH_MULT", 10.0, 1.0, 1000.0)

    # --- logging (management/logger.py, management/node_monitor.py) ----------------
    LOG_LEVEL: str = _env_override("LOG_LEVEL", "INFO")
    # Directory of the logger's per-run file (enable_file_logging).
    LOG_DIR: str = _env_override("LOG_DIR", "logs")
    # Seconds between a node's resource samples (0: no monitor).
    RESOURCE_MONITOR_PERIOD: float = _env_override("RESOURCE_MONITOR_PERIOD", 1.0)

    # --- telemetry ------------------------------------------------------------------
    # Health digests ride every DIGEST_EVERY_BEATS-th heartbeat
    # (comm/heartbeater.py); off, the beats stay digest-free.
    DIGEST_ENABLED: bool = _env_override("DIGEST_ENABLED", True)
    DIGEST_EVERY_BEATS: int = _env_int("DIGEST_EVERY_BEATS", 1, 1, 1000)
    # Quantile sketches (telemetry/sketches.py): relative error of every
    # quantile estimate, and the in-memory bucket cap of one sketch.
    SKETCH_REL_ERR: float = _env_float("SKETCH_REL_ERR", 0.02, 0.001, 0.5)
    SKETCH_MAX_BINS: int = _env_int("SKETCH_MAX_BINS", 128, 16, 4096)
    # Observatory bounds (telemetry/observatory.py): peers silent for
    # OBS_PEER_TTL seconds are evicted (0: never); past OBS_MAX_TRACKED live
    # peers new ones fold into merged fleet sketches; gauge refreshes at most
    # every OBS_REFRESH_MIN_S seconds (0: every ingest).
    OBS_PEER_TTL: float = _env_float("OBS_PEER_TTL", 120.0, 0.0, 86400.0)
    OBS_MAX_TRACKED: int = _env_int("OBS_MAX_TRACKED", 512, 8, 1 << 20)
    OBS_REFRESH_MIN_S: float = _env_float("OBS_REFRESH_MIN_S", 0.0, 0.0, 60.0)
    # Flight recorder (telemetry/flight_recorder.py): events kept per node.
    FLIGHTREC_CAPACITY: int = _env_int("FLIGHTREC_CAPACITY", 512, 1, 1 << 20)
    # Span-buffer bound of the process-wide tracer (telemetry/tracing.py).
    TRACE_MAX_SPANS: int = _env_int("TRACE_MAX_SPANS", 65536, 256, 1 << 22)
    LEDGER_ENABLED: bool = _env_override("LEDGER_ENABLED", True)
    LEDGER_CAPACITY: int = _env_int("LEDGER_CAPACITY", 4096, 16, 1 << 22)
    # Recent ledger events riding the observatory snapshot.
    LEDGER_SNAPSHOT_TAIL: int = _env_int("LEDGER_SNAPSHOT_TAIL", 8, 0, 1024)
    # Diagnosis plane (telemetry/bundle.py, telemetry/diagnosis.py): RUN_ID
    # pins the federation-wide run id (empty: minted at engine launch);
    # evidence bundles land under DOCTOR_BUNDLE_DIR unless disabled; findings
    # below DOCTOR_MIN_CONFIDENCE are dropped.
    RUN_ID: str = _env_override("RUN_ID", "")
    DOCTOR_BUNDLE_ENABLED: bool = _env_override("DOCTOR_BUNDLE_ENABLED", True)
    DOCTOR_BUNDLE_DIR: str = _env_override("DOCTOR_BUNDLE_DIR", "artifacts")
    DOCTOR_MIN_CONFIDENCE: float = _env_float("DOCTOR_MIN_CONFIDENCE", 0.5, 0.0, 1.0)
    # Continuous profiling (management/profiler.py): MeshSimulation.run's
    # profile_dir defaults to this directory (empty: no device trace).
    PERF_TRACE_DIR: str = _env_override("PERF_TRACE_DIR", "")

    # --- device observatory of the fused round ------------------------------------------
    # Per-round health flags (a non-finite cohort loss or aggregate; a cohort
    # loss above DEVOBS_LOSS_DIVERGE_MULT times the chunk's best finite one)
    # and update-norm bucket statistics, read once per chunk of
    # rounds_per_call rounds.
    DEVOBS_ENABLED: bool = _env_override("DEVOBS_ENABLED", True)
    # What a trip does at the chunk boundary: "abort" raises; "park" returns
    # the partial result with the trip stamped on it.
    DEVOBS_TRIP_ACTION: str = _env_choice("DEVOBS_TRIP_ACTION", "abort", ("abort", "park"))
    DEVOBS_LOSS_DIVERGE_MULT: float = _env_float("DEVOBS_LOSS_DIVERGE_MULT", 100.0, 1.0, 1e9)
    # Leading timed chunks wrapped in a device_trace_window (0: none).
    DEVOBS_PROFILE_CHUNKS: int = _env_int("DEVOBS_PROFILE_CHUNKS", 1, 0, 1024)
    # TTL of the cached live-tensor byte sum behind device_memory_watermark on
    # the CPU (0: resweep every call).
    DEVOBS_MEM_TTL_S: float = _env_float("DEVOBS_MEM_TTL_S", 5.0, 0.0, 3600.0)
    # Seeded fault injection: the aggregate turns NaN at this absolute round
    # index (-1: off).
    DEVOBS_NAN_INJECT_ROUND: int = _env_int("DEVOBS_NAN_INJECT_ROUND", -1, -1, 1 << 30)

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
