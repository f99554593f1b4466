"""Mergeable, wire-encodable distribution summaries for population scale
(the port's copy of ``p2pfl_tpu/telemetry/sketches.py``: the host sketches
as they are, :func:`device_bucket_stats` in torch).

A plain observability plane reports raw scalars: a digest
carries *the latest* step time, *the mean* window lag. That shape is O(fleet)
in two places — every observer keeps one table row per peer, and any fleet
statistic beyond an argmax needs every peer's raw stream. At 10k virtual
nodes (ROADMAP item 3) neither survives. The classical fix is sketches:
constant-size summaries that (a) answer quantile/cardinality queries with a
bounded error, and (b) MERGE — ``summary(A ∪ B) = merge(summary(A),
summary(B))`` — so fleet views compose from gossiped per-node summaries
without a coordinator ever seeing raw data. Papaya (arxiv 2111.04877) runs
population-scale monitoring on exactly this shape.

Two sketches, both versioned-wire-encodable (compact JSON-able dicts that
ride inside the health digest):

* :class:`QuantileSketch` — a DDSketch-style relative-error quantile sketch
  (Masson et al., VLDB 2019): logarithmic buckets ``index(x) =
  ceil(log_gamma(x))`` with ``gamma = (1+a)/(1-a)`` guarantee every
  quantile estimate is within relative error ``a`` of the true value, and
  merging is plain per-bucket count addition (associative, commutative).
  Memory is bounded by ``max_bins`` — lowest buckets collapse together, so
  upper quantiles (the p90/p99 an operator actually reads) keep their
  guarantee no matter how many values were folded. ~O(log range) buckets
  regardless of population.
* :class:`DistinctEstimator` — a HyperLogLog distinct counter (fixed
  register array, ~1.04/sqrt(m) relative error). Merge is element-wise
  register max, which makes re-merging the same estimator IDEMPOTENT —
  gossip may deliver a digest many times without inflating the count.

:class:`SketchRegistry` (module-global :data:`SKETCHES`) is the process-wide
home mirroring the metrics registry's shape: hot paths call
``SKETCHES.observe(name, node, value)``; digest collection reads a bounded
wire form; benches/tests ``reset()`` between runs. Counters need no sketch —
they are already merge-associative (addition) — so fleet counter merging
stays in the observatory.
"""

from __future__ import annotations

import base64
import hashlib
import math
import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

#: Bump when a sketch wire format changes incompatibly. Decoders ignore
#: unknown-version payloads (the digest degrades to sketch-free, never dies).
SKETCH_WIRE_VERSION = 1

#: The standard sketch names the digest carries (telemetry call sites feed
#: these; anything else is caller-defined and travels just as well).
STANDARD_SKETCHES = ("step_time", "staleness", "update_norm", "agg_wait")

#: Values with magnitude below this are counted as zero (a log-bucketed
#: sketch cannot index 0; step times / lags / norms at true 0 are common).
_MIN_TRACKED = 1e-9

#: Value range the ON-DEVICE bucket window covers (device observatory):
#: update norms / losses below LO clip into the bottom bucket, above HI
#: into the top one. The window is a trace-time constant — the aux output
#: of a compiled scan must be static-shape.
DEVICE_BUCKET_LO = 1e-6
DEVICE_BUCKET_HI = 1e3


def device_bucket_spec(rel_err: Optional[float] = None) -> Tuple[float, int, int]:
    """``(gamma_log, lo_idx, nbins)`` of the static on-device DDSketch
    bucket window: the same ``index(x) = ceil(log(x)/gamma_log)`` rule the
    host sketches use, restricted to ``[DEVICE_BUCKET_LO, DEVICE_BUCKET_HI]``
    so a compiled scan can emit a fixed-length bucket-count vector per
    round. Host side, :meth:`QuantileSketch.fold_device_buckets` folds the
    counts back losslessly (same gamma) or through bucket midpoints."""
    if rel_err is None:
        from p2pfl_tpu_torch.config import Settings

        rel_err = Settings.SKETCH_REL_ERR
    gamma_log = math.log((1.0 + rel_err) / (1.0 - rel_err))
    lo = int(math.ceil(math.log(DEVICE_BUCKET_LO) / gamma_log))
    hi = int(math.ceil(math.log(DEVICE_BUCKET_HI) / gamma_log))
    return gamma_log, lo, hi - lo + 1


def device_bucket_stats(
    values: Any, *, gamma_log: float, lo_idx: int, nbins: int
) -> Dict[str, Any]:
    """Bucket statistics of ``|values|`` for the device observatory,
    computed where the tensor lives and without a host synchronisation (no
    ``.item()``, no boolean-mask indexing: masks go through
    ``torch.where``, the counts through ``scatter_add_``).

    Returns static-shape tensors on the input's device: ``counts`` ([nbins]
    int32 DDSketch bucket counts, window-clipped), ``zeros`` (int32: values
    below the sketch zero floor), and exact f32 ``sum`` / ``min`` / ``max``
    over the finite non-zero magnitudes (inf/-inf when none). Non-finite
    values contribute to NOTHING here — the NaN tripwire flags them
    separately. The bucket index is the JAX package's,
    ``ceil(log(max(v, 1e-9)) / f32(gamma_log)) - lo_idx`` clipped to the
    window, in f32."""
    import torch

    v = torch.as_tensor(values).detach().to(torch.float32).reshape(-1).abs()
    finite = torch.isfinite(v)
    zero = finite & (v < _MIN_TRACKED)
    pos = finite & (v >= _MIN_TRACKED)
    # A fill launched on the device, not a copy from the host (which waits
    # for the card); a device divisor, not a host scalar (which the card
    # would turn into a multiply by its reciprocal, off the JAX package's bits).
    gamma = torch.full((), gamma_log, dtype=torch.float32, device=v.device)
    idx = torch.clamp(
        torch.ceil(torch.log(torch.clamp(v, min=_MIN_TRACKED)) / gamma).to(torch.int32) - lo_idx,
        0,
        nbins - 1,
    ).long()
    counts = torch.zeros(nbins, dtype=torch.int32, device=v.device).scatter_add_(0, idx, pos.to(torch.int32))
    return {
        "counts": counts,
        "zeros": zero.sum(dtype=torch.int32),
        "sum": torch.where(pos, v, torch.zeros_like(v)).sum(),
        "min": torch.where(pos, v, torch.full_like(v, math.inf)).amin(),
        "max": torch.where(pos, v, torch.full_like(v, -math.inf)).amax(),
    }


class QuantileSketch:
    """Relative-error quantile sketch over a stream of floats.

    Args:
        rel_err: guaranteed relative accuracy ``a`` of quantile estimates
            (bucket ``i`` spans ``(gamma^(i-1), gamma^i]`` with ``gamma =
            (1+a)/(1-a)``; reporting the bucket midpoint keeps every value
            in it within ``a`` relatively).
        max_bins: memory bound. Past it the LOWEST buckets collapse into one
            another (DDSketch's collapsing strategy), trading accuracy at
            the bottom of the distribution for a hard size cap — upper
            quantiles keep the guarantee.

    Negative values are supported through a mirrored store (update-norm
    deltas etc.); exact ``count/sum/min/max`` ride along for free.
    """

    __slots__ = (
        "rel_err", "max_bins", "_gamma_log", "_bins", "_neg",
        "zero_count", "count", "sum", "min", "max",
    )

    def __init__(self, rel_err: float = 0.02, max_bins: int = 128) -> None:
        if not 0.0 < rel_err < 1.0:
            raise ValueError(f"rel_err must be in (0, 1), got {rel_err}")
        if max_bins < 8:
            raise ValueError(f"max_bins must be >= 8, got {max_bins}")
        self.rel_err = float(rel_err)
        self.max_bins = int(max_bins)
        self._gamma_log = math.log((1.0 + rel_err) / (1.0 - rel_err))
        self._bins: Dict[int, float] = {}  # positive values
        self._neg: Dict[int, float] = {}  # sketch of -x for x < 0
        self.zero_count = 0.0
        self.count = 0.0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    # --- feeding -------------------------------------------------------------

    def _index(self, x: float) -> int:
        return int(math.ceil(math.log(x) / self._gamma_log))

    def _value(self, index: int) -> float:
        # Bucket midpoint 2*gamma^i / (gamma + 1): within rel_err of every
        # value the bucket covers.
        gamma = math.exp(self._gamma_log)
        return 2.0 * gamma ** index / (gamma + 1.0)

    def add(self, value: float, n: float = 1.0) -> None:
        v = float(value)
        if not math.isfinite(v) or n <= 0:
            return
        self.count += n
        self.sum += v * n
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        if abs(v) < _MIN_TRACKED:
            self.zero_count += n
        elif v > 0:
            i = self._index(v)
            self._bins[i] = self._bins.get(i, 0.0) + n
        else:
            i = self._index(-v)
            self._neg[i] = self._neg.get(i, 0.0) + n
        if len(self._bins) > self.max_bins or len(self._neg) > self.max_bins:
            self._collapse()

    def add_many(self, values: Iterable[float]) -> None:
        """Vectorized fold of an array (the fused-mesh path: 10k per-node
        stats per metric fold in one numpy pass, not 10k Python adds)."""
        arr = np.asarray(list(values) if not isinstance(values, np.ndarray) else values, np.float64).ravel()
        arr = arr[np.isfinite(arr)]
        if arr.size == 0:
            return
        self.count += float(arr.size)
        self.sum += float(arr.sum())
        self.min = min(self.min, float(arr.min()))
        self.max = max(self.max, float(arr.max()))
        zeros = np.abs(arr) < _MIN_TRACKED
        self.zero_count += float(zeros.sum())
        for store, vals in (
            (self._bins, arr[(~zeros) & (arr > 0)]),
            (self._neg, -arr[(~zeros) & (arr < 0)]),
        ):
            if vals.size == 0:
                continue
            idx = np.ceil(np.log(vals) / self._gamma_log).astype(np.int64)
            uniq, counts = np.unique(idx, return_counts=True)
            for i, c in zip(uniq.tolist(), counts.tolist()):
                store[i] = store.get(i, 0.0) + float(c)
        if len(self._bins) > self.max_bins or len(self._neg) > self.max_bins:
            self._collapse()

    def fold_device_buckets(
        self,
        gamma_log: float,
        lo_idx: int,
        counts: Any,
        *,
        zeros: float = 0.0,
        vsum: Optional[float] = None,
        vmin: Optional[float] = None,
        vmax: Optional[float] = None,
    ) -> None:
        """Fold an on-device bucket-count vector (:func:`device_bucket_stats`)
        into this sketch. Bucket ``j`` of ``counts`` holds the mass at
        absolute DDSketch index ``lo_idx + j`` under ``gamma_log``; each
        non-empty bucket re-folds through its midpoint at THIS sketch's
        accuracy (a no-op re-index when the gammas match, i.e. before any
        collapse). Exact ``vsum/vmin/vmax`` from the device ride along when
        given; otherwise the midpoints approximate them."""
        arr = np.asarray(counts, np.float64).ravel()
        nz = np.nonzero(arr > 0)[0]
        zeros = max(0.0, float(zeros))
        total = float(arr[nz].sum()) + zeros
        if total <= 0:
            return
        gl = float(gamma_log)
        mids = 2.0 * np.exp(gl * (lo_idx + nz)) / (math.exp(gl) + 1.0)
        self.count += total
        if vsum is not None and math.isfinite(float(vsum)):
            self.sum += float(vsum)
        else:
            self.sum += float((mids * arr[nz]).sum())
        if zeros > 0:
            self.zero_count += zeros
            self.min = min(self.min, 0.0)
            self.max = max(self.max, 0.0)
        if nz.size:
            lo_v = float(vmin) if vmin is not None and math.isfinite(float(vmin)) else float(mids.min())
            hi_v = float(vmax) if vmax is not None and math.isfinite(float(vmax)) else float(mids.max())
            self.min = min(self.min, lo_v)
            self.max = max(self.max, hi_v)
            for m, c in zip(mids.tolist(), arr[nz].tolist()):
                i = self._index(m)
                self._bins[i] = self._bins.get(i, 0.0) + float(c)
        if len(self._bins) > self.max_bins or len(self._neg) > self.max_bins:
            self._collapse()

    def _collapse(self) -> None:
        """Halve the resolution until within ``max_bins``: re-bucket every
        index ``i -> ceil(i/2)`` under ``gamma^2``. Bucket ``i`` covers
        ``(gamma^(i-1), gamma^i]``, so both ``2j-1`` and ``2j`` land inside
        the coarse ``(gamma^(2j-2), gamma^(2j)]`` — the sketch stays a valid
        DDSketch at the doubled gamma, and the accuracy loss is UNIFORM
        across the range (``rel_err`` is updated to the new guarantee)
        instead of sacrificing whole quantile ranges the way a lowest-bin
        rollup would under a tight wire cap.
        """
        while len(self._bins) > self.max_bins or len(self._neg) > self.max_bins:
            self._gamma_log *= 2.0
            g = math.exp(self._gamma_log)
            self.rel_err = (g - 1.0) / (g + 1.0)
            for attr in ("_bins", "_neg"):
                old = getattr(self, attr)
                coarse: Dict[int, float] = {}
                for i, c in old.items():
                    j = -((-i) // 2)  # ceil(i/2), exact for negative ints too
                    coarse[j] = coarse.get(j, 0.0) + c
                setattr(self, attr, coarse)

    # --- querying ------------------------------------------------------------

    def quantile(self, q: float) -> float:
        """Estimated ``q``-quantile (``0 <= q <= 1``); NaN when empty.

        Walk order: most-negative buckets first, then zero, then positive
        ascending. Estimates clamp into the exact observed ``[min, max]``.
        """
        if self.count <= 0:
            return float("nan")
        q = min(1.0, max(0.0, float(q)))
        if q == 0.0:
            return self.min
        if q == 1.0:
            return self.max
        rank = q * (self.count - 1.0)
        seen = 0.0
        for i in sorted(self._neg, reverse=True):  # most negative first
            seen += self._neg[i]
            if seen > rank:
                return max(self.min, min(self.max, -self._value(i)))
        seen += self.zero_count
        if seen > rank:
            return max(self.min, min(self.max, 0.0))
        for i in sorted(self._bins):
            seen += self._bins[i]
            if seen > rank:
                return max(self.min, min(self.max, self._value(i)))
        return self.max

    def quantiles(self, qs: Iterable[float] = (0.5, 0.9, 0.99)) -> Dict[str, float]:
        return {f"p{int(round(q * 100))}": self.quantile(q) for q in qs}

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count > 0 else float("nan")

    # --- merging -------------------------------------------------------------

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Return a NEW sketch summarizing both streams.

        Same-accuracy sketches merge by per-bucket count addition —
        associative and commutative by construction. A different-accuracy
        peer (version skew) degrades gracefully: its buckets re-fold through
        their midpoints at THIS sketch's accuracy.
        """
        out = self.copy()
        out.merge_in(other)
        return out

    def merge_in(self, other: "QuantileSketch") -> None:
        if other.count <= 0:
            return
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        self.zero_count += other.zero_count
        same = abs(other.rel_err - self.rel_err) < 1e-12
        for mine, theirs, sign in ((self._bins, other._bins, 1.0), (self._neg, other._neg, -1.0)):
            for i, c in theirs.items():
                j = i if same else self._index(other._value(i))
                mine[j] = mine.get(j, 0.0) + c
        if len(self._bins) > self.max_bins or len(self._neg) > self.max_bins:
            self._collapse()

    def copy(self) -> "QuantileSketch":
        out = QuantileSketch(self.rel_err, self.max_bins)
        out._bins = dict(self._bins)
        out._neg = dict(self._neg)
        out.zero_count = self.zero_count
        out.count = self.count
        out.sum = self.sum
        out.min = self.min
        out.max = self.max
        return out

    # --- wire codec ----------------------------------------------------------

    def to_wire(self, max_bins: Optional[int] = None) -> Dict[str, Any]:
        """Compact JSON-able form. ``max_bins`` bounds the WIRE size below
        the in-memory bound (digests must stay beat-cheap)."""
        src = self
        if max_bins is not None and (
            len(self._bins) > max_bins or len(self._neg) > max_bins
        ):
            src = self.copy()
            src.max_bins = int(max_bins)
            src._collapse()

        def enc(store: Dict[int, float]) -> List[List[float]]:
            return [
                [i, int(c) if float(c).is_integer() else round(c, 3)]
                for i, c in sorted(store.items())
            ]

        wire: Dict[str, Any] = {
            "v": SKETCH_WIRE_VERSION,
            "e": src.rel_err,
            "c": int(src.count) if float(src.count).is_integer() else src.count,
            "s": round(src.sum, 9),
            "b": enc(src._bins),
        }
        if src._neg:
            wire["g"] = enc(src._neg)
        if src.zero_count:
            wire["z"] = int(src.zero_count)
        if src.count > 0:
            wire["lo"] = src.min
            wire["hi"] = src.max
        return wire

    @classmethod
    def from_wire(cls, wire: Any) -> Optional["QuantileSketch"]:
        """Best-effort decode; ``None`` for malformed/unknown payloads."""
        if not isinstance(wire, dict):
            return None
        try:
            if int(wire.get("v", 0)) != SKETCH_WIRE_VERSION:
                return None
            out = cls(rel_err=float(wire.get("e", 0.02)))
            for key, store in (("b", out._bins), ("g", out._neg)):
                for pair in wire.get(key, ()):
                    i, c = int(pair[0]), float(pair[1])
                    if not math.isfinite(c) or c < 0:
                        return None  # hostile: NaN/Inf/negative bucket mass
                    if c > 0:
                        store[i] = store.get(i, 0.0) + c
            out.zero_count = max(0.0, float(wire.get("z", 0.0)))
            out.count = max(0.0, float(wire.get("c", 0.0)))
            out.sum = float(wire.get("s", 0.0))
            out.min = float(wire.get("lo", math.inf))
            out.max = float(wire.get("hi", -math.inf))
        except (TypeError, ValueError, IndexError, OverflowError):
            return None
        # Internal consistency: the bucket mass must not exceed the claimed
        # count (a hostile digest must not fabricate quantile weight). The
        # tolerance absorbs the wire's per-bucket count rounding.
        mass = sum(out._bins.values()) + sum(out._neg.values()) + out.zero_count
        if out.count < mass - 1.0 or not math.isfinite(out.count):
            return None
        return out


class DistinctEstimator:
    """HyperLogLog distinct counter with fixed-size registers.

    ``m`` registers give ~``1.04/sqrt(m)`` relative error (m=128: ~9%) in
    ``m`` bytes of state. :meth:`merge` is element-wise max — idempotent
    (``merge(a, a) == a``), which is what lets gossip re-deliver digests
    without double counting contributors.
    """

    __slots__ = ("m", "_registers")

    def __init__(self, m: int = 128) -> None:
        if m < 16 or m & (m - 1):
            raise ValueError(f"m must be a power of two >= 16, got {m}")
        self.m = m
        self._registers = bytearray(m)

    def add(self, item: str) -> None:
        h = int.from_bytes(
            hashlib.blake2b(item.encode("utf-8"), digest_size=8).digest(), "big"
        )
        p = self.m.bit_length() - 1
        j = h & (self.m - 1)
        w = h >> p
        # Rank of the first set bit in the remaining 64-p bits (1-based).
        rank = (64 - p) - w.bit_length() + 1
        if rank > self._registers[j]:
            self._registers[j] = rank

    def estimate(self) -> float:
        m = self.m
        raw = (_hll_alpha(m) * m * m) / sum(2.0 ** -r for r in self._registers)
        zeros = self._registers.count(0)
        if raw <= 2.5 * m and zeros:  # small-range linear counting
            return m * math.log(m / zeros)
        return raw

    def merge(self, other: "DistinctEstimator") -> "DistinctEstimator":
        out = DistinctEstimator(self.m)
        out._registers = bytearray(self._registers)
        out.merge_in(other)
        return out

    def merge_in(self, other: "DistinctEstimator") -> None:
        if other.m != self.m:  # version skew: fold through the estimate
            for i in range(int(round(other.estimate()))):
                self.add(f"~skew~{i}")
            return
        for j, r in enumerate(other._registers):
            if r > self._registers[j]:
                self._registers[j] = r

    def to_wire(self) -> str:
        return base64.b64encode(bytes(self._registers)).decode("ascii")

    @classmethod
    def from_wire(cls, wire: Any) -> Optional["DistinctEstimator"]:
        if not isinstance(wire, str):
            return None
        try:
            raw = base64.b64decode(wire.encode("ascii"), validate=True)
        except (ValueError, UnicodeEncodeError):
            return None
        m = len(raw)
        if m < 16 or m & (m - 1) or any(b > 64 for b in raw):
            return None
        out = cls(m)
        out._registers = bytearray(raw)
        return out


def _hll_alpha(m: int) -> float:
    if m == 16:
        return 0.673
    if m == 32:
        return 0.697
    if m == 64:
        return 0.709
    return 0.7213 / (1.0 + 1.079 / m)


class SketchRegistry:
    """Process-wide (name, node) -> sketch table, mirroring the metrics
    registry's shape: one registry serves every in-process node; hot paths
    observe, digest collection reads a bounded wire form, harnesses reset.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._quantiles: Dict[Tuple[str, str], QuantileSketch] = {}
        self._distinct: Dict[str, DistinctEstimator] = {}

    def observe(self, name: str, node: str, value: float) -> None:
        """Fold one value into the (name, node) quantile sketch. Never
        raises — observability must not break the observed path."""
        try:
            from p2pfl_tpu_torch.config import Settings

            key = (name, node)
            with self._lock:
                sk = self._quantiles.get(key)
                if sk is None:
                    sk = QuantileSketch(
                        rel_err=Settings.SKETCH_REL_ERR,
                        max_bins=Settings.SKETCH_MAX_BINS,
                    )
                    self._quantiles[key] = sk
                sk.add(value)
        except Exception:  # noqa: BLE001
            pass

    def fold_buckets(
        self,
        name: str,
        node: str,
        gamma_log: float,
        lo_idx: int,
        counts: Any,
        *,
        zeros: float = 0.0,
        vsum: Optional[float] = None,
        vmin: Optional[float] = None,
        vmax: Optional[float] = None,
    ) -> None:
        """Fold an on-device bucket-count vector into the (name, node)
        sketch — the device observatory's per-chunk entry point. Never
        raises."""
        try:
            from p2pfl_tpu_torch.config import Settings

            key = (name, node)
            with self._lock:
                sk = self._quantiles.get(key)
                if sk is None:
                    sk = QuantileSketch(
                        rel_err=Settings.SKETCH_REL_ERR,
                        max_bins=Settings.SKETCH_MAX_BINS,
                    )
                    self._quantiles[key] = sk
                sk.fold_device_buckets(
                    gamma_log, lo_idx, counts,
                    zeros=zeros, vsum=vsum, vmin=vmin, vmax=vmax,
                )
        except Exception:  # noqa: BLE001
            pass

    def distinct_add(self, node: str, item: str) -> None:
        """Fold one contributor identity into ``node``'s distinct counter."""
        try:
            with self._lock:
                est = self._distinct.get(node)
                if est is None:
                    est = DistinctEstimator()
                    self._distinct[node] = est
                est.add(item)
        except Exception:  # noqa: BLE001
            pass

    def get(self, name: str, node: str) -> Optional[QuantileSketch]:
        with self._lock:
            sk = self._quantiles.get((name, node))
            return sk.copy() if sk is not None else None

    def get_distinct(self, node: str) -> Optional[DistinctEstimator]:
        with self._lock:
            est = self._distinct.get(node)
            if est is None:
                return None
            out = DistinctEstimator(est.m)
            out._registers = bytearray(est._registers)
            return out

    def wire_for(self, node: str, max_bins: int = 48) -> Dict[str, Any]:
        """All of ``node``'s sketches in wire form (bin count bounded for
        the digest), plus the distinct counter under ``"__distinct__"``."""
        out: Dict[str, Any] = {}
        with self._lock:
            items = [
                (name, sk) for (name, n), sk in self._quantiles.items() if n == node
            ]
            est = self._distinct.get(node)
            est_wire = est.to_wire() if est is not None else None
        for name, sk in items:
            if sk.count > 0:
                out[name] = sk.to_wire(max_bins=max_bins)
        if est_wire is not None:
            out["__distinct__"] = est_wire
        return out

    def names(self) -> List[Tuple[str, str]]:
        with self._lock:
            return sorted(self._quantiles)

    def reset(self) -> None:
        with self._lock:
            self._quantiles.clear()
            self._distinct.clear()


#: The process-wide sketch registry every subsystem observes into.
SKETCHES = SketchRegistry()


__all__ = [
    "DEVICE_BUCKET_HI",
    "DEVICE_BUCKET_LO",
    "DistinctEstimator",
    "QuantileSketch",
    "SKETCHES",
    "SKETCH_WIRE_VERSION",
    "STANDARD_SKETCHES",
    "SketchRegistry",
    "device_bucket_spec",
    "device_bucket_stats",
]
