"""Sparse delta wire path: round-anchored deltas + error-feedback top-k
(counterpart of ``p2pfl_tpu/comm/delta.py``; frames byte-compatible).

With ``Settings.WIRE_COMPRESSION = "topk"`` a node ships ``params -
round_anchor`` instead of raw weights: only the ``WIRE_TOPK_RATIO``
largest-magnitude elements of each delta tensor (sorted indices, gap-packed,
plus bf16 / f32 / int8 / int4 values), the untransmitted remainder and the
value rounding error accumulating in a per-node error-feedback residual that
is added back before the next selection (DGC, Lin et al. 2018; EF-SGD,
Karimireddy et al. 2019). The receiver reconstructs against ITS anchor
through :func:`p2pfl_tpu_torch.ops.aggregation.sparse_delta_apply`.

The anchor and the residuals live on the codec's device (the card by
default) as flat f32 tensors, and selection, quantization and the
reconstruction's scatter-add run there (:mod:`p2pfl_tpu_torch.ops.compression`);
index packing, the byte planes and their DEFLATE run on the host, as in the
JAX package. Leaves are the JAX package's canonical leaves
(``ModelHandle.get_parameters()``), so the frames are the reference's:
self-describing through the ``__codec__`` spec, a ``__delta__`` marker with
the anchor round and fingerprint, and optionally coalesced byte planes
(``__coalesce__``). Anchors match BY ROUND (a fingerprint mismatch is only
logged); a frame for a round without an anchor raises
:class:`DeltaAnchorError`. Every structural fact a hostile frame controls
is validated before the first value is dequantized or scattered, with the
reference's error types and reasons.
"""

from __future__ import annotations

import logging
import threading
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.device import DeviceLike, resolve_device
from p2pfl_tpu_torch.exceptions import DecodingParamsError, DeltaAnchorError
from p2pfl_tpu_torch.ops.aggregation import sparse_delta_apply
from p2pfl_tpu_torch.ops.compression import (
    CODEC_META_KEY,
    as_tensor,
    bf16_round,
    decompress_arrays,
    ef_topk_encode,
    ef_topk_quant_encode,
    numpy_dtype_str,
    pack_nibbles,
    topk_count,
    topk_select,
    torch_dtype,
    unpack_nibbles,
)
from p2pfl_tpu_torch.ops.serialization import (
    decode_sparse_indices,
    deserialize_arrays,
    encode_sparse_indices,
    serialize_arrays,
)
from p2pfl_tpu_torch.privacy.secagg import MASKED_META_KEY
from p2pfl_tpu_torch.telemetry import REGISTRY, tracing

log = logging.getLogger("p2pfl_tpu_torch")

#: Reserved metadata key marking a frame as a round-anchored sparse delta.
DELTA_META_KEY = "__delta__"

#: Reserved metadata key describing a coalesced multi-tensor frame body: all
#: sparse tensors ride TWO shared byte planes (concatenated packed indices,
#: concatenated packed values — each optionally DEFLATEd); per-tensor byte
#: extents live in the ``__codec__`` spec (``topk-c`` entries).
COALESCE_META_KEY = "__coalesce__"

#: Codec labels (telemetry + TX attribution).
CODEC_LABELS = ("topk", "topk-int8", "topk-int4", "dense", "masked")

_COMPRESSION_RATIO = REGISTRY.gauge(
    "p2pfl_wire_compression_ratio",
    "Dense float32 bytes over sparse frame bytes for the last encoded "
    "frame, by value codec (topk = bf16/f32 values)",
    labels=("node", "codec"),
)
_RESIDUAL_L2 = REGISTRY.gauge(
    "p2pfl_wire_residual_l2",
    "L2 norm of the error-feedback residual after the last encode",
    labels=("node",),
)
_SPARSE_FRAMES = REGISTRY.counter(
    "p2pfl_wire_sparse_frames_total",
    "Sparse delta frames encoded",
    labels=("node",),
)
_DENSE_FALLBACK = REGISTRY.counter(
    "p2pfl_wire_dense_fallback_total",
    "encode_model calls that fell back to the dense path",
    labels=("node",),
)


def _leaf_crc(leaves: Sequence[torch.Tensor]) -> int:
    """Fingerprint of a float32 leaf list (observability, not an acceptance
    gate): the JAX package's, over the same bytes."""
    crc = 0
    for a in leaves:
        crc = zlib.crc32(a.detach().float().cpu().numpy().tobytes(), crc)
    return crc


def codec_label(value_dtype: Optional[str] = None) -> str:
    """Telemetry/TX codec label for the active sparse value dtype."""
    vd = Settings.WIRE_TOPK_VALUES if value_dtype is None else value_dtype
    return {"int8": "topk-int8", "int4": "topk-int4"}.get(vd, "topk")


def _deflate_plane(raw: bytes, level: int) -> Tuple[bytes, bool]:
    """DEFLATE one coalesced byte plane; returns (bytes, deflated?). Skipped
    when it would not shrink."""
    if level <= 0 or not raw:
        return raw, False
    packed = zlib.compress(raw, level)
    return (packed, True) if len(packed) < len(raw) else (raw, False)


def _inflate_plane(blob: bytes, raw_len: int) -> bytes:
    """Bounded INFLATE of a coalesced plane: a hostile frame cannot expand
    past its declared length (zip-bomb guard) or under-deliver silently."""
    if raw_len < 0 or raw_len > Settings.MAX_MESSAGE_BYTES:
        raise DecodingParamsError("coalesced plane length out of bounds")
    d = zlib.decompressobj()
    out = d.decompress(bytes(blob), raw_len)
    if len(out) != raw_len or d.decompress(b"", 1):
        raise DecodingParamsError("coalesced plane length mismatch")
    return out


def _host_bytes(t: torch.Tensor) -> bytes:
    t = t.detach().contiguous().cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()


def _encode_values(vals: torch.Tensor, value_dtype: str) -> Tuple[bytes, Dict[str, Any]]:
    """Pack selected (or already-quantized) wire values into raw bytes plus
    the spec fields a receiver needs to invert them."""
    if value_dtype == "int4":
        return pack_nibbles(vals).tobytes(), {"values": "int4"}
    if value_dtype == "int8":
        return _host_bytes(vals.to(torch.int8)), {"values": "int8"}
    if value_dtype == "float32":
        return _host_bytes(vals.float()), {"values": "float32"}
    return _host_bytes(bf16_round(vals)), {"values": "bf16"}


def _decode_values(buf: bytes, entry: Dict[str, Any], count: int) -> np.ndarray:
    """Invert :func:`_encode_values` (host f32 values) with the
    pre-dequantize sanity checks: scale/zero-point finiteness and
    integer-range bounds are validated BEFORE any arithmetic touches the
    anchor."""
    kind = entry.get("values", "bf16")
    if kind in ("int8", "int4"):
        scale = entry.get("scale")
        zp = entry.get("zero_point", 0)
        if (
            not isinstance(scale, (int, float))
            or not np.isfinite(scale)
            or not scale > 0
            or not isinstance(zp, (int, float))
            or not np.isfinite(zp)
        ):
            raise DecodingParamsError("quantized tensor has a hostile scale/zero-point")
        qmax = 127 if kind == "int8" else 7
        if abs(float(zp)) > qmax:
            raise DecodingParamsError("quantized zero-point outside the int range")
        if kind == "int4":
            q = unpack_nibbles(np.frombuffer(buf, np.uint8), count)
        else:
            if len(buf) < count:
                raise DecodingParamsError("int8 value plane shorter than declared")
            q = np.frombuffer(buf[:count], np.int8)
            if (np.abs(q.astype(np.int16)) > qmax).any():
                raise DecodingParamsError("int8 value outside the symmetric grid")
        return (q.astype(np.float32) - np.float32(zp)) * np.float32(scale)
    if kind == "float32":
        if len(buf) < 4 * count:
            raise DecodingParamsError("float32 value plane shorter than declared")
        return np.frombuffer(buf[: 4 * count], np.float32).copy()
    if kind == "bf16":
        if len(buf) < 2 * count:
            raise DecodingParamsError("bf16 value plane shorter than declared")
        bits = torch.from_numpy(np.frombuffer(buf[: 2 * count], np.int16).copy())
        return bits.view(torch.bfloat16).float().numpy()
    raise DecodingParamsError(f"unknown value codec {kind!r}")


class DeltaWireCodec:
    """Per-node sparse-delta encode/decode state.

    Owns the round anchor (set at every round boundary) and the
    error-feedback residuals (persistent across rounds), both as flat f32
    tensors on ``device`` (default the card; raises when none is visible).
    Thread-safe: encode and decode may run on different threads.
    """

    def __init__(self, self_addr: str = "unknown-node", device: DeviceLike = "cuda") -> None:
        self._addr = self_addr
        self.device = resolve_device(device)
        self._lock = threading.RLock()
        self._anchor: Optional[List[torch.Tensor]] = None  # float32 flat leaves
        self._shapes: Optional[List[tuple]] = None
        self._anchor_round: int = -1
        self._anchor_crc: int = 0
        self._residual: Optional[List[torch.Tensor]] = None  # float32 flat
        #: How many anchors are kept: the current one plus ``anchor_history -
        #: 1`` retired rounds (async windows let lagging peers' frames decode).
        self.anchor_history: int = 1
        self._history: Dict[int, Tuple[List[torch.Tensor], List[tuple], int]] = {}
        self.sparse_frames = 0
        self.dense_fallback_frames = 0

    def _flat(self, leaf: Any) -> torch.Tensor:
        return as_tensor(leaf, device=self.device, dtype=torch.float32).reshape(-1).contiguous()

    # --- anchor bookkeeping ---------------------------------------------------

    def set_anchor(self, leaves: Sequence[Any], round: int) -> None:
        """Snapshot the round-start model (float32). Residuals persist across
        rounds unless the model structure changed."""
        flat = [self._flat(a) for a in leaves]
        shapes = [tuple(a.shape) for a in leaves]
        with self._lock:
            if self._residual is not None and (
                self._shapes is None
                or [f.numel() for f in flat] != [int(np.prod(s, dtype=np.int64)) for s in self._shapes]
            ):
                self._residual = None
            # Retire the outgoing anchor into the history ring.
            if self._anchor is not None and self._anchor_round != int(round):
                self._history[self._anchor_round] = (self._anchor, self._shapes, self._anchor_crc)
            self._anchor = flat
            self._shapes = shapes
            self._anchor_round = int(round)
            self._anchor_crc = _leaf_crc(flat)
            self._history.pop(self._anchor_round, None)
            excess = len(self._history) - max(0, self.anchor_history - 1)
            if excess > 0:
                for r in sorted(self._history)[:excess]:
                    del self._history[r]

    @property
    def anchor_round(self) -> int:
        with self._lock:
            return self._anchor_round

    def resync(self, leaves: Sequence[Any], round: int) -> None:
        """Rejoin path: re-anchor and DROP the error-feedback residuals and
        the anchor history (they belong to a model generation the federation
        has moved past)."""
        with self._lock:
            self._residual = None
            self._history.clear()
        self.set_anchor(leaves, round)

    def reset(self) -> None:
        with self._lock:
            self._anchor = None
            self._shapes = None
            self._anchor_round = -1
            self._anchor_crc = 0
            self._residual = None
            self._history.clear()

    # --- recovery journal ------------------------------------------------------

    def export_state(self) -> Dict[str, Any]:
        """Snapshot of the recovery closure: the current anchor (flat f32
        numpy leaves + shapes + round + fingerprint) and the error-feedback
        residuals, in the JAX package's format. The anchor history is not
        exported."""
        with self._lock:
            return {
                "anchor": [a.cpu().numpy().copy() for a in self._anchor] if self._anchor is not None else None,
                "shapes": list(self._shapes) if self._shapes is not None else None,
                "anchor_round": self._anchor_round,
                "anchor_crc": self._anchor_crc,
                "residual": (
                    [r.cpu().numpy().copy() for r in self._residual] if self._residual is not None else None
                ),
            }

    def import_state(self, st: Dict[str, Any]) -> None:
        """Restore an :meth:`export_state` snapshot (either package's)."""
        with self._lock:
            anchor = st.get("anchor")
            self._anchor = [self._flat(a) for a in anchor] if anchor is not None else None
            shapes = st.get("shapes")
            self._shapes = [tuple(s) for s in shapes] if shapes is not None else None
            self._anchor_round = int(st.get("anchor_round", -1))
            self._anchor_crc = int(st.get("anchor_crc", 0))
            residual = st.get("residual")
            self._residual = [self._flat(r) for r in residual] if residual is not None else None
            self._history.clear()

    def anchor_model(self) -> Optional[Tuple[List[torch.Tensor], int]]:
        """(anchor leaves in their model shapes, anchor round), or ``None``
        when no anchor is set."""
        with self._lock:
            if self._anchor is None or self._shapes is None:
                return None
            return [a.reshape(s).clone() for a, s in zip(self._anchor, self._shapes)], self._anchor_round

    # --- encode ------------------------------------------------------------------

    def encode_model(self, model: Any, round: int) -> Optional[bytes]:
        """Sparse delta frame for ``model`` (a
        :class:`~p2pfl_tpu_torch.models.model_handle.ModelHandle`) against
        the round anchor, or ``None`` when the dense path must be used."""
        tagged = self.encode_tagged(model, round)
        return None if tagged is None else tagged[0]

    def encode_tagged(self, model: Any, round: int) -> Optional[Tuple[bytes, str]]:
        """Like :meth:`encode_model` but returns ``(payload, codec_label)``.

        The CURRENT anchor round encodes through the error-feedback kernels
        (residuals persist); a round still in the anchor HISTORY encodes
        STATELESSLY against the retired anchor (the live residuals are not
        touched); any other round returns ``None`` (dense fallback).
        """
        if Settings.WIRE_COMPRESSION != "topk":
            return None
        with self._lock:
            ef_path = self._anchor is not None and self._anchor_round == int(round)
            if ef_path:
                anchor, shapes, crc = self._anchor, self._shapes, self._anchor_crc
            elif int(round) in self._history:
                anchor, shapes, crc = self._history[int(round)]
            else:
                self.dense_fallback_frames += 1
                _DENSE_FALLBACK.labels(self._addr).inc()
                return None
            leaves = model.get_parameters()
            if len(leaves) != len(anchor) or any(tuple(l.shape) != s for l, s in zip(leaves, shapes)):
                self.dense_fallback_frames += 1
                _DENSE_FALLBACK.labels(self._addr).inc()
                return None
            if ef_path and self._residual is None:
                self._residual = [torch.zeros_like(a) for a in anchor]

            ratio = Settings.WIRE_TOPK_RATIO
            value_dtype = Settings.WIRE_TOPK_VALUES
            coalesce = Settings.COALESCE_ENABLED
            label = codec_label(value_dtype)
            parts: List[Any] = []
            spec: List[Dict[str, Any]] = []
            idx_plane = bytearray()
            val_plane = bytearray()
            sparse_tensors = 0
            for i, (leaf, anchor_flat) in enumerate(zip(leaves, anchor)):
                t = as_tensor(leaf)
                if not t.is_floating_point() or t.numel() == 0:
                    parts.append(leaf)
                    spec.append({"codec": "raw"})
                    continue
                delta = self._flat(t) - anchor_flat
                if not bool(torch.isfinite(delta).all()):
                    # diverged tensor: ship the FULL leaf raw (the receiver's
                    # reconstruction ignores its anchor for this tensor)
                    parts.append(leaf)
                    spec.append({"codec": "raw"})
                    continue
                k = topk_count(delta.numel(), ratio)
                vd = value_dtype
                if vd in ("int8", "int4") and k < Settings.QUANT_MIN_VALUES:
                    vd = "bf16"
                extra: Dict[str, Any] = {}
                if ef_path:
                    if vd in ("int8", "int4"):
                        idx, wire_vals, scale, new_resid = ef_topk_quant_encode(
                            delta, self._residual[i], k, 8 if vd == "int8" else 4)
                        extra = {"scale": scale, "zero_point": 0}
                    else:
                        idx, wire_vals, new_resid = ef_topk_encode(delta, self._residual[i], k, vd)
                    self._residual[i] = new_resid
                else:
                    idx, vals = topk_select(delta, k)
                    if vd in ("int8", "int4"):
                        qmax = 127 if vd == "int8" else 7
                        absmax = float(vals.abs().max()) if vals.numel() else 0.0
                        scale = absmax / qmax if absmax > 0 else 1.0
                        div = torch.tensor(scale, dtype=torch.float32, device=vals.device)
                        wire_vals = torch.clamp(torch.round(vals / div), -qmax, qmax).to(torch.int8)
                        extra = {"scale": scale, "zero_point": 0}
                    else:
                        wire_vals = vals
                # gap8 only inside the coalesced body — the per-tensor
                # layout stays decodable by pre-gap8 peers.
                packed, index_codec = encode_sparse_indices(idx, allow_gap8=coalesce)
                val_bytes, val_entry = _encode_values(wire_vals, vd)
                val_entry.update(extra)
                sparse_tensors += 1
                entry: Dict[str, Any] = {
                    "codec": "topk-c" if coalesce else "topk",
                    "dtype": numpy_dtype_str(t),
                    "shape": list(t.shape),
                    "index_codec": index_codec,
                }
                if coalesce:
                    entry.update({"parts": 0, "k": int(idx.numel()), "idx_bytes": int(packed.nbytes),
                                  "val_bytes": len(val_bytes)})
                    idx_plane += packed.tobytes()
                    val_plane += val_bytes
                else:
                    entry["parts"] = 2
                    parts.append(packed)
                    if val_entry["values"] in ("int8", "int4"):
                        parts.append(np.frombuffer(val_bytes, np.uint8))
                    else:
                        parts.append(bf16_round(wire_vals) if vd == "bf16" else wire_vals.float())
                entry.update(val_entry)
                spec.append(entry)
            meta: Dict[str, Any] = {
                "contributors": list(model.contributors),
                "num_samples": int(model.num_samples),
                "additional_info": model.additional_info,
                CODEC_META_KEY: spec,
                DELTA_META_KEY: {"round": int(round), "anchor_crc": crc},
            }
            if coalesce and sparse_tensors:
                level = Settings.COALESCE_DEFLATE_LEVEL
                ib, i_defl = _deflate_plane(bytes(idx_plane), level)
                vb, v_defl = _deflate_plane(bytes(val_plane), level)
                meta[COALESCE_META_KEY] = {
                    "deflate": [i_defl, v_defl],
                    "raw_len": [len(idx_plane), len(val_plane)],
                }
                parts.append(np.frombuffer(ib, np.uint8))
                parts.append(np.frombuffer(vb, np.uint8))
            wire_ctx = tracing.current_wire()
            if wire_ctx:
                meta[tracing.TRACE_META_KEY] = wire_ctx
            self.sparse_frames += 1
            _SPARSE_FRAMES.labels(self._addr).inc()
            payload = serialize_arrays(parts, meta)
            dense_bytes = sum(a.numel() * 4 for a in anchor) or 1
            _COMPRESSION_RATIO.labels(self._addr, label).set(dense_bytes / max(len(payload), 1))
            if ef_path:
                sq = sum(float(torch.dot(r, r)) for r in self._residual)
                _RESIDUAL_L2.labels(self._addr).set(float(np.sqrt(sq)))
            return payload, label

    # --- decode --------------------------------------------------------------------

    def decode_frame(self, blob: bytes) -> Tuple[List[torch.Tensor], Dict[str, Any]]:
        """Decode any model-plane frame into leaves on the codec's device:
        dense frames through the codec spec they declare; sparse delta frames
        reconstructed against the round anchor; a masked lattice frame's
        planes as host numpy arrays.

        Raises:
            DeltaAnchorError: sparse frame for a round we hold no anchor for.
            DecodingParamsError: malformed frame (any kind).
        """
        arrays, meta = deserialize_arrays(bytes(blob))
        if isinstance(meta.get(MASKED_META_KEY), dict):
            # A masked lattice frame (privacy plane): its packed ring planes
            # stay on the host, where the lattice sums run.
            return list(arrays), meta
        delta_meta = meta.get(DELTA_META_KEY)
        if delta_meta is None:
            try:
                if CODEC_META_KEY in meta:
                    return decompress_arrays(arrays, meta[CODEC_META_KEY], self.device), meta
            except DecodingParamsError:
                raise
            except Exception as exc:
                raise DecodingParamsError(f"malformed wire codec spec: {exc}") from exc
            return [as_tensor(a, device=self.device) for a in arrays], meta

        try:
            frame_round = int(delta_meta["round"])
            frame_crc = int(delta_meta.get("anchor_crc", 0))
            spec = meta[CODEC_META_KEY]
        except Exception as exc:
            raise DecodingParamsError(f"malformed delta frame metadata: {exc}") from exc

        with self._lock:
            if self._anchor is not None and self._anchor_round == frame_round:
                anchor, shapes, crc = self._anchor, self._shapes, self._anchor_crc
            elif frame_round in self._history:
                anchor, shapes, crc = self._history[frame_round]
            else:
                raise DeltaAnchorError(
                    f"no anchor for round {frame_round} (local anchor round: {self._anchor_round}, "
                    f"history: {sorted(self._history)})"
                )
            if frame_crc and frame_crc != crc:
                log.debug(
                    "(%s) delta frame anchor fingerprint differs (round %s, theirs %08x vs ours %08x) "
                    "— applying anyway", self._addr, frame_round, frame_crc & 0xFFFFFFFF, crc & 0xFFFFFFFF,
                )
            try:
                return self._reconstruct(arrays, spec, meta, anchor, shapes), meta
            except DecodingParamsError:
                raise
            except Exception as exc:
                raise DecodingParamsError(f"malformed sparse delta frame: {exc}") from exc

    def _reconstruct(
        self,
        arrays: Sequence[Any],
        spec: Sequence[Dict[str, Any]],
        meta: Dict[str, Any],
        anchor: List[torch.Tensor],
        shapes: List[tuple],
    ) -> List[torch.Tensor]:
        """anchor + scatter(delta) per leaf (caller holds the lock); every
        plane length, extent, integer range, scale and index bound is
        checked before the first value is scattered."""
        if len(spec) != len(anchor):
            raise DecodingParamsError(f"delta frame has {len(spec)} tensors, model has {len(anchor)}")
        arrays = list(arrays)
        co = meta.get(COALESCE_META_KEY)
        idx_plane = val_plane = b""
        if co is not None:
            try:
                raw_len = [int(x) for x in co["raw_len"]]
                deflate = [bool(x) for x in co["deflate"]]
            except Exception as exc:
                raise DecodingParamsError(f"malformed coalesce header: {exc}") from exc
            if len(arrays) < 2 or len(raw_len) != 2 or len(deflate) != 2:
                raise DecodingParamsError("coalesced frame missing its byte planes")
            planes = [np.asarray(a).tobytes() for a in arrays[-2:]]
            arrays = arrays[:-2]
            try:
                idx_plane = _inflate_plane(planes[0], raw_len[0]) if deflate[0] else planes[0]
                val_plane = _inflate_plane(planes[1], raw_len[1]) if deflate[1] else planes[1]
            except zlib.error as exc:
                raise DecodingParamsError(f"coalesced plane inflate failed: {exc}") from exc
            if len(idx_plane) != raw_len[0] or len(val_plane) != raw_len[1]:
                raise DecodingParamsError("coalesced plane length mismatch")
            declared_idx = sum(int(s.get("idx_bytes", 0)) for s in spec if s.get("codec") == "topk-c")
            declared_val = sum(int(s.get("val_bytes", 0)) for s in spec if s.get("codec") == "topk-c")
            if declared_idx != len(idx_plane) or declared_val != len(val_plane):
                raise DecodingParamsError("coalesced tensor extents disagree with the plane lengths")
        expected = sum(int(s.get("parts", 1)) for s in spec)
        if expected != len(arrays):
            raise DecodingParamsError("delta frame part count mismatch")
        out: List[torch.Tensor] = []
        pos = 0
        io = vo = 0  # plane cursors (coalesced tensors)
        for i, s in enumerate(spec):
            codec = s.get("codec", "raw")
            if codec == "raw":
                out.append(as_tensor(arrays[pos], device=self.device))
                pos += 1
                continue
            if codec not in ("topk", "topk-c"):
                raise DecodingParamsError(f"unexpected tensor codec {codec!r} in delta frame")
            shape = tuple(s["shape"])
            if shape != shapes[i]:
                raise DecodingParamsError(f"delta tensor {i} shape {shape} != model {shapes[i]}")
            if codec == "topk-c":
                if co is None:
                    raise DecodingParamsError("topk-c tensor without a coalesce header")
                k = int(s["k"])
                ib, vb = int(s["idx_bytes"]), int(s["val_bytes"])
                if k < 0 or ib < 0 or vb < 0:
                    raise DecodingParamsError("negative coalesced tensor extent")
                idx_bytes = idx_plane[io: io + ib]
                val_bytes = val_plane[vo: vo + vb]
                io += ib
                vo += vb
                icodec = s["index_codec"]
                try:
                    dt = {"gap8": np.uint8, "gap16": np.uint16, "abs32": np.uint32}[icodec]
                except KeyError:
                    raise DecodingParamsError(f"unknown sparse index codec {icodec!r}") from None
                if ib != k * np.dtype(dt).itemsize:
                    raise DecodingParamsError("index extent disagrees with k")
                packed = np.frombuffer(idx_bytes, dt)
                vals32: Any = _decode_values(val_bytes, s, k)
            else:
                packed, vals = arrays[pos], arrays[pos + 1]
                pos += 2
                # numpy, or a CPU bf16 tensor from the frame
                vals32 = None if s.get("values") in ("int8", "int4") else as_tensor(vals).float()
                icodec = s["index_codec"]
            idx = decode_sparse_indices(np.asarray(packed), icodec)
            if codec == "topk" and vals32 is None:
                # quantized uncoalesced layout: the value array is the raw plane
                vals32 = _decode_values(np.asarray(vals).tobytes(), s, idx.size)
            size = anchor[i].numel()
            vals32 = as_tensor(vals32, device=self.device, dtype=torch.float32).reshape(-1)
            if idx.size != vals32.numel():
                raise DecodingParamsError("sparse index/values length mismatch")
            # Every index, on the host: abs32 indices arrive in any order, and
            # one out of range would fault the scatter on the card.
            if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= size):
                raise DecodingParamsError("sparse index out of tensor bounds")
            dense = sparse_delta_apply(anchor[i], torch.from_numpy(idx).to(self.device), vals32)
            out.append(dense.reshape(shape).to(torch_dtype(s["dtype"])))
        return out
