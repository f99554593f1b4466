"""Wire compression for gossiped model weights (counterpart of
``p2pfl_tpu/ops/compression.py``), in torch on the tensors' device.

Per-tensor codecs applied at the wire boundary only — training and
aggregation stay float32:

* ``bf16`` — float32 leaves cast to bfloat16 (round to nearest even, a
  NaN to the quiet NaN of its sign: :func:`bf16_round`);
* ``int8`` — symmetric per-tensor linear quantization, ``q = rint(a /
  scale)`` with ``scale = absmax / 127``;
* ``topk`` — magnitude top-k sparsification: the k largest-|value|
  elements of each tensor ship as a sorted index array plus values, the
  rest decode to zero. Meant for round-anchored deltas with error feedback
  (:mod:`p2pfl_tpu_torch.comm.delta`).

The JAX package selects with ``lax.top_k`` and scatters with ``.at[]``
inside jitted XLA programs (plain XLA ops, not Pallas kernels); here they
are ``torch.topk`` / ``index_add`` on whatever device the tensors live on
(the card on the node's path). The contracts are the JAX package's: indices
sorted ascending; ``scale = absmax / qmax`` in f32 (as XLA computes it,
``absmax * (1 / qmax)``); round half to even; and
the error-feedback residual is ``acc.index_add(idx, -dequant)``, one f32
subtraction per transmitted value, so ``new_residual[idx] == acc[idx] -
q * scale`` element for element. ``torch.topk`` and ``lax.top_k`` may break
ties between equal magnitudes differently; on tie-free inputs both select
the same set.

Integer/bool leaves and empty tensors pass through unchanged. The codec
spec (per-tensor scheme + original dtype + scale) rides in the PFLT frame
metadata, byte for byte as the JAX package writes it.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from p2pfl_tpu_torch.device import DeviceLike

SCHEMES = ("none", "bf16", "int8", "topk")

#: Reserved metadata key carrying the per-tensor codec spec in a PFLT frame.
CODEC_META_KEY = "__codec__"

Array = Union[np.ndarray, torch.Tensor]


def as_tensor(a: Array, device: Optional[DeviceLike] = None, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``a`` as a tensor (numpy arrays are copied in; tensors stay where they
    are unless ``device`` is given)."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device if device is not None else t.device, dtype=dtype or t.dtype)


#: The rank key of every NaN magnitude in :func:`_select`: the canonical
#: quiet NaN's f32 bits, above +inf's.
_NAN_KEY = 0x7FC00000

#: bf16 bits of the quiet NaN of each sign (ml_dtypes' cast, as ``int16``).
_BF16_NAN, _BF16_NEG_NAN = 0x7FC0, 0xFFC0 - 0x10000


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` cast to bfloat16 as ml_dtypes casts it, on ``t``'s device: round
    to nearest even, and a NaN becomes the quiet NaN of its sign (0x7FC0 /
    0xFFC0). torch's own cast turns every NaN into 0xFFFF, so a frame built
    with it differs from the JAX package's in the NaN's bytes; this is that
    cast with its NaNs replaced in one ``torch.where``, no host copy."""
    if t.dtype == torch.bfloat16:
        return t
    bits = t.to(torch.bfloat16).view(torch.int16)
    nan_bits = torch.where(torch.signbit(t), _BF16_NEG_NAN, _BF16_NAN).to(torch.int16)
    return torch.where(torch.isnan(t), nan_bits, bits).view(torch.bfloat16)


def numpy_dtype_str(a: Array) -> str:
    """The numpy ``dtype.str`` of an array or tensor (``"<f4"`` for f32)."""
    if isinstance(a, torch.Tensor):
        return np.dtype(str(a.dtype).removeprefix("torch.")).str
    return np.asarray(a).dtype.str


def torch_dtype(dtype_str: str) -> torch.dtype:
    """Inverse of :func:`numpy_dtype_str` for the float dtypes a spec names."""
    return getattr(torch, np.dtype(dtype_str).name)


def _is_float(a: Array) -> bool:
    if isinstance(a, torch.Tensor):
        return a.is_floating_point()
    return np.issubdtype(np.asarray(a).dtype, np.floating)


def _select(acc: torch.Tensor, k: int) -> torch.Tensor:
    """Indices (sorted ascending) of the ``k`` largest-|value| elements.

    Among equal magnitudes the lower index wins, as ``jax.lax.top_k`` breaks
    ties (``torch.topk`` keeps an arbitrary subset): every index above the
    k-th largest magnitude ``t`` is kept, then the lowest indices equal to
    ``t`` fill the rest. The kept indices are scattered to their ranks, so
    nothing waits on the device. Magnitudes are ranked by their f32 bits
    (monotonic for non-negative floats), every NaN as one value above +inf,
    as ``lax.top_k`` ranks them."""
    mag = acc.abs()
    key = torch.where(torch.isnan(mag), _NAN_KEY, mag.view(torch.int32))
    t = torch.topk(key, k, sorted=False).values.min()
    above, tied = key > t, key == t
    keep = above | (tied & (torch.cumsum(tied, 0) <= k - above.sum()))
    slot = torch.where(keep, torch.cumsum(keep, 0) - 1, k)  # rank among the kept; k: discarded
    out = torch.empty(k + 1, dtype=torch.long, device=acc.device)
    out.scatter_(0, slot, torch.arange(acc.numel(), device=acc.device))
    return out[:k]


def topk_select(flat: Array, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k by magnitude over a flat array: ``(indices, values)`` with
    indices sorted ascending (int64) and values gathered in that order (f32),
    on the input's device."""
    flat = as_tensor(flat, dtype=torch.float32).reshape(-1)
    idx = _select(flat, k)
    return idx, flat[idx]


def scatter_dense(indices: Array, values: Array, size: int) -> torch.Tensor:
    """Inverse of :func:`topk_select`: a dense f32 vector with ``values`` at
    ``indices`` and zeros elsewhere (disjoint indices), on the values'
    device."""
    vals = as_tensor(values, dtype=torch.float32)
    out = torch.zeros(size, dtype=torch.float32, device=vals.device)
    out[as_tensor(indices, device=vals.device).long()] = vals
    return out


def topk_count(size: int, ratio: float) -> int:
    """Number of transmitted elements for a tensor of ``size`` at ``ratio``."""
    return max(1, min(size, math.ceil(size * ratio)))


def ef_topk_encode(
    delta: Array, residual: Array, k: int, value_dtype: str = "bf16"
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One error-feedback top-k selection step on the inputs' device.

    ``acc = delta + residual``; the ``k`` largest-|acc| positions ship
    (bf16 or f32 values); returns ``(indices, wire_values, new_residual)``
    with ``new_residual = acc.index_add(idx, -dequant)``: the untransmitted
    tail plus, under bf16, each value's rounding error. With f32 values
    ``scatter(indices, wire_values) + new_residual == delta + residual``
    element for element.
    """
    delta = as_tensor(delta, dtype=torch.float32).reshape(-1)
    acc = delta + as_tensor(residual, device=delta.device, dtype=torch.float32).reshape(-1)
    idx = _select(acc, k)
    vals = acc[idx]
    if value_dtype == "bf16":
        wire = bf16_round(vals)
        dequant = wire.float()
    else:
        wire = dequant = vals
    return idx, wire, acc.index_add(0, idx, -dequant)


def ef_topk_quant_encode(
    delta: Array, residual: Array, k: int, bits: int
) -> Tuple[torch.Tensor, torch.Tensor, float, torch.Tensor]:
    """Error-feedback top-k selection with integer values: symmetric linear
    int8 (``bits=8``, grid ±127) or int4 (``bits=4``, grid ±7, packed to
    nibbles by the caller with :func:`pack_nibbles`) over the SELECTED
    values. Returns ``(indices, q_int8, scale, new_residual)`` with
    ``new_residual[idx] == acc[idx] - q * scale`` element for element."""
    if bits not in (4, 8):
        raise ValueError(f"quantized top-k supports 4 or 8 bits, got {bits}")
    qmax = 127 if bits == 8 else 7
    delta = as_tensor(delta, dtype=torch.float32).reshape(-1)
    acc = delta + as_tensor(residual, device=delta.device, dtype=torch.float32).reshape(-1)
    idx = _select(acc, k)
    vals = acc[idx]
    absmax = vals.abs().max()
    # XLA compiles the JAX package's ``absmax / qmax`` (a constant divisor) to
    # ``absmax * (1 / qmax)``; the same f32 product gives the same scale.
    recip = torch.reciprocal(torch.tensor(float(qmax), dtype=torch.float32, device=absmax.device))
    scale = torch.where(absmax > 0, absmax * recip, torch.ones_like(absmax))
    q = torch.clamp(torch.round(vals / scale), -qmax, qmax).to(torch.int8)
    dequant = q.float() * scale
    return idx, q, float(scale), acc.index_add(0, idx, -dequant)


def pack_nibbles(q: Array) -> np.ndarray:
    """Pack int4-range values (each in [-7, 7]) two per byte (uint8): the
    wire form ``q + 8`` lies in [1, 15] (nibble 0 is an invalid sentinel);
    an odd tail is padded with the encoding of 0 (``8``)."""
    if isinstance(q, torch.Tensor):
        q = q.detach().cpu().numpy()
    u = (np.asarray(q, np.int64) + 8).astype(np.uint8)
    if (u < 1).any() or (u > 15).any():
        raise ValueError("int4 value out of [-7, 7] range")
    if u.size % 2:
        u = np.concatenate([u, np.array([8], np.uint8)])
    return (u[0::2] | (u[1::2] << 4)).astype(np.uint8)


def unpack_nibbles(packed: np.ndarray, count: int) -> np.ndarray:
    """Invert :func:`pack_nibbles` back to ``count`` int8 values in [-7, 7];
    raises ``ValueError`` on the reserved 0 nibble or a short buffer."""
    packed = np.asarray(packed, np.uint8).reshape(-1)
    if packed.size * 2 < count:
        raise ValueError("int4 plane shorter than the declared value count")
    u = np.empty(packed.size * 2, np.uint8)
    u[0::2] = packed & 0x0F
    u[1::2] = packed >> 4
    u = u[:count]
    if (u < 1).any() or (u > 15).any():
        raise ValueError("int4 nibble outside the [1, 15] wire range")
    return (u.astype(np.int16) - 8).astype(np.int8)


def compress_arrays(
    arrays: Sequence[Array],
    scheme: str,
    ratio: Optional[float] = None,
    value_dtype: Optional[str] = None,
) -> Tuple[List[Array], List[Dict[str, Any]]]:
    """Encode ``arrays`` under ``scheme``; returns (encoded, per-tensor spec),
    the JAX package's layout: a ``topk`` entry covers TWO consecutive
    encoded arrays (packed indices, values), every other codec one.
    ``ratio`` / ``value_dtype`` default to ``Settings.WIRE_TOPK_RATIO`` /
    ``Settings.WIRE_TOPK_VALUES``. Float tensors are encoded on their own
    device; integer leaves, empty and non-finite tensors pass through raw."""
    if scheme not in SCHEMES:
        raise ValueError(f"unknown compression scheme {scheme!r}; known: {SCHEMES}")
    if scheme == "topk":
        from p2pfl_tpu_torch.config import Settings

        ratio = Settings.WIRE_TOPK_RATIO if ratio is None else float(ratio)
        value_dtype = Settings.WIRE_TOPK_VALUES if value_dtype is None else value_dtype
        if not 0.0 < ratio <= 1.0:
            raise ValueError(f"topk ratio must be in (0, 1], got {ratio}")
        if value_dtype not in ("bf16", "float32"):
            raise ValueError(f"topk value_dtype must be 'bf16' or 'float32', got {value_dtype!r}")
    encoded: List[Array] = []
    spec: List[Dict[str, Any]] = []
    for a in arrays:
        if scheme == "none" or not _is_float(a) or math.prod(a.shape) == 0:
            encoded.append(a)
            spec.append({"codec": "raw"})
            continue
        t = as_tensor(a)
        if scheme == "topk":
            flat = t.float().reshape(-1)
            if not bool(torch.isfinite(flat).all()):
                # never launder a diverged tensor into a plausible sparse one
                encoded.append(a)
                spec.append({"codec": "raw"})
                continue
            from p2pfl_tpu_torch.ops.serialization import encode_sparse_indices

            idx, vals = topk_select(flat, topk_count(flat.numel(), ratio))
            packed, index_codec = encode_sparse_indices(idx)
            encoded.append(packed)
            encoded.append(bf16_round(vals) if value_dtype == "bf16" else vals)
            spec.append({"codec": "topk", "dtype": numpy_dtype_str(a), "shape": list(t.shape),
                         "index_codec": index_codec, "parts": 2})
        elif scheme == "bf16":
            encoded.append(bf16_round(t))
            spec.append({"codec": "bf16", "dtype": numpy_dtype_str(a)})
        else:  # int8
            absmax = float(t.float().abs().max())
            if not math.isfinite(absmax):
                # int8 cannot represent NaN/inf: ship the tensor raw so
                # receivers still see the divergence
                encoded.append(a)
                spec.append({"codec": "raw"})
                continue
            scale = absmax / 127.0 if absmax > 0 else 1.0
            q = torch.clamp(torch.round(t.float() / torch.tensor(scale, dtype=torch.float32, device=t.device)),
                            -127, 127)
            encoded.append(q.to(torch.int8))
            spec.append({"codec": "int8", "dtype": numpy_dtype_str(a), "scale": scale})
    return encoded, spec


def decompress_arrays(
    arrays: Sequence[Array], spec: Sequence[Dict[str, Any]], device: Optional[DeviceLike] = None,
) -> List[torch.Tensor]:
    """Invert :func:`compress_arrays` given the frame's codec spec; returns
    tensors on ``device`` (default: the host, where frames are decoded).
    ``topk`` entries consume two arrays and densify through
    :func:`scatter_dense`; untransmitted elements decode to zero."""
    expected = sum(int(s.get("parts", 1)) for s in spec)
    if len(arrays) != expected:
        raise ValueError(
            f"codec spec length {len(spec)} ({expected} parts) does not match tensor count {len(arrays)}"
        )
    dev = torch.device(device) if device is not None else torch.device("cpu")
    out: List[torch.Tensor] = []
    pos = 0
    for s in spec:
        codec = s.get("codec", "raw")
        if codec == "topk":
            from p2pfl_tpu_torch.ops.serialization import decode_sparse_indices

            packed, vals = arrays[pos], arrays[pos + 1]
            pos += 2
            shape = tuple(s["shape"])
            size = math.prod(shape)
            idx = decode_sparse_indices(np.asarray(packed), s["index_codec"])
            vals = as_tensor(vals, device=dev, dtype=torch.float32).reshape(-1)
            if idx.size != vals.numel():
                raise ValueError("sparse index/values length mismatch")
            if idx.size and (idx.min() < 0 or idx.max() >= size):  # abs32 indices arrive in any order
                raise ValueError("sparse index out of tensor bounds")
            dense = scatter_dense(torch.from_numpy(idx).to(dev), vals, size)
            out.append(dense.reshape(shape).to(torch_dtype(s["dtype"])))
            continue
        a = as_tensor(arrays[pos], device=dev)
        pos += 1
        if codec == "raw":
            out.append(a)
        elif codec == "bf16":
            out.append(a.to(torch_dtype(s["dtype"])))
        elif codec == "int8":
            scale = torch.tensor(float(s["scale"]), dtype=torch.float32, device=dev)
            out.append((a.float() * scale).to(torch_dtype(s["dtype"])))
        else:
            raise ValueError(f"unknown tensor codec {codec!r}")
    return out
