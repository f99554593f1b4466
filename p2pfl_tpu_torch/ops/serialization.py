"""PFLT v2: the safe, self-describing wire format for model weights (the
port's copy of ``p2pfl_tpu/ops/serialization.py``, on its pure-Python path).

    "PFLT" | u16 version | u32 header_len | u32 crc32 | msgpack header
    | raw array bytes (each 64-byte aligned)

The header carries dtype/shape per tensor plus a metadata dict
(contributors, num_samples, aggregator side channels, the codec spec); numpy
arrays (and tensors) inside metadata are encoded recursively with the same
dtype/shape tagging. The crc32 (zlib polynomial) covers header bytes + raw
tensor bytes; 0 means "not checked". The bytes are the JAX package's, byte
for byte, in both directions, so a port node and a reference node read each
other's frames.

Two things differ inside:

* **msgpack** is this module's own encoder/decoder of the subset the header
  uses (maps, arrays, str, bin, int, float, bool, nil), with the choices of
  ``msgpack.packb(use_bin_type=True)`` (smallest int and length forms, str8,
  float64), since the card's machine has no ``msgpack`` package.
* **bf16** tensors are written as their raw 16-bit patterns from torch
  (``t.view(torch.int16)``) under the dtype tag ``"bfloat16"`` the JAX
  package writes for ``ml_dtypes.bfloat16``, and come back as CPU
  ``torch.bfloat16`` tensors (numpy has no bf16 and the card's machine no
  ``ml_dtypes``). Every other dtype comes back as a numpy array.

Arrays handed to :func:`serialize_arrays` may be numpy arrays or torch
tensors (on any device; they are copied to the host).
"""

from __future__ import annotations

import struct
import zlib
from typing import Any, Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from p2pfl_tpu_torch.exceptions import DecodingParamsError

_MAGIC = b"PFLT"
_VERSION = 2
_ALIGN = 64
_PREFIX = 14  # magic(4) + version(2) + header_len(4) + crc32(4)

# Sentinel key marking a msgpack map as an encoded ndarray.
_NDARRAY_KEY = "__pflt_ndarray__"

#: The dtype tag of bf16 tensors (what the JAX package writes for
#: ``ml_dtypes.bfloat16``: numpy cannot round-trip its ``dtype.str``).
BF16_TAG = "bfloat16"

Array = Union[np.ndarray, torch.Tensor]


# --- msgpack (the header's subset) ----------------------------------------------


def _pack(obj: Any, out: bytearray) -> None:
    """Append ``obj`` in msgpack as ``msgpack.packb(obj, use_bin_type=True)``
    writes it."""
    if obj is None:
        out += b"\xc0"
    elif obj is True:
        out += b"\xc3"
    elif obj is False:
        out += b"\xc2"
    elif isinstance(obj, int):
        if 0 <= obj < 0x80:
            out += struct.pack("B", obj)
        elif -0x20 <= obj < 0:
            out += struct.pack("b", obj)
        elif obj >= 0:
            for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                   (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
                if obj < top:
                    out += bytes([code]) + struct.pack(fmt, obj)
                    break
            else:
                raise OverflowError("int too big to pack")
        else:
            for code, fmt, low in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                                   (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
                if obj >= low:
                    out += bytes([code]) + struct.pack(fmt, obj)
                    break
            else:
                raise OverflowError("int too small to pack")
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        n = len(raw)
        if n < 32:
            out += bytes([0xA0 | n])
        elif n < 1 << 8:
            out += b"\xd9" + struct.pack(">B", n)
        elif n < 1 << 16:
            out += b"\xda" + struct.pack(">H", n)
        else:
            out += b"\xdb" + struct.pack(">I", n)
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        n = len(raw)
        if n < 1 << 8:
            out += b"\xc4" + struct.pack(">B", n)
        elif n < 1 << 16:
            out += b"\xc5" + struct.pack(">H", n)
        else:
            out += b"\xc6" + struct.pack(">I", n)
        out += raw
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n < 16:
            out += bytes([0x90 | n])
        elif n < 1 << 16:
            out += b"\xdc" + struct.pack(">H", n)
        else:
            out += b"\xdd" + struct.pack(">I", n)
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        n = len(obj)
        if n < 16:
            out += bytes([0x80 | n])
        elif n < 1 << 16:
            out += b"\xde" + struct.pack(">H", n)
        else:
            out += b"\xdf" + struct.pack(">I", n)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


_FIXED = {  # code -> (struct format, size) of the scalar forms
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}


def _unpack(buf: bytes, pos: int) -> Tuple[Any, int]:
    """Decode one msgpack object at ``pos``; ``(obj, next pos)``. Strings
    decode as str (``raw=False``), map keys must be str or bytes
    (``strict_map_key``), ext types are refused."""

    def take(n: int) -> bytes:
        nonlocal pos
        if n < 0 or pos + n > len(buf):
            raise ValueError("msgpack data truncated")
        chunk = buf[pos:pos + n]
        pos += n
        return chunk

    def length(code: int, base: int) -> int:
        fmt, size = {0: (">B", 1), 1: (">H", 2), 2: (">I", 4)}[code - base]
        return struct.unpack(fmt, take(size))[0]

    code = take(1)[0]
    if code < 0x80:
        return code, pos
    if code >= 0xE0:
        return code - 0x100, pos
    if code <= 0x8F or code in (0xDE, 0xDF):
        n = code & 0x0F if code <= 0x8F else length(code, 0xDD)
        out: Dict[Any, Any] = {}
        for _ in range(n):
            key, pos = _unpack(buf, pos)
            if not isinstance(key, (str, bytes)):
                raise ValueError(f"{type(key).__name__} is not allowed for map key")
            out[key], pos = _unpack(buf, pos)
        return out, pos
    if code <= 0x9F or code in (0xDC, 0xDD):
        n = code & 0x0F if code <= 0x9F else length(code, 0xDB)
        items = []
        for _ in range(n):
            item, pos = _unpack(buf, pos)
            items.append(item)
        return items, pos
    if code <= 0xBF or code in (0xD9, 0xDA, 0xDB):
        n = code & 0x1F if code <= 0xBF else length(code, 0xD9)
        return take(n).decode("utf-8"), pos
    if code in (0xC4, 0xC5, 0xC6):
        return bytes(take(length(code, 0xC4))), pos
    if code == 0xC0:
        return None, pos
    if code in (0xC2, 0xC3):
        return code == 0xC3, pos
    if code in _FIXED:
        fmt, size = _FIXED[code]
        return struct.unpack(fmt, take(size))[0], pos
    raise ValueError(f"unsupported msgpack type 0x{code:02x}")


def unpackb(buf: bytes) -> Any:
    obj, pos = _unpack(bytes(buf), 0)
    if pos != len(buf):
        raise ValueError("extra data after the msgpack object")
    return obj


# --- arrays and their tags --------------------------------------------------------


def _host(a: Array) -> Tuple[str, Tuple[int, ...], np.ndarray]:
    """``(dtype tag, shape, raw C-order host array)`` of a numpy array or a
    tensor; a bf16 tensor's raw array is its bits as int16."""
    if isinstance(a, torch.Tensor):
        t = a.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            return BF16_TAG, tuple(t.shape), t.view(torch.int16).numpy()
        a = t.numpy()
    # np.asarray(order="C") rather than ascontiguousarray: the latter promotes
    # 0-d arrays to 1-d, which would corrupt scalar leaves.
    a = np.asarray(a, order="C")
    return _dtype_to_str(a.dtype), tuple(a.shape), a


def _dtype_to_str(dt: np.dtype) -> str:
    """The JAX package's portable dtype tag (``dtype.str``, e.g. ``"<f4"``)."""
    try:
        if np.dtype(dt.str) == dt:
            return dt.str
    except TypeError:
        pass
    return dt.name


def _raw_dtype(tag: str) -> np.dtype:
    """The numpy dtype a tagged buffer is read as (int16 bits for bf16)."""
    if tag == BF16_TAG:
        return np.dtype(np.int16)
    return np.dtype(tag)


def _from_raw(raw: np.ndarray, tag: str) -> Array:
    """A decoded array: numpy, or a CPU bf16 tensor for the bf16 tag."""
    if tag == BF16_TAG:
        return torch.from_numpy(np.array(raw, copy=True)).view(torch.bfloat16)
    return raw


def _encode_meta_value(v: Any) -> Any:
    """Recursively make a metadata value msgpack-safe (arrays tagged)."""
    if isinstance(v, (np.ndarray, torch.Tensor)):
        tag, shape, raw = _host(v)
        return {_NDARRAY_KEY: True, "dtype": tag, "shape": list(shape), "data": raw.tobytes()}
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, dict):
        return {str(k): _encode_meta_value(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_encode_meta_value(x) for x in v]
    if v is None or isinstance(v, (bool, int, float, str, bytes)):
        return v
    raise TypeError(f"metadata value of type {type(v)!r} is not serializable")


def _decode_meta_value(v: Any) -> Any:
    if isinstance(v, dict):
        if v.get(_NDARRAY_KEY):
            raw = np.frombuffer(v["data"], dtype=_raw_dtype(v["dtype"]))
            return _from_raw(raw.reshape(v["shape"]).copy(), v["dtype"])
        return {k: _decode_meta_value(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_decode_meta_value(x) for x in v]
    return v


def _pad(n: int) -> int:
    return (-n) % _ALIGN


# --- sparse tensor layout (index + values per tensor) -------------------------
#
# A top-k-sparsified tensor rides the frame as a packed index array and a
# values array (ops/compression.py, comm/delta.py). Indices are sorted
# ascending and packed as ``gap8`` (uint8 deltas; coalesced frames only),
# ``gap16`` (uint16 deltas) or ``abs32`` (absolute uint32), exactly as the
# JAX package packs them.

SPARSE_INDEX_CODECS = ("gap8", "gap16", "abs32")


def encode_sparse_indices(idx: Array, allow_gap8: bool = False) -> Tuple[np.ndarray, str]:
    """Pack sorted ascending flat indices; returns (packed, index_codec)."""
    if isinstance(idx, torch.Tensor):
        idx = idx.detach().cpu().numpy()
    idx = np.asarray(idx, dtype=np.int64)
    if idx.size == 0:
        return idx.astype(np.uint16), "gap16"
    gaps = np.diff(idx, prepend=0)
    if (gaps < 0).any():
        raise ValueError("sparse indices must be sorted ascending and unique")
    max_gap = int(gaps.max())
    if allow_gap8 and max_gap <= np.iinfo(np.uint8).max:
        return gaps.astype(np.uint8), "gap8"
    if max_gap <= np.iinfo(np.uint16).max:
        return gaps.astype(np.uint16), "gap16"
    if int(idx[-1]) > np.iinfo(np.uint32).max:
        raise ValueError("sparse index exceeds uint32 range")
    return idx.astype(np.uint32), "abs32"


def decode_sparse_indices(packed: np.ndarray, index_codec: str) -> np.ndarray:
    """Invert :func:`encode_sparse_indices` back to int64 flat indices."""
    if index_codec in ("gap8", "gap16"):
        return np.cumsum(np.asarray(packed, dtype=np.int64))
    if index_codec == "abs32":
        return np.asarray(packed, dtype=np.int64)
    raise ValueError(f"unknown sparse index codec {index_codec!r}")


def _frame_crc(header_bytes: bytes, raws: Sequence[np.ndarray]) -> int:
    """Chained CRC32 (zlib polynomial) over header bytes + raw tensor bytes."""
    crc = zlib.crc32(header_bytes)
    for a in raws:
        crc = zlib.crc32(a.view(np.uint8).data if a.ndim else a.tobytes(), crc)
    return crc if crc else 1  # 0 is the "not checked" sentinel


def serialize_arrays(
    arrays: Sequence[Array], metadata: Dict[str, Any] | None = None, checksum: bool = True,
) -> bytes:
    """Encode a flat list of arrays (numpy or torch) + metadata dict into one
    buffer, byte for byte as the JAX package's encoder. With ``checksum``
    the frame carries a CRC32 of header + tensor payload."""
    hosts = [_host(a) for a in arrays]
    header = {
        "tensors": [{"dtype": tag, "shape": list(shape)} for tag, shape, _ in hosts],
        "meta": _encode_meta_value(metadata or {}),
    }
    header_bytes = packb(header)
    raws = [raw for _, _, raw in hosts]
    crc = _frame_crc(header_bytes, raws) if checksum else 0
    parts = [_MAGIC, struct.pack("<HII", _VERSION, len(header_bytes), crc), header_bytes]
    offset = _PREFIX + len(header_bytes)
    parts.append(b"\0" * _pad(offset))
    offset += _pad(offset)
    for a in raws:
        raw = a.tobytes()
        parts.append(raw)
        offset += len(raw)
        parts.append(b"\0" * _pad(offset))
        offset += _pad(offset)
    return b"".join(parts)


def deserialize_arrays(buf: bytes) -> Tuple[List[Array], Dict[str, Any]]:
    """Decode a buffer produced by :func:`serialize_arrays` (either
    package's). Returns (arrays, metadata): numpy arrays (zero-copy views
    into ``buf``), bf16 tensors as CPU ``torch.bfloat16`` copies.

    Raises :class:`DecodingParamsError` on any malformed input.
    """
    try:
        if bytes(buf[:4]) != _MAGIC:  # buf may be bytes, bytearray, memoryview
            raise DecodingParamsError("bad magic — not a p2pfl_tpu weights buffer")
        version, header_len, crc = struct.unpack_from("<HII", buf, 4)
        if version != _VERSION:
            raise DecodingParamsError(f"unsupported wire version {version}")
        header_end = _PREFIX + header_len
        header_bytes = bytes(buf[_PREFIX:header_end])
        header = unpackb(header_bytes)
        offset = header_end + _pad(header_end)
        raws: List[np.ndarray] = []
        tags: List[str] = []
        for t in header["tensors"]:
            dtype = _raw_dtype(t["dtype"])
            shape = tuple(t["shape"])
            count = int(np.prod(shape, dtype=np.int64))
            nbytes = dtype.itemsize * count
            arr = np.frombuffer(buf, dtype=dtype, count=count, offset=offset)
            raws.append(arr.reshape(shape))
            tags.append(t["dtype"])
            offset += nbytes + _pad(offset + nbytes)
        if crc and _frame_crc(header_bytes, raws) != crc:
            raise DecodingParamsError("weights frame failed CRC32 integrity check")
        meta = _decode_meta_value(header.get("meta", {}))
        return [_from_raw(a, tag) for a, tag in zip(raws, tags)], meta
    except DecodingParamsError:
        raise
    except Exception as exc:  # malformed input of any kind
        raise DecodingParamsError(f"could not decode weights payload: {exc}") from exc
