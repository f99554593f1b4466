"""A model = module + parameters + federation metadata, and its wire frames
(counterpart of ``p2pfl_tpu/models/model_handle.py``).

Parameters live as a flat ``{name: tensor}`` dict under the torch module's
names (``params``), on the device the model runs on. What a handle puts on
the wire, hashes and exchanges with aggregators is the JAX package's
**canonical** leaf list: flax's names in ``jax.tree.leaves`` order (nested
dict keys sorted), Dense kernels ``[in, out]`` and Conv kernels HWIO
(:func:`p2pfl_tpu_torch.models.convert.to_canonical`). So a port node's PFLT
frame decodes in a reference node to that model's leaves, and the other way
round, and :func:`~p2pfl_tpu_torch.telemetry.ledger.canonical_params_hash`
agrees across the two packages for equal weights.

Frames are the safe flat-buffer codec (:mod:`p2pfl_tpu_torch.ops.serialization`),
with contributors, the sample count and ``additional_info`` (aggregator side
channels, e.g. SCAFFOLD's deltas) in the metadata.
"""

from __future__ import annotations

import threading
import weakref
from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

import torch
import torch.nn as nn
from torch.func import functional_call

from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.device import DeviceLike
from p2pfl_tpu_torch.exceptions import DecodingParamsError, ModelNotMatchingError
from p2pfl_tpu_torch.ops.compression import CODEC_META_KEY, as_tensor, compress_arrays, decompress_arrays
from p2pfl_tpu_torch.ops.serialization import deserialize_arrays, serialize_arrays
from p2pfl_tpu_torch.telemetry import tracing

Params = Dict[str, torch.Tensor]

# ``functional_call`` swaps the given tensors into the module for the call
# and back after it, so two threads running one module at once (nodes built
# from one template, each fitting on its own executor thread) would see each
# other's parameters. One lock per module serializes the forward passes of
# handles sharing it; the backward passes run outside it.
_APPLY_LOCKS: "weakref.WeakKeyDictionary[nn.Module, threading.Lock]" = weakref.WeakKeyDictionary()
_APPLY_LOCKS_GUARD = threading.Lock()


def _apply_lock(module: nn.Module) -> threading.Lock:
    with _APPLY_LOCKS_GUARD:
        lock = _APPLY_LOCKS.get(module)
        if lock is None:
            lock = _APPLY_LOCKS[module] = threading.Lock()
        return lock


def encode_wire_frame(
    arrays: Sequence[Any],
    contributors: List[str],
    num_samples: int,
    additional_info: Dict[str, Any],
    compression: Optional[str] = None,
) -> bytes:
    """Build a PFLT weights frame: tensors + federation metadata, with the
    wire codec (default ``Settings.WIRE_COMPRESSION``; ``"topk"`` ships
    dense here, since the delta codec owns anchors) applied and its spec
    recorded in the frame."""
    if compression is None:
        compression = Settings.WIRE_COMPRESSION
    if compression == "topk":
        compression = "none"
    meta: Dict[str, Any] = {
        "contributors": contributors,
        "num_samples": num_samples,
        "additional_info": additional_info,
    }
    wire_ctx = tracing.current_wire()
    if wire_ctx:
        meta[tracing.TRACE_META_KEY] = wire_ctx
    if compression != "none":
        arrays, spec = compress_arrays(arrays, compression)
        meta[CODEC_META_KEY] = spec
    return serialize_arrays(list(arrays), meta)


def decode_wire_frame(blob: bytes, device: Optional[DeviceLike] = None) -> tuple[List[torch.Tensor], Dict[str, Any]]:
    """Decode a PFLT weights frame (either package's) into tensors on
    ``device`` (default: the host), inverting any wire codec it declares.

    Raises :class:`DecodingParamsError` on any malformed input, and on a
    sparse delta frame (it needs the node's ``DeltaWireCodec``).
    """
    arrays, meta = deserialize_arrays(bytes(blob))
    if "__delta__" in meta:
        raise DecodingParamsError(
            "sparse delta frame requires the node's DeltaWireCodec (round anchor) to decode"
        )
    dev = torch.device(device) if device is not None else torch.device("cpu")
    try:
        if CODEC_META_KEY in meta:
            return decompress_arrays(arrays, meta[CODEC_META_KEY], dev), meta
    except DecodingParamsError:
        raise
    except Exception as exc:
        raise DecodingParamsError(f"malformed wire codec spec: {exc}") from exc
    return [as_tensor(a, device=dev) for a in arrays], meta


class ModelHandle:
    """Parameters as a flat ``{name: tensor}`` dict (the module's
    ``named_parameters`` names) plus the module that runs them, and the
    federation metadata.

    Args:
        params: the parameters, f32.
        module: the architecture; :meth:`apply` runs it on any parameter set
            with these names, so one module serves a whole population.
        num_samples: number of samples backing this model's training.
        contributors: node addresses whose training contributed to ``params``.
        additional_info: aggregator side-channel data (msgpack-safe values,
            tensors and numpy arrays included).
    """

    framework = "torch"

    def __init__(
        self,
        params: Params,
        module: nn.Module,
        num_samples: int = 1,
        contributors: Optional[List[str]] = None,
        additional_info: Optional[Dict[str, Any]] = None,
    ) -> None:
        names = {n for n, _ in module.named_parameters()}
        if set(params) != names:
            raise ValueError(
                f"params do not match the module: missing {sorted(names - set(params))}, "
                f"unexpected {sorted(set(params) - names)}"
            )
        self.params = params
        self.module = module
        self.num_samples = int(num_samples)
        self.contributors: List[str] = list(contributors or [])
        self.additional_info: Dict[str, Any] = dict(additional_info or {})

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """Run the module on ``x`` with ``params`` (``apply_fn`` counterpart).
        Thread-safe: calls on one module from several threads take turns."""
        with _apply_lock(self.module):
            return functional_call(self.module, params, (x,))

    @property
    def device(self) -> torch.device:
        return next(iter(self.params.values())).device if self.params else torch.device("cpu")

    # --- parameters -------------------------------------------------------------

    def get_parameters(self) -> List[torch.Tensor]:
        """The canonical leaves (the JAX package's ``get_parameters()`` order
        and layout) as contiguous tensors on the model's device."""
        from p2pfl_tpu_torch.models.convert import to_canonical

        return to_canonical(self.params)

    def get_tree(self) -> Params:
        return self.params

    def set_parameters(self, params: Union[Sequence[Any], bytes, Mapping[str, Any]]) -> None:
        """Adopt new parameters from canonical leaves (tensors or numpy
        arrays), wire bytes (either package's frame), or a mapping: the
        port's ``{name: tensor}`` or a flax tree. Values are cast to the
        model's dtypes and moved to its device.

        Raises:
            ModelNotMatchingError: leaf count or shapes don't match.
            DecodingParamsError: wire bytes are malformed.
        """
        from p2pfl_tpu_torch.models.convert import canonical_names, flax_to_torch, from_canonical

        if isinstance(params, (bytes, bytearray, memoryview)):
            leaves, meta = decode_wire_frame(params, self.device)
            self._apply_meta(meta)
            params = leaves
        if isinstance(params, Mapping):
            if set(params) != set(self.params):  # a flax tree (with or without "params")
                params = flax_to_torch(params, self.device)
            if set(params) != set(self.params):
                raise ModelNotMatchingError(
                    f"parameter names differ: missing {sorted(set(self.params) - set(params))}")
            for n, t in self.params.items():
                if tuple(params[n].shape) != tuple(t.shape):
                    raise ModelNotMatchingError(f"{n}: shape {tuple(params[n].shape)} != {tuple(t.shape)}")
            self.params = {n: as_tensor(params[n], device=self.device, dtype=t.dtype) for n, t in self.params.items()}
            return
        leaves = list(params)
        names = canonical_names(self.params)
        if len(leaves) != len(names):
            raise ModelNotMatchingError(f"expected {len(names)} tensors, got {len(leaves)}")
        for arr, shape in zip(leaves, self._canonical_shapes()):
            if tuple(arr.shape) != shape:
                raise ModelNotMatchingError(f"shape mismatch: {tuple(arr.shape)} != {shape}")
        cast = [as_tensor(a, device=self.device, dtype=self.params[n].dtype) for a, n in zip(leaves, names)]
        self.params = from_canonical(names, cast)

    def _canonical_shapes(self) -> List[tuple]:
        """Shapes of the canonical leaves (Dense kernels ``[in, out]``, Conv
        kernels HWIO)."""
        from p2pfl_tpu_torch.models.convert import canonical_names, canonical_shape

        return [canonical_shape(n, self.params[n].shape) for n in canonical_names(self.params)]

    def _apply_meta(self, meta: Dict[str, Any]) -> None:
        self.contributors = list(meta.get("contributors", self.contributors))
        self.num_samples = int(meta.get("num_samples", self.num_samples))
        self.additional_info.update(meta.get("additional_info", {}))

    def apply_frame(self, arrays: Sequence[Any], meta: Dict[str, Any]) -> None:
        """Adopt an already-decoded wire frame (e.g. by the node's
        ``DeltaWireCodec``): federation metadata + canonical leaves."""
        self._apply_meta(meta)
        self.set_parameters(list(arrays))

    def encode_parameters(self, compression: Optional[str] = None) -> bytes:
        """Serialize the canonical leaves + metadata for the wire, under
        ``compression`` (default ``Settings.WIRE_COMPRESSION``)."""
        return encode_wire_frame(
            self.get_parameters(), self.contributors, self.num_samples, self.additional_info, compression,
        )

    @staticmethod
    def decode_metadata(blob: bytes) -> Dict[str, Any]:
        """Peek at a wire buffer's metadata without adopting weights."""
        _, meta = deserialize_arrays(blob)
        return meta

    # --- federation metadata --------------------------------------------------------

    def set_contribution(self, contributors: List[str], num_samples: int) -> None:
        self.contributors = list(contributors)
        self.num_samples = int(num_samples)

    def get_contributors(self) -> List[str]:
        if not self.contributors:
            raise ValueError("contributors not set on this model")
        return self.contributors

    def get_num_samples(self) -> int:
        return self.num_samples

    def add_info(self, key: str, value: Any) -> None:
        self.additional_info[key] = value

    def get_info(self, key: str, default: Any = None) -> Any:
        return self.additional_info.get(key, default)

    # --- copies -----------------------------------------------------------------------

    def build_copy(
        self,
        params: Union[Sequence[Any], bytes, Mapping[str, Any], None] = None,
        contributors: Optional[List[str]] = None,
        num_samples: Optional[int] = None,
    ) -> "ModelHandle":
        """New handle sharing the module (and, unless ``params`` is given,
        the parameter tensors: nothing in the port updates them in place)."""
        copy = ModelHandle(
            dict(self.params), self.module,
            num_samples=num_samples if num_samples is not None else self.num_samples,
            contributors=contributors if contributors is not None else list(self.contributors),
            additional_info=dict(self.additional_info),
        )
        if params is not None:
            copy.set_parameters(params)
        return copy

    def get_framework(self) -> str:
        return self.framework

    def __repr__(self) -> str:
        n_params = sum(t.numel() for t in self.params.values())
        return (
            f"ModelHandle(leaves={len(self.params)}, params={n_params}, "
            f"contributors={len(self.contributors)}, num_samples={self.num_samples})"
        )
