"""Canonical-wire mixin shared by the interop model handles (the port's copy
of ``p2pfl_tpu/learning/interop/wire.py``).

Torch and Keras handles speak the flax-layout wire format through
``_to_wire`` / ``_from_wire`` translators so heterogeneous federations can
mix frameworks. In the port a canonical handle shows its canonical leaves
everywhere a Node looks at a model, as the port's own ``ModelHandle`` does:
``get_parameters()`` (aggregation, hashes, the delta codec's anchors,
admission's shape screen) and ``set_parameters`` (frames and leaves from
peers). The JAX package translates only inside its encode / decode, so its
Node screens a canonical peer's frame against the native layout and rejects
it as ``shape``.
"""

from __future__ import annotations

from typing import Any, List, Optional


class CanonicalWireMixin:
    """Canonical leaves over ``self._to_wire`` / ``self._from_wire``.

    Expects the host class to be an interop handle with ``_native_tree()``
    (what its translators take: a torch state dict, a keras weight list),
    ``_native_leaves()`` (its framework's leaves in their own layout and
    order), ``_set_native(tree or leaves)`` and ``_to_wire`` / ``_from_wire``
    attributes (``None`` disables translation: the native layout is the
    wire's).
    """

    def get_parameters(self) -> List[Any]:
        if self._to_wire is None:
            return self._native_leaves()
        return list(self._to_wire(self._native_tree()))

    def set_parameters(self, params) -> None:
        from p2pfl_tpu_torch.models.model_handle import decode_wire_frame

        if isinstance(params, (bytes, bytearray, memoryview)):
            arrays, meta = decode_wire_frame(params, self.device)
            self._apply_meta(meta)
            params = arrays
        leaves = list(params)
        self._set_native(self._from_wire(leaves) if self._from_wire is not None else leaves)

    def encode_parameters(self, compression: Optional[str] = None) -> bytes:
        if self._to_wire is not None and (
            "scaffold" in self.additional_info or "scaffold_server" in self.additional_info
        ):
            raise ValueError(
                "SCAFFOLD payloads cannot cross the canonical wire: their "
                "leaves are framework-layout specific (use a homogeneous "
                "federation for the Scaffold aggregator)"
            )
        from p2pfl_tpu_torch.models.model_handle import encode_wire_frame

        return encode_wire_frame(self.get_parameters(), self.contributors, self.num_samples,
                                 self.additional_info, compression)
