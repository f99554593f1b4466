"""A one-device stand-in for ``jax.sharding.Mesh`` (counterpart of the part of
``p2pfl_tpu/parallel/mesh.py`` that the sequence-parallel path needs).

The port runs on one card, so a mesh axis does not split work across
devices: it names how many *virtual* shards a wrapper cuts a dimension into
(the ring's ``"seq"`` axis folds its chunks one after another on the card).
Code that needs an axis' size — :func:`p2pfl_tpu_torch.ops.ring_attention.
ring_attention`, as ``jax.lax.psum(1, axis_name)`` does under ``shard_map`` —
asks :func:`axis_size`, which answers only inside :meth:`Mesh.bind`, and
raises for an unbound name as JAX does outside ``shard_map``.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Iterator, Mapping

import torch

from p2pfl_tpu_torch.device import DeviceLike, resolve_device

# Axis name -> size of the meshes bound in this context (innermost wins).
_BOUND: contextvars.ContextVar[Mapping[str, int]] = contextvars.ContextVar("p2pfl_bound_axes", default={})


class Mesh:
    """Named axes, each a number of virtual shards, over one torch device.

    Args:
        axes: axis name -> number of shards (>= 1), e.g. ``{"seq": 8}``.
        device: where the wrappers put their inputs (``"cuda"`` by default;
            raises when no card is visible, like every entry point).
    """

    def __init__(self, axes: Mapping[str, int], device: DeviceLike = "cuda") -> None:
        if not axes:
            raise ValueError("a mesh needs at least one axis")
        for name, size in axes.items():
            if not isinstance(name, str) or not name:
                raise ValueError(f"axis names must be non-empty strings, got {name!r}")
            if int(size) != size or size < 1:
                raise ValueError(f"axis {name!r} must have a positive integer size, got {size!r}")
        self.shape: Dict[str, int] = {name: int(size) for name, size in axes.items()}
        self.device: torch.device = resolve_device(device)

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    def check_axis(self, name: str) -> int:
        """The size of axis ``name``; raises ``ValueError`` if the mesh has none."""
        if name not in self.shape:
            raise ValueError(f"mesh has no axis {name!r} (axes {self.axis_names})")
        return self.shape[name]

    @contextlib.contextmanager
    def bind(self) -> Iterator["Mesh"]:
        """Bind this mesh's axis names for :func:`axis_size` while the block runs."""
        token = _BOUND.set({**_BOUND.get(), **self.shape})
        try:
            yield self
        finally:
            _BOUND.reset(token)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={str(self.device)!r})"


def axis_size(name: str) -> int:
    """Size of a bound mesh axis; ``NameError`` outside a binding of ``name``."""
    bound = _BOUND.get()
    if name not in bound:
        raise NameError(f"unbound axis name: {name!r} (bind a Mesh with that axis first)")
    return bound[name]
