"""A one-device stand-in for ``jax.sharding.Mesh`` (counterpart of
``p2pfl_tpu/parallel/mesh.py``).

The port runs on one card, so a mesh axis does not split work across
devices: it names how many *virtual* shards a wrapper cuts a dimension into
(the ring's ``"seq"`` axis folds its chunks one after another on the card;
a population's ``"nodes"`` axis is the multiple it is padded to). Code that
needs an axis' size — :func:`p2pfl_tpu_torch.ops.ring_attention.
ring_attention`, as ``jax.lax.psum(1, axis_name)`` does under ``shard_map`` —
asks :func:`axis_size`, which answers only inside :meth:`Mesh.bind`, and
raises for an unbound name as JAX does outside ``shard_map``.

:func:`make_mesh`, :func:`population_sharding`, :func:`replicated` and
:func:`initialize_multihost` keep the JAX package's API over one device;
:class:`PartitionSpec` and :class:`NamedSharding` stand in for JAX's. Joining
a multi-process deployment is out of scope for the port (it runs on one
card), so :func:`initialize_multihost` refuses when asked to join one.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from dataclasses import dataclass
from typing import Dict, Iterator, Mapping, Optional, Sequence

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


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec`` stand-in: one mesh axis name (or
    ``None``) per array axis; axes past its length are replicated."""

    def __new__(cls, *axes: Optional[str]) -> "PartitionSpec":
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


@dataclass(frozen=True)
class NamedSharding:
    """``jax.sharding.NamedSharding`` stand-in: a spec over a mesh's axes.
    On one card every shard lives on ``mesh.device``."""

    mesh: Mesh
    spec: PartitionSpec

    @property
    def device(self) -> torch.device:
        return self.mesh.device


def make_mesh(
    shape: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("nodes", "model"),
    devices: Optional[Sequence[DeviceLike]] = None,
) -> Mesh:
    """Build a mesh over one device (the JAX package's arguments).

    Args:
        shape: per-axis sizes; each axis is a number of virtual shards on
            the one device (default: 1 for every axis).
        axis_names: mesh axis names, default ``("nodes", "model")``.
        devices: a one-element sequence (default ``["cuda"]``); more than
            one device raises, since the port runs on one card.
    """
    devices = list(devices) if devices is not None else ["cuda"]
    if len(devices) != 1:
        raise ValueError(f"the port's mesh spans one device, got {len(devices)} (multi-device meshes are out of "
                         "scope: ROADMAP, queue A's out-of-scope notes)")
    names = tuple(axis_names)
    shape = tuple(shape) if shape is not None else (1,) * len(names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} does not match axis names {names}")
    return Mesh(dict(zip(names, shape)), device=devices[0])


#: The environment a multi-process deployment announces itself by (the JAX
#: package's list).
_DEPLOYMENT_ENV = ("JAX_COORDINATOR_ADDRESS", "TPU_WORKER_HOSTNAMES", "CLOUD_TPU_TASK_ID",
                   "MEGASCALE_COORDINATOR_ADDRESS")


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> None:
    """The JAX package's multi-host join. A no-op when nothing asks to join
    (no argument and none of the deployment variables set), as there; asked
    to join a multi-process deployment it raises ``NotImplementedError``:
    the port runs on one card, and multi-GPU ``torch.distributed`` is out of
    scope (ROADMAP, queue A's out-of-scope notes)."""
    asked = [n for n, v in (("coordinator_address", coordinator_address), ("num_processes", num_processes),
                            ("process_id", process_id), ("local_device_ids", local_device_ids)) if v is not None]
    asked += [k for k in _DEPLOYMENT_ENV if k in os.environ]
    if not asked:
        return  # single process: nothing to join
    raise NotImplementedError(
        f"initialize_multihost was asked to join a multi-process deployment ({', '.join(asked)}); the port runs "
        "on one card and multi-GPU torch.distributed is out of scope (ROADMAP, queue A's out-of-scope notes)"
    )


def population_sharding(mesh: Mesh, axis: str = "nodes") -> NamedSharding:
    """Sharding of stacked-population tensors: the leading axis over ``axis``."""
    mesh.check_axis(axis)
    return NamedSharding(mesh, PartitionSpec(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())
