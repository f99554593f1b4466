"""Meshes over one device, or over the ranks of a process group
(counterpart of ``p2pfl_tpu/parallel/mesh.py``).

One process: a mesh axis does not split work across devices. It names how
many *virtual* shards a wrapper cuts a dimension into (the ring's ``"seq"``
axis folds its chunks one after another on the card; a population's
``"nodes"`` axis is the multiple it is padded to). Code that needs an axis'
size — :func:`p2pfl_tpu_torch.ops.ring_attention.ring_attention`, as
``jax.lax.psum(1, axis_name)`` does under ``shard_map`` — asks
:func:`axis_size`, which answers only inside :meth:`Mesh.bind`, and raises
for an unbound name as JAX does outside ``shard_map``.

Ranks: :func:`initialize_multihost` joins a ``torch.distributed`` process
group of W processes ("ranks"), each driving one device: ``cuda:LOCAL_RANK``
when the host has a card for every local rank (backend NCCL), the one card
shared when it does not, or the CPU when the caller asks for it (backend
gloo for both). :func:`make_mesh` then builds a mesh whose axes span the W
ranks (:attr:`Mesh.rank_axes`; :attr:`Mesh.rank_axis` where one axis spans
them all), as a JAX mesh spans W devices:

* ``"nodes"``: its size is a multiple of W, and rank r holds the r-th
  contiguous part of it (:meth:`Mesh.slab`), the slab of the population
  that :class:`~p2pfl_tpu_torch.parallel.simulation.MeshSimulation` keeps
  there;
* ``"seq"`` or ``"stage"``: its size is W, one shard to a rank, as the JAX
  package has one to a device. Rank r holds sequence shard r (the ring,
  :mod:`p2pfl_tpu_torch.parallel.sequence`) or pipeline stage r
  (:mod:`p2pfl_tpu_torch.parallel.pipeline`); :func:`axis_index` gives r
  inside :meth:`Mesh.bind`, and the shards talk through
  :mod:`p2pfl_tpu_torch.parallel.collectives`;
* ``"expert"`` or ``"model"`` (``{"expert": W}``, ``{"nodes": 1, "model":
  W}``): its size is W too. Rank r holds the r-th part of each split weight
  and every rank holds the activations whole: the MoE's experts r X / W ..
  (r + 1) X / W (:func:`~p2pfl_tpu_torch.models.moe.shard_moe_params`), or
  the r-th slice of every kernel's output dimension
  (:mod:`p2pfl_tpu_torch.parallel.tensor_parallel`, which
  :class:`~p2pfl_tpu_torch.parallel.simulation.MeshSimulation` holds its
  population in);
* ``"batch"``: its size is W, one part of the batch a rank.

Two axes may span the ranks together where the JAX package runs that
layout (:data:`RANK_PAIRS`): ``nodes`` x ``model`` (a population's slabs
with every kernel split, ``MeshSimulation`` on ``make_mesh((N, M),
("nodes", "model"))``) and ``batch`` x ``seq`` (the sequence-parallel LM
with its batch split too). The ranks are laid out row-major over the axes
in the mesh's order, as the JAX package reshapes its devices: on
``make_mesh((N, M), ("nodes", "model"))`` rank r sits at ``(r // M, r %
M)``. The ``model``, ``batch`` and ``seq`` axes hold one shard a rank (their
size is their rank count); ``nodes`` holds ``W / M`` rank rows and its size
is a multiple of that. Each axis gets a process group of its own
(:meth:`Mesh.axis_process_group`, :func:`axis_group`): the ranks that share
every other coordinate. Every rank creates every such group, in one order
(``dist.new_group`` is a collective of the whole world). Other pairs
(``nodes`` x ``seq``, ``nodes`` x ``stage``, ``seq`` x ``expert``) run in no
program of the JAX package and raise ``NotImplementedError`` naming their
ROADMAP item.

:func:`make_mesh`, :func:`population_sharding`, :func:`replicated` and
:func:`initialize_multihost` keep the JAX package's API; :class:`PartitionSpec`
and :class:`NamedSharding` stand in for JAX's.
"""

from __future__ import annotations

import contextlib
import contextvars
import datetime
import logging
import os
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Mapping, Optional, Sequence, Tuple

import torch

from p2pfl_tpu_torch.device import DeviceLike, resolve_device

log = logging.getLogger("p2pfl_tpu_torch")

# Axis name -> the mesh that binds it in this context (innermost wins).
_BOUND: contextvars.ContextVar[Mapping[str, "Mesh"]] = contextvars.ContextVar("p2pfl_bound_axes", default={})

#: The pairs of axes that span the ranks together: the 2-D layouts the JAX
#: package runs (``MeshSimulation`` on ``nodes`` x ``model``; the
#: sequence-parallel LM with a ``batch_axis``).
RANK_PAIRS = (("nodes", "model"), ("batch", "seq"))
#: The ROADMAP item that takes the other pairs across ranks.
RANK_MESH_PAIRS_ITEM = ("A12 (the other 2-D rank meshes: nodes beside seq or stage, seq beside expert; no program "
                        "of the JAX package runs them)")
#: The axes that may span the ranks.
RANK_AXES = ("nodes", "seq", "stage", "expert", "model", "batch")

# (axis, global ranks) -> the process group :meth:`Mesh._subgroups` made for
# it: every rank asks for the same groups in the same order, so a mesh built
# again reuses them (``new_group`` is a collective of the whole world).
_SUBGROUPS: Dict[Tuple[str, Tuple[int, ...]], Any] = {}


class Mesh:
    """Named axes over one torch device, or over the ranks of a process group.

    Args:
        axes: axis name -> size (>= 1), e.g. ``{"seq": 8}``. On one process
            each axis is a number of virtual shards; over ranks one axis
            spans them (:attr:`rank_axis`: ``"nodes"``, a multiple of the
            world size, or ``"seq"`` / ``"stage"`` / ``"expert"`` /
            ``"model"`` / ``"batch"``, the world size) and the others are 1,
            or a pair of :data:`RANK_PAIRS` spans them together
            (:attr:`rank_axes`).
        device: where the wrappers put their inputs (``"cuda"`` by default;
            raises when no card is visible, like every entry point). Over
            ranks: this rank's device.
        group: the ``torch.distributed`` process group whose ranks the mesh
            spans (None: one process, as before). A pair of axes spans the
            whole world.
    """

    def __init__(self, axes: Mapping[str, int], device: DeviceLike = "cuda", group: Any = None) -> None:
        if not axes:
            raise ValueError("a mesh needs at least one axis")
        for name, size in axes.items():
            if not isinstance(name, str) or not name:
                raise ValueError(f"axis names must be non-empty strings, got {name!r}")
            if int(size) != size or size < 1:
                raise ValueError(f"axis {name!r} must have a positive integer size, got {size!r}")
        self.shape: Dict[str, int] = {name: int(size) for name, size in axes.items()}
        self.device: torch.device = resolve_device(device)
        self.group = group
        self.rank, self.world = 0, 1
        #: The axes that span the ranks, in the mesh's order, each with its
        #: number of ranks (empty on one process).
        self.rank_shape: Dict[str, int] = {}
        #: The axis that spans all the ranks (None on one process and where
        #: a pair spans them).
        self.rank_axis: Optional[str] = None
        self._coords: Dict[str, int] = {}
        self._groups: Dict[str, Any] = {}
        if group is not None:
            import torch.distributed as dist

            self.rank, self.world = dist.get_rank(group), dist.get_world_size(group)
            self.rank_shape = self._check_rank_axes()
            if len(self.rank_shape) == 1:
                self.rank_axis = next(iter(self.rank_shape))
            left = self.rank
            for name in reversed(self.rank_shape):  # row-major: the last axis varies fastest
                left, self._coords[name] = divmod(left, self.rank_shape[name])
            self._groups = self._subgroups() if len(self.rank_shape) > 1 else {self.rank_axis: group}

    def _check_rank_axes(self) -> Dict[str, int]:
        """The axes that span the ranks and their rank counts; raises for a
        layout no PR has taken across ranks."""
        above = {name: size for name, size in self.shape.items() if size > 1}
        unknown = [name for name in above if name not in RANK_AXES]
        if unknown:
            raise ValueError(f"axis {unknown[0]!r} cannot span ranks: the axes that do are {RANK_AXES}, got "
                             f"{self.shape}")
        if len(above) > 1:
            pair = next((p for p in RANK_PAIRS if set(p) == set(above)), None)
            if pair is None:
                raise NotImplementedError(
                    f"axes {above} across {self.world} ranks: the pairs {RANK_PAIRS} span the ranks together, no "
                    f"other; ROADMAP queue A item {RANK_MESH_PAIRS_ITEM}")
            inner = pair[1]
            if self.world % above[inner]:
                raise ValueError(f"a {inner!r} axis of {above[inner]} does not divide {self.world} ranks")
            outer = self.world // above[inner]  # the ranks along the other axis
            if pair[0] == "nodes" and above["nodes"] % outer:
                raise ValueError(f"a 'nodes' axis over {outer} rank rows must be a multiple of {outer}, got "
                                 f"{self.shape}")
            if pair[0] != "nodes" and above[pair[0]] != outer:
                raise ValueError(f"axes {above} hold {above[pair[0]] * above[inner]} ranks, the group has "
                                 f"{self.world}")
            if outer > 1:
                if self.world != dist_world():
                    raise ValueError(f"a pair of axes spans the whole world: the mesh's group has {self.world} of "
                                     f"{dist_world()} ranks")
                return {n: (outer if n == pair[0] else above[inner]) for n in self.shape if n in pair}
            above = {inner: above[inner]}  # one rank row: the inner axis alone spans the ranks
        over = next(iter(above), None) or next((n for n in RANK_AXES if n in self.shape), None)
        if over is None:
            raise ValueError(f"a mesh over {self.world} ranks needs one of the axes {RANK_AXES}, got {self.shape}")
        size = self.shape[over]
        if over == "nodes" and size % self.world:
            raise ValueError(f"a mesh over {self.world} ranks needs a 'nodes' axis that is a multiple of "
                             f"{self.world}, got {self.shape}")
        if over != "nodes" and size != self.world:
            raise ValueError(f"a {over!r} axis over {self.world} ranks holds one shard a rank: its size must be "
                             f"{self.world}, got {self.shape}")
        return {over: self.world}

    def _subgroups(self) -> Dict[str, Any]:
        """This rank's process group on each ranked axis: the ranks that share
        its other coordinates, in order along the axis. Every rank creates
        every axis' groups, in the same order."""
        import itertools
        import math

        import torch.distributed as dist

        from p2pfl_tpu_torch.parallel.collectives import label_group

        names = list(self.rank_shape)
        counts = [self.rank_shape[n] for n in names]
        strides = [math.prod(counts[i + 1:]) for i in range(len(names))]
        mine = {}
        for i, name in enumerate(names):
            others = [range(c) if j != i else range(1) for j, c in enumerate(counts)]
            for base in itertools.product(*others):
                start = sum(b * s for b, s in zip(base, strides))
                ranks = tuple(dist.get_global_rank(self.group, start + k * strides[i]) for k in range(counts[i]))
                key = (name, ranks)
                if key not in _SUBGROUPS:
                    _SUBGROUPS[key] = dist.new_group(list(ranks))
                if dist.get_rank() in ranks:
                    mine[name] = _SUBGROUPS[key]
                    label_group(mine[name], name)
        return mine

    @property
    def rank_axes(self) -> Tuple[str, ...]:
        """The axes that span the ranks, in the mesh's order (empty on one process)."""
        return tuple(self.rank_shape)

    def spans(self, name: str) -> bool:
        """Whether axis ``name`` spans ranks."""
        return name in self.rank_shape

    def axis_ranks(self, name: str) -> int:
        """The number of ranks along axis ``name`` (1 where it does not span ranks)."""
        return self.rank_shape.get(name, 1)

    def axis_rank(self, name: str) -> int:
        """This rank's coordinate on axis ``name`` (0 where it does not span ranks)."""
        return self._coords.get(name, 0)

    def axis_process_group(self, name: str) -> Any:
        """The process group of axis ``name``: the ranks along it that share
        this rank's other coordinates (the mesh's group where one axis spans
        them all), or None where the axis does not span ranks."""
        return self._groups.get(name)

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def ranked(self) -> bool:
        """Whether axes (:attr:`rank_axes`) span the ranks of a process group."""
        return self.group is not None

    def process_index(self) -> int:
        """This process' rank (0 on one process), as ``jax.process_index()``."""
        return self.rank

    def process_count(self) -> int:
        """The number of ranks (1 on one process), as ``jax.process_count()``."""
        return self.world

    def slab(self, n: int) -> Tuple[int, int]:
        """``[lo, hi)``: this rank's contiguous part of a population of ``n``
        (a multiple of the ranks along ``nodes``), by its ``nodes``
        coordinate; ``(0, n)`` on one process."""
        if self.ranked and not self.spans("nodes"):
            raise ValueError(f"this mesh spans its ranks with {self.rank_axes}, not with 'nodes': it holds no "
                             "slab of a population")
        rows = self.axis_ranks("nodes")
        if n % rows:
            raise ValueError(f"a population of {n} does not split over {rows} ranks")
        per = n // rows
        lo = self.axis_rank("nodes") * per
        return lo, lo + per

    def check_axis(self, name: str) -> int:
        """The size of axis ``name``; raises ``ValueError`` if the mesh has none."""
        if name not in self.shape:
            raise ValueError(f"mesh has no axis {name!r} (axes {self.axis_names})")
        return self.shape[name]

    @contextlib.contextmanager
    def bind(self) -> Iterator["Mesh"]:
        """Bind this mesh's axis names for :func:`axis_size`,
        :func:`axis_index` and :func:`axis_group` while the block runs."""
        token = _BOUND.set({**_BOUND.get(), **{name: self for name in self.shape}})
        try:
            yield self
        finally:
            _BOUND.reset(token)

    def __repr__(self) -> str:
        ranks = f", rank={self.rank}, world={self.world}, over={self.rank_shape}" if self.ranked else ""
        return f"Mesh({self.shape}, device={str(self.device)!r}{ranks})"


def _bound(name: str) -> Mesh:
    bound = _BOUND.get()
    if name not in bound:
        raise NameError(f"unbound axis name: {name!r} (bind a Mesh with that axis first)")
    return bound[name]


def axis_size(name: str) -> int:
    """Size of a bound mesh axis; ``NameError`` outside a binding of ``name``."""
    return _bound(name).shape[name]


def axis_index(name: str) -> int:
    """This process' position on a bound mesh axis (``jax.lax.axis_index``):
    its coordinate on an axis that spans ranks, 0 on any other (one process
    holds every virtual shard, from position 0). ``NameError`` outside a
    binding of ``name``."""
    return _bound(name).axis_rank(name)


def axis_group(name: str) -> Any:
    """The process group of a bound axis (:meth:`Mesh.axis_process_group`:
    on a pair of ranked axes, the sub-group along ``name``), or None where
    the axis' shards are virtual (one process). ``NameError`` outside a
    binding of ``name``."""
    return _bound(name).axis_process_group(name)


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
    Every shard of this process lives on ``mesh.device``."""

    mesh: Mesh
    spec: PartitionSpec

    @property
    def device(self) -> torch.device:
        return self.mesh.device


def _joined() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def dist_world() -> int:
    """The size of the joined world (1 when none is joined)."""
    import torch.distributed as dist

    return dist.get_world_size() if _joined() else 1


def make_mesh(
    shape: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("nodes", "model"),
    devices: Optional[Sequence[DeviceLike]] = None,
) -> Mesh:
    """Build a mesh (the JAX package's arguments).

    On one process the mesh spans one device and each axis is a number of
    virtual shards (default: 1 for every axis). In a joined process group
    (:func:`initialize_multihost`) one axis spans the W ranks: by default
    the first, at size W, the other axes 1. A ``"nodes"`` size must be a
    multiple of W, a ``"seq"``, ``"stage"``, ``"expert"`` or ``"model"`` size
    W (``make_mesh((W,), ("seq",))``: one sequence shard a rank;
    ``make_mesh((1, W), ("nodes", "model"))``: a W-th of every kernel a rank).

    Args:
        shape: per-axis sizes.
        axis_names: mesh axis names, default ``("nodes", "model")``.
        devices: this process' one device (default ``["cuda"]``, or the
            rank's device in a joined group); more than one raises: every
            process drives one device.
    """
    import torch.distributed as dist

    joined = _joined()
    names = tuple(axis_names)
    devices = list(devices) if devices is not None else [rank_device() if joined else "cuda"]
    if len(devices) != 1:
        raise ValueError(f"the port's mesh spans one device per process, got {len(devices)}: start one process "
                         "per device and join them with initialize_multihost")
    shape = tuple(shape) if shape is not None else ((dist.get_world_size() if joined else 1),) + (1,) * (
        len(names) - 1)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} does not match axis names {names}")
    return Mesh(dict(zip(names, shape)), device=devices[0], group=dist.group.WORLD if joined else None)


#: The environment a multi-process deployment announces itself by: the JAX
#: package's list, and the variables ``torchrun`` sets.
_DEPLOYMENT_ENV = ("JAX_COORDINATOR_ADDRESS", "TPU_WORKER_HOSTNAMES", "CLOUD_TPU_TASK_ID",
                   "MEGASCALE_COORDINATOR_ADDRESS")
_TORCHRUN_ENV = ("MASTER_ADDR", "WORLD_SIZE", "RANK")

#: What :func:`initialize_multihost` chose for this process: ``device``,
#: ``backend``, ``rank``, ``world`` (None before it joined).
JOINED: Optional[Dict[str, Any]] = None


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if os.environ.get(name, "") != "":
            return int(os.environ[name])
    return None


def rank_device() -> torch.device:
    """This rank's device: the one :func:`initialize_multihost` chose, else
    (a group joined some other way) its rule for a card over ``LOCAL_RANK``
    / ``LOCAL_WORLD_SIZE``: ``cuda:LOCAL_RANK`` when the host has a card for
    every local rank, else the one card, shared."""
    if JOINED is not None:
        return JOINED["device"]
    return _pick_device("cuda", None, _env_int("LOCAL_RANK", "RANK") or 0,
                        _env_int("LOCAL_WORLD_SIZE", "WORLD_SIZE") or 1)


def _pick_device(device: DeviceLike, local_device_ids: Optional[Sequence[int]], local_rank: int,
                 local_world: int) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    resolve_device(dev)  # raises when no card is visible
    if local_device_ids:
        return torch.device("cuda", int(local_device_ids[0]))
    if dev.index is not None:
        return dev
    return torch.device("cuda", local_rank if torch.cuda.device_count() >= local_world else 0)


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    *,
    device: DeviceLike = "cuda",
    timeout_s: float = 600.0,
) -> Optional[Dict[str, Any]]:
    """Join this process to a multi-process deployment: a
    ``torch.distributed`` process group of ``num_processes`` ranks.

    The JAX package's arguments, in its order: ``coordinator_address``
    (``host:port`` or a ``tcp://`` URL; rank 0 listens there),
    ``num_processes`` (W) and ``process_id`` (this rank); without them the
    group comes from ``JAX_COORDINATOR_ADDRESS`` with ``JAX_NUM_PROCESSES``
    / ``JAX_PROCESS_ID``, or from the variables ``torchrun`` sets
    (``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE`` /
    ``LOCAL_RANK``, ``env://``). ``local_device_ids[0]`` pins the card.

    The device: ``cuda:LOCAL_RANK`` when the host has a card for every local
    rank, the one card shared when it has fewer, the CPU when ``device="cpu"``
    asks for it, as the tests do. The backend is chosen explicitly and logged: NCCL when
    every local rank has a card of its own, gloo on the CPU or when ranks
    share a card (NCCL refuses two ranks on one GPU). A backend that fails
    to initialize raises; nothing falls back. Every
    collective waits at most ``timeout_s``.

    Idempotent (a second call returns what the first chose), and a no-op
    returning None when nothing asks to join (no argument and none of the
    deployment variables set), as in the JAX package. Returns
    ``{"device", "backend", "rank", "world"}``.
    """
    global JOINED
    import torch.distributed as dist

    if _joined():
        return JOINED
    asked = [n for n, v in (("coordinator_address", coordinator_address), ("num_processes", num_processes),
                            ("process_id", process_id), ("local_device_ids", local_device_ids)) if v is not None]
    asked += [k for k in (*_DEPLOYMENT_ENV, *_TORCHRUN_ENV) if k in os.environ]
    if not asked:
        return None  # single process: nothing to join
    coordinator = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    world = num_processes if num_processes is not None else _env_int("JAX_NUM_PROCESSES", "WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("JAX_PROCESS_ID", "RANK")
    if coordinator is not None:
        init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    elif "MASTER_ADDR" in os.environ:
        init_method = "env://"
    else:
        raise ValueError(f"initialize_multihost was asked to join ({', '.join(asked)}) but has no coordinator: "
                         "pass coordinator_address, or set MASTER_ADDR / MASTER_PORT as torchrun does")
    if world is None or rank is None:
        raise ValueError(f"initialize_multihost needs the world size and this rank (num_processes / process_id, "
                         f"or WORLD_SIZE / RANK); got {world} / {rank}")
    if not 0 <= rank < world:
        raise ValueError(f"process_id {rank} is outside a world of {world}")
    # One host unless torchrun says otherwise: local ranks are the ranks.
    local_rank = _env_int("LOCAL_RANK")
    local_world = _env_int("LOCAL_WORLD_SIZE") or world
    dev = _pick_device(device, local_device_ids, rank if local_rank is None else local_rank, local_world)
    own_card = dev.type == "cuda" and (bool(local_device_ids) or torch.cuda.device_count() >= local_world)
    chosen = "nccl" if own_card else "gloo"
    why = ("a card for each rank" if own_card else
           "the CPU" if dev.type == "cpu" else f"{local_world} ranks share {torch.cuda.device_count()} card(s)")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    log.info("initialize_multihost: rank %d of %d on %s, backend %s (%s), %s", rank, world, dev, chosen, why,
             init_method)
    dist.init_process_group(chosen, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=float(timeout_s)))
    JOINED = {"device": dev, "backend": chosen, "rank": rank, "world": world}
    return JOINED


def shutdown_multihost() -> None:
    """Leave the process group :func:`initialize_multihost` joined (a no-op
    when none was joined)."""
    global JOINED
    if _joined():
        import torch.distributed as dist

        from p2pfl_tpu_torch.parallel import collectives

        dist.destroy_process_group()
        collectives._LABELS.clear()
    _SUBGROUPS.clear()
    JOINED = None


def population_sharding(mesh: Mesh, axis: str = "nodes") -> NamedSharding:
    """Sharding of stacked-population tensors: the leading axis over ``axis``."""
    mesh.check_axis(axis)
    return NamedSharding(mesh, PartitionSpec(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())
