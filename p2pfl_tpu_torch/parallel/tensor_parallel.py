"""Tensor parallelism over the ``model`` axis of a rank mesh: the layout the
JAX package's ``MeshSimulation`` takes on a ``("nodes", "model")`` mesh,
where XLA partitions every kernel on its output dimension. Over a ``nodes``
x ``model`` rank mesh every exchange here runs in the ``model`` axis'
sub-group: the ranks of one population slab.

The rule is ``stacked_spec``'s (``p2pfl_tpu/parallel/simulation.py``): a
leaf of two or more dimensions whose output dimension (flax's last) divides
by W is cut into W contiguous slices of that dimension, rank r holding the
r-th; every other leaf (biases, the norms' scales, a 10-class head at W 4)
stays whole on every rank. :func:`split_dims` finds each port leaf's torch
dimension for flax's last through :mod:`p2pfl_tpu_torch.models.convert`:
dim 0 of a ``Linear`` or ``Conv2d`` weight, dim 1 of an ``Embedding``
table, the last of the MoE's stacked ``wi`` / ``wo``.

The zoo models' shared helpers notice a leaf that a rank holds in part
(:func:`column_group`) and run column-parallel (:func:`column_linear`,
:func:`column_conv`): the input through
:func:`~p2pfl_tpu_torch.parallel.collectives.sum_cotangent` (each rank's
columns give part of the input's cotangent), the product with the local
output columns, then :func:`~p2pfl_tpu_torch.parallel.collectives.
all_gather_dim` on the feature dimension. Every rank then holds every
activation whole and runs everything else, attention included, in full.
The local parameters get exactly their slice of the gradient, and the whole
ones their whole gradient, on every rank.

A reduction over a whole model (a norm, the distances between models) sums
the split leaves' part over the ranks and adds the whole leaves' part once:
:class:`ModelSplit` is bound (:meth:`ModelSplit.bind`) while a population
trains, aggregates and evaluates, and :func:`whole_sq_sum` and
:func:`whole_gram` read it (one process: plain sums, as before).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Dict, Iterator, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from p2pfl_tpu_torch.models.convert import canonical_shape, flax_path, _to_torch_axes
from p2pfl_tpu_torch.parallel.collectives import all_gather_dim, psum, sum_cotangent
from p2pfl_tpu_torch.parallel.mesh import Mesh, PartitionSpec, axis_group

#: The mesh axis whose ranks split the kernels.
MODEL_AXIS = "model"

_ACTIVE: contextvars.ContextVar[Optional["ModelSplit"]] = contextvars.ContextVar("p2pfl_model_split", default=None)


def split_dims(shapes: Mapping[str, Sequence[int]], world: int) -> Dict[str, int]:
    """``{name: torch dimension}`` of the leaves ``stacked_spec`` splits over
    a ``model`` axis of ``world`` ranks (the unstacked leaves' shapes, the
    port's names and layouts); the leaves not named stay whole."""
    dims = {}
    for name, shape in shapes.items():
        flax = canonical_shape(name, shape)
        if world > 1 and len(flax) >= 2 and flax[-1] % world == 0:
            axes = _to_torch_axes(len(shape), flax_path(name)[1])
            dims[name] = len(shape) - 1 if axes is None else axes.index(len(shape) - 1)
    return dims


def column_group(held: int, whole: int, what: str, axis: str = MODEL_AXIS) -> Any:
    """The process group of ``axis`` when a layer holds ``held`` of its
    ``whole`` outputs (a split leaf), None when it holds them all. A split
    leaf outside the ``bind()`` of a mesh whose ``axis`` spans the ranks
    raises ``ValueError``."""
    if held == whole:
        return None
    try:
        group = axis_group(axis)
    except NameError:
        group = None
    if group is None:
        raise ValueError(f"{what} holds {held} of its {whole} outputs: a leaf split over ranks runs only inside the "
                         f"bind() of a mesh whose {axis!r} axis spans them")
    return group


def _rank(group: Any) -> int:
    import torch.distributed as dist

    return dist.get_rank(group)


def _local_bias(bias: Optional[torch.Tensor], n: int, group: Any) -> Optional[torch.Tensor]:
    """This rank's ``n`` entries of a whole bias; the cotangents are summed,
    so every rank gets the bias' whole gradient."""
    if bias is None:
        return None
    return sum_cotangent(bias, group).narrow(0, _rank(group) * n, n)


def column_linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], group: Any) -> torch.Tensor:
    """``F.linear(x, W, b)`` with this rank's output rows of ``W`` (``[out /
    W, in]``) and the whole ``b``: the outputs gathered on the last
    dimension."""
    n = weight.shape[0]
    y = F.linear(sum_cotangent(x, group), weight, _local_bias(bias, n, group))
    return all_gather_dim(y, -1, group)


def column_conv(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], stride: Any, padding: Any,
                group: Any) -> torch.Tensor:
    """``F.conv2d`` (NCHW) with this rank's output channels of ``weight``:
    the outputs gathered on the channel dimension."""
    n = weight.shape[0]
    y = F.conv2d(sum_cotangent(x, group), weight, _local_bias(bias, n, group), stride, padding)
    return all_gather_dim(y, 1, group)


def _map_named(tree: Any, fn) -> Any:
    """``tree`` (dicts, dataclasses, tensors, None) with ``fn(name, t)``
    applied to every tensor held under a dict key; other tensors kept."""
    if isinstance(tree, dict):
        return {k: fn(k, v) if isinstance(v, torch.Tensor) else _map_named(v, fn) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: _map_named(getattr(tree, f.name), fn) for f in dataclasses.fields(tree)})
    return tree


def _specs_named(tree: Any, fn) -> Any:
    """A tree of ``tree``'s structure whose tensors are replaced by ``fn(name,
    t)``, ``name`` the dict key or dataclass field that holds the tensor."""
    if isinstance(tree, dict):
        return {k: fn(k, v) if isinstance(v, torch.Tensor) else _specs_named(v, fn) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: fn(f.name, v) if isinstance(v := getattr(tree, f.name), torch.Tensor)
                             else _specs_named(v, fn) for f in dataclasses.fields(tree)})
    return tree


class ModelSplit:
    """A model's leaves split over the ranks of ``mesh``'s ``model`` axis.

    Args:
        shapes: the whole model's leaf shapes, ``{name: shape}``.
        mesh: a rank mesh whose ``model`` axis spans ranks: alone, or beside
            ``nodes`` (``make_mesh((N, M), ("nodes", "model"))``), where the
            split binds the ``model`` axis' sub-group and this rank's
            ``model`` coordinate, and its gathers and sums stay inside it.
    """

    def __init__(self, shapes: Mapping[str, Sequence[int]], mesh: Mesh) -> None:
        if not mesh.spans(MODEL_AXIS):
            raise ValueError(f"a model split needs a mesh whose {MODEL_AXIS!r} axis spans the ranks, got {mesh!r}")
        self.mesh = mesh
        self.group = mesh.axis_process_group(MODEL_AXIS)
        self.rank, self.world = mesh.axis_rank(MODEL_AXIS), mesh.axis_ranks(MODEL_AXIS)
        self.shapes = {k: tuple(v) for k, v in shapes.items()}
        #: ``{name: torch dimension}`` of the split leaves.
        self.dims = split_dims(self.shapes, self.world)

    def local(self, name: str, t: torch.Tensor, lead: int = 0) -> torch.Tensor:
        """This rank's slice of leaf ``name`` (``lead`` stacked dimensions in
        front), a copy of its own; a whole leaf as it is."""
        d = self.dims.get(name)
        if d is None:
            return t
        n = self.shapes[name][d] // self.world
        return t.narrow(d + lead, self.rank * n, n).clone(memory_format=torch.contiguous_format)

    def shard(self, tree: Any, lead: int = 0) -> Any:
        """This rank's slices of every split leaf of ``tree`` (parameters, or an
        optimizer state whose dicts are keyed by the parameters' names)."""
        return _map_named(tree, lambda k, v: self.local(k, v, lead))

    @torch.no_grad()
    def gather(self, tree: Any, lead: int = 0) -> Any:
        """The whole leaves of ``tree`` (this rank's slices, ``lead`` stacked
        dimensions in front) on every rank. Every rank calls it."""
        return _map_named(tree, lambda k, v: all_gather_dim(v, self.dims[k] + lead, self.group)
                          if k in self.dims else v)

    def state_shards(self, state: Mapping[str, Any], lead: Mapping[str, int]) -> Any:
        """The :class:`~p2pfl_tpu_torch.population.sharding.StateShards` of a
        state held under this split: every split leaf under top-level key
        ``k`` of ``state`` (parameters, or an optimizer state keyed by the
        parameters' names) is this rank's slice of its split dimension,
        after ``lead[k]`` stacked dimensions; every other leaf is whole on
        the ``model`` axis. Where ``nodes`` spans ranks too, a stacked leaf
        (``lead[k]`` 1) is also this rank's slab of its leading axis."""
        from p2pfl_tpu_torch.population.sharding import StateShards

        def spec(name: str, lead_dims: int) -> PartitionSpec:
            axes = [None] * lead_dims
            if lead_dims and self.mesh.spans("nodes"):
                axes[0] = "nodes"
            d = self.dims.get(name)
            return PartitionSpec(*axes) if d is None else PartitionSpec(*axes, *([None] * d), MODEL_AXIS)

        return StateShards(self.mesh, {k: _specs_named(v, lambda name, t, n=lead[k]: spec(name, n))
                                       for k, v in state.items()})

    def sq_sum(self, parts: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """The sum of per-leaf partial sums (``{name: tensor}``, each a sum
        of squares or products over this rank's part of the leaf): the split
        leaves' parts summed over the ranks, the whole leaves' added once."""
        split = [v for k, v in parts.items() if k in self.dims]
        whole = [v for k, v in parts.items() if k not in self.dims]
        return sum(whole, psum(sum(split), self.group) if split else 0)

    @contextlib.contextmanager
    def bind(self) -> Iterator["ModelSplit"]:
        """Bind the mesh's axes and make this split the one
        :func:`whole_sq_sum` and :func:`whole_gram` read."""
        with self.mesh.bind():
            token = _ACTIVE.set(self)
            try:
                yield self
            finally:
                _ACTIVE.reset(token)


def active() -> Optional[ModelSplit]:
    """The :class:`ModelSplit` bound in this context, or None."""
    return _ACTIVE.get()


def whole_sq_sum(parts: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """``sum(parts.values())`` over a whole model: under a bound
    :class:`ModelSplit` the split leaves' parts are summed over the ranks."""
    split = _ACTIVE.get()
    return sum(parts.values()) if split is None else split.sq_sum(parts)


def _flat(stacked: Mapping[str, torch.Tensor], names: Sequence[str]) -> torch.Tensor:
    k = next(iter(stacked.values())).shape[0]
    if not names:
        return torch.zeros((k, 0), dtype=torch.float32, device=next(iter(stacked.values())).device)
    return torch.cat([stacked[n].reshape(k, -1).float() for n in names], dim=1)


def whole_gram(stacked: Mapping[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sq [K], gram [K, K])``: each stacked model's squared L2 norm and
    the models' dot products, over whole models (f32). ``stacked`` holds
    ``[K, ...]`` leaves; under a bound :class:`ModelSplit` the split leaves'
    part is summed over the ranks in one collective."""
    split = _ACTIVE.get()
    names = list(stacked)
    if split is None:
        x = _flat(stacked, names)
        return (x * x).sum(dim=1), x @ x.T
    xs = _flat(stacked, [n for n in names if n in split.dims])
    xw = _flat(stacked, [n for n in names if n not in split.dims])
    k = xs.shape[0]
    part = psum(torch.cat([(xs * xs).sum(dim=1), (xs @ xs.T).reshape(-1)]), split.group)
    return part[:k] + (xw * xw).sum(dim=1), part[k:].reshape(k, k) + xw @ xw.T


def whole_shape(name: str, shape: Sequence[int]) -> Tuple[int, ...]:
    """The whole shape of leaf ``name`` held as ``shape`` here (its own shape
    outside a bound :class:`ModelSplit` or when whole)."""
    split = _ACTIVE.get()
    if split is None or name not in split.dims:
        return tuple(shape)
    return tuple(split.shapes[name])


def local_slice(name: str, t: torch.Tensor) -> torch.Tensor:
    """This rank's slice of the whole leaf-shaped ``t`` of ``name`` under a
    bound :class:`ModelSplit`; ``t`` itself otherwise."""
    split = _ACTIVE.get()
    return t if split is None else split.local(name, t)


__all__ = ["MODEL_AXIS", "ModelSplit", "active", "column_conv", "column_group", "column_linear", "local_slice",
           "split_dims", "whole_gram", "whole_shape", "whole_sq_sum"]
