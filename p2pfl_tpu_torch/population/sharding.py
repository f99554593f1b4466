"""Rule-driven partition specs and shard / gather function trees for stacked
populations (counterpart of ``p2pfl_tpu/population/sharding.py``).

A list of ``(regex, PartitionSpec)`` rules is matched against the
'/'-joined path of every leaf of a tree; the first ``re.search`` hit gives
the leaf's spec, and the spec tree becomes per-leaf placement functions.

Names: the rules match the JAX package's paths. A port parameter dict is
keyed by torch names (``"Dense_0.weight"``, ``[out, in]``), so
:func:`tree_path_names` gives each of its leaves the JAX package's path
(``params/Dense_0/kernel``) through the mapping of
:mod:`p2pfl_tpu_torch.models.convert`, and one rule list selects the same
leaves in both packages. Layouts: a spec's axes refer to the port's own
layout. A stacked Dense ``weight`` is ``[N, out, in]`` and a Conv
``weight`` ``[N, out, in, kh, kw]``, so the tensor-parallel rule of
:func:`population_partition_rules` puts ``"model"`` on axis 1, the output
axis the JAX package splits as the last axis of ``[N, in, out]``.

On one process every shard lives on the mesh's device: a shard function
moves a leaf there, a gather function returns it as host numpy. Over the
ranks of a rank mesh (:func:`~p2pfl_tpu_torch.parallel.mesh.make_mesh` after
``initialize_multihost``) a leaf whose spec puts ``"nodes"`` on its leading
axis is a population ``[N, ...]``: its shard function keeps this rank's slab
(:meth:`~p2pfl_tpu_torch.parallel.mesh.Mesh.slab`), and its gather function
builds the full ``[N, ...]`` from every rank's slab (a collective: every
rank calls it) — :func:`gather_population` does that for whole trees, for
snapshots and ``MeshSimulation.state_dict``; :func:`gather_node` gives
every rank one node's row, for ``final_model``.

Sharded checkpoints: a :class:`StateShards` describes how a rank holds a
state tree (a spec tree over it: a leaf split over the ranks holds the
rank's part of one dimension, the others are whole on every rank), and
:func:`recut` assembles the part a rank needs from the parts another layout
saved, so a step written by W ranks restores at W' ranks or in one process.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from p2pfl_tpu_torch.models.convert import flax_path
from p2pfl_tpu_torch.parallel.mesh import Mesh, PartitionSpec as PS, make_mesh

_ARRAY = (torch.Tensor, np.ndarray)


def _is_port_params(tree: Any) -> bool:
    """A flat ``{torch parameter name: tensor}`` dict (every key dotted)."""
    return (isinstance(tree, Mapping) and bool(tree)
            and all(isinstance(k, str) and "." in k and isinstance(v, _ARRAY) for k, v in tree.items()))


def _tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """Map ``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``): dicts, lists, tuples and dataclasses are walked, a
    :class:`PartitionSpec` and anything else is a leaf; ``None`` stays."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PS):
        out = [_tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else type(tree)(out)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: _tree_map(fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest))
                             for f in dataclasses.fields(tree)})
    return fn(tree, *rest)


def tree_path_names(tree: Any, prefix: str = "") -> Any:
    """A tree of the same structure whose leaves are '/'-joined key paths,
    the name space the rules match. A port parameter dict's leaves get the
    JAX package's paths (``params/Dense_0/kernel``,
    ``params/block0/attn/qkv/kernel``); other dict keys, list indices and
    dataclass fields join as they are."""

    def join(*parts: str) -> str:
        return "/".join(p for p in parts if p)

    if tree is None:
        return None
    if _is_port_params(tree):
        return {k: join(prefix, "params", *flax_path(k)[0]) for k in tree}
    if isinstance(tree, Mapping):
        return {k: tree_path_names(v, join(prefix, str(k))) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PS):
        out = [tree_path_names(v, join(prefix, str(i))) for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else type(tree)(out)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: tree_path_names(getattr(tree, f.name), join(prefix, f.name))
                             for f in dataclasses.fields(tree)})
    return prefix


def match_partition_rules(rules: Sequence[Tuple[str, PS]], params: Any, strict: bool = True) -> Any:
    """Map a tree to a tree of :class:`PartitionSpec` by regex rules.

    Each leaf's path (:func:`tree_path_names`) is tested against ``rules``
    in order; the first ``re.search`` hit wins. Scalars and one-element
    leaves are never partitioned. With ``strict`` (the default) an
    unmatched leaf raises; ``strict=False`` replicates it.
    """
    compiled = [(re.compile(rule), spec) for rule, spec in rules]

    def spec_for(leaf: Any, path: str) -> PS:
        shape = tuple(getattr(leaf, "shape", ()))
        if len(shape) == 0 or int(np.prod(shape)) == 1:
            return PS()  # don't partition scalar values
        for rule, spec in compiled:
            if rule.search(path) is not None:
                return spec
        if strict:
            raise ValueError(f"partition rule not found for param: {path}")
        return PS()

    return _tree_map(spec_for, params, tree_path_names(params))


def population_partition_rules(model_parallel: bool = False) -> List[Tuple[str, PS]]:
    """The stacked-population rule set: every leaf's leading (population)
    axis over ``"nodes"``; with ``model_parallel`` the kernels (``.../kernel``
    paths) also split their output axis, axis 1 in the port's layout, over
    ``"model"``."""
    if model_parallel:
        return [(r"(^|/)kernel$", PS("nodes", "model")), (r".*", PS("nodes"))]
    return [(r".*", PS("nodes"))]


def _over_ranks(spec: PS, mesh: Mesh) -> bool:
    """Whether a leaf of ``spec`` is a population split over the ranks of
    ``mesh``'s ``nodes`` axis."""
    return mesh.spans("nodes") and len(spec) > 0 and spec[0] == "nodes"


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def make_shard_and_gather_fns(partition_specs: Any, mesh: Optional[Mesh] = None) -> Tuple[Any, Any]:
    """Per-leaf placement function trees mirroring ``partition_specs``:
    ``shard_fns`` move a leaf (a tensor or numpy array) onto the mesh's
    device, ``gather_fns`` return a leaf as host numpy (bf16 widened to f32,
    which numpy holds exactly). Over a rank mesh a leaf split on ``"nodes"``
    is a population: shard keeps this rank's slab of ``[N, ...]``, gather
    builds the full ``[N, ...]`` from every rank's slab. ``mesh`` defaults
    to :func:`make_mesh`'s."""
    mesh = mesh if mesh is not None else make_mesh()

    def make_shard_fn(spec: PS) -> Callable[[Any], torch.Tensor]:
        def shard_fn(tensor: Any) -> torch.Tensor:
            t = torch.as_tensor(tensor)
            if _over_ranks(spec, mesh):
                lo, hi = mesh.slab(t.shape[0])
                t = t[lo:hi]
            return t.to(mesh.device)

        return shard_fn

    def make_gather_fn(spec: PS) -> Callable[[Any], np.ndarray]:
        def gather_fn(tensor: Any) -> np.ndarray:
            if isinstance(tensor, torch.Tensor):
                if _over_ranks(spec, mesh):
                    tensor = gather_population({"leaf": tensor}, mesh)["leaf"]
                return _host(tensor)
            return np.asarray(tensor)

        return gather_fn

    return _tree_map(make_shard_fn, partition_specs), _tree_map(make_gather_fn, partition_specs)


def _leaves(tree: Any) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    _tree_map(lambda leaf: out.append(leaf) if isinstance(leaf, torch.Tensor) else None, tree)
    return out


def _rebuild(tree: Any, leaves: List[torch.Tensor]) -> Any:
    it = iter(leaves)
    return _tree_map(lambda leaf: next(it) if isinstance(leaf, torch.Tensor) else leaf, tree)


def gather_population(tree: Any, mesh: Mesh) -> Any:
    """The full ``[N, ...]`` of every tensor leaf of ``tree`` (each this rank's
    ``[N / W, ...]`` slab) on this rank's device, in one collective over the
    ``nodes`` axis' ranks (its sub-group where ``model`` spans ranks too); the
    tree itself where ``nodes`` spans none. Every rank calls it."""
    from p2pfl_tpu_torch.parallel import collectives

    leaves = _leaves(tree)
    if not mesh.spans("nodes") or not leaves:
        return tree
    got = collectives.all_gather({str(i): t for i, t in enumerate(leaves)},
                                 [leaves[0].shape[0]] * mesh.axis_ranks("nodes"),
                                 group=mesh.axis_process_group("nodes"))
    return _rebuild(tree, [got[str(i)] for i in range(len(leaves))])


def gather_node(tree: Any, node: int, mesh: Mesh, n: int) -> Any:
    """Node ``node``'s row of every tensor leaf of ``tree`` (this rank's slab
    of a population of ``n``) on every rank, broadcast from the rank that
    holds it along the ``nodes`` axis. Every rank calls it."""
    from p2pfl_tpu_torch.parallel import collectives

    if not mesh.spans("nodes"):
        return _tree_map(lambda leaf: leaf[node] if isinstance(leaf, torch.Tensor) else leaf, tree)
    lo, hi = mesh.slab(n)
    per = hi - lo
    leaves = _leaves(tree)
    mine = {str(i): t[node - lo] if lo <= node < hi else t[0] for i, t in enumerate(leaves)}
    got = collectives.broadcast_tree(mine, src=node // per, group=mesh.axis_process_group("nodes"))
    return _rebuild(tree, [got[str(i)] for i in range(len(leaves))])


# --- a state tree's shards over ranks (sharded checkpoints) --------------------------


@dataclasses.dataclass(frozen=True)
class StateShards:
    """How this rank holds a state tree over the ranks of ``mesh``: each
    leaf a box of the whole leaf.

    ``specs`` is a tree of :class:`PartitionSpec` of the state tree's
    structure. A leaf whose spec names a ranked axis of the mesh at position
    ``d`` is split on dimension ``d`` into as many equal contiguous parts as
    the axis has ranks, the rank at coordinate c on that axis holding the
    c-th (:func:`part_range`): the ``nodes`` axis' slabs of a stacked
    population, ``ModelSplit``'s slices of a kernel, or both (a slab on
    ``nodes`` times a slice on ``model``). A leaf is whole along every
    ranked axis its spec does not name (replicated there)."""

    mesh: Mesh
    specs: Any

    def split_dims(self, spec: PS) -> List[Tuple[int, str]]:
        """``[(dimension, axis), ...]``: where a leaf of ``spec`` is split over
        the ranks (empty for a leaf whole on every rank)."""
        return [(d, axis) for d, axis in enumerate(tuple(spec)) if axis is not None and self.mesh.spans(axis)]


def part_range(whole: int, part: int, parts: int) -> Tuple[int, int]:
    """``[lo, hi)`` of part ``part`` of ``parts`` equal contiguous parts of a
    dimension of size ``whole``."""
    if whole % parts:
        raise ValueError(f"a dimension of {whole} does not split into {parts} equal parts")
    per = whole // parts
    return part * per, (part + 1) * per


def population_shards(state: Mapping[str, Any], mesh: Mesh, whole: Sequence[str] = ()) -> StateShards:
    """The shards of a population state over a ``nodes`` rank mesh: every
    tensor under a top-level key of ``state`` is this rank's slab, split on
    its leading axis, except under the keys named in ``whole`` (the history
    ring, SCAFFOLD's and the server optimizer's global state), which every
    rank holds whole."""
    return StateShards(mesh, {k: _tree_map(lambda leaf, spec=(PS() if k in whole else PS("nodes")): spec, v)
                              for k, v in state.items()})


Box = Sequence[Tuple[int, int]]


def recut(pieces: Sequence[Tuple[Box, torch.Tensor]], box: Box, what: str) -> torch.Tensor:
    """The region ``box`` (``[lo, hi)`` per dimension) of a leaf, assembled
    from saved ``pieces``: ``(piece box, tensor)`` pairs that partition the
    leaf (a shard of each saving rank, or the whole leaf). Only the pieces
    that overlap ``box`` are read, and only their overlap is copied (a
    memory-mapped piece is read where it overlaps). Raises ``ValueError``
    when the pieces do not cover ``box``."""
    shape = [hi - lo for lo, hi in box]
    out: Optional[torch.Tensor] = None
    covered = 0
    for pbox, t in pieces:
        if len(pbox) != len(box):
            raise ValueError(f"{what}: a saved part has {len(pbox)} dimensions, the leaf {len(box)}")
        if out is None:
            out = torch.empty(shape, dtype=t.dtype)
        inter = [(max(a, c), min(b, d)) for (a, b), (c, d) in zip(box, pbox)]
        if any(lo >= hi for lo, hi in inter):
            continue
        src, dst = t, out
        for d, (lo, hi) in enumerate(inter):
            src = src.narrow(d, lo - pbox[d][0], hi - lo)
            dst = dst.narrow(d, lo - box[d][0], hi - lo)
        dst.copy_(src)
        covered += src.numel()
    if out is None or covered != out.numel():
        raise ValueError(f"{what}: the saved parts do not cover {[tuple(b) for b in box]}")
    return out


__all__ = ["StateShards", "gather_node", "gather_population", "make_shard_and_gather_fns", "match_partition_rules",
           "part_range", "population_partition_rules", "population_shards", "recut", "tree_path_names"]
