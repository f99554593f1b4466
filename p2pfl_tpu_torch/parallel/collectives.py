"""Collectives over a rank mesh's process group: what the JAX package's
mesh axes get from XLA, here as explicit ``torch.distributed`` calls.

The ``nodes`` axis (the round's population):

* :func:`all_gather` — a dict of stacked tensors along the leading axis, in
  rank order, where each rank may hold a different number of rows;
* :func:`gather_ordered` — :func:`all_gather` of rows each held by one
  rank, put back in an order the caller names (a round's committee, a
  window's members);
* :func:`broadcast_tree` — a dict of tensors from one rank to every rank;
* :func:`broadcast` and :func:`all_reduce` — small tensors, in place;
* :func:`broadcast_ints` and :func:`all_agree` — what a sharded
  checkpoint's save and restore agree on: rank 0's save token and list of
  steps, and whether a step loaded on every rank. They move no population
  rows.

A tree travels packed: its rows, leaf after leaf, in one ``uint8`` buffer of
``[rows, bytes a row]`` (bit-exact for every dtype), unpacked on arrival.
:func:`all_gather` moves every rank's buffer as one broadcast from that rank
(none from a rank without rows), so each rank receives exactly the rows
there are, however unevenly the ranks hold them. NCCL takes CUDA tensors;
gloo takes CPU tensors and, for ``broadcast``, ``all_reduce`` and
``all_gather``, CUDA tensors too (it stages them through host memory
itself; checked on an H100 with two gloo ranks sharing the card), so no
call here copies to the host.

The ``seq`` and ``stage`` axes (the ring and the pipeline), differentiable,
each with its gradient rule in its docstring:

* :func:`ppermute` — ``jax.lax.ppermute``: send along ``(source,
  destination)`` pairs, every rank's sends and receives posted together
  (``batch_isend_irecv``), so a ring cannot deadlock; its backward is the
  inverse permute. gloo has no point-to-point for CUDA tensors, so with
  gloo a CUDA tensor goes through host memory, copied explicitly: the
  backend chooses the route (:func:`p2p_route`), logged once;
* :func:`psum` and :func:`pmean` — ``jax.lax.psum`` / ``pmean`` of a
  per-rank value, replicated on every rank;
* :func:`replicate` — rank ``src``'s value on every rank (the pipeline's
  masked psum of the last stage's outputs);
* :func:`sum_cotangent` — the transpose of a replicated input that only
  some ranks read;
* :func:`tie` — keeps an exchange whose result nothing reads in the
  backward.

The ``expert`` and ``model`` axes (a weight split over the ranks, the
activations replicated) add one exchange:

* :func:`all_gather_dim` — every rank's tensor concatenated along one
  dimension, in rank order; its backward is this rank's slice of the
  cotangent. A column-parallel layer is ``sum_cotangent`` of its input, the
  product with this rank's output columns, then ``all_gather_dim``; the
  MoE's experts sum their partial combine with :func:`psum`.

Every rank must post the same exchanges in the same order, forward and
backward: each rank runs the same program on its shard, as under
``shard_map``. ``STATS`` counts the bytes every :func:`all_gather`,
:func:`ppermute` and :func:`all_gather_dim` received in this process, the
bytes every :func:`psum` and :func:`sum_cotangent` summed, and those of
every :func:`all_reduce` and broadcast. ``AXIS_STATS`` splits the same
counts by the group they moved in: a pair of ranked axes gives each axis a
sub-group (:meth:`~p2pfl_tpu_torch.parallel.mesh.Mesh.axis_process_group`),
counted under the axis' name; every other group under ``"world"``.

Every call takes the process group it runs in (``None``: the world). A
``src`` is a rank of that group, turned into a global rank where
``torch.distributed`` wants one.
"""

from __future__ import annotations

import logging
import math
import weakref
from typing import Any, Dict, List, Sequence, Tuple, Union

import torch

Tree = Dict[str, torch.Tensor]
Pairs = Sequence[Tuple[int, int]]

log = logging.getLogger("p2pfl_tpu_torch")

#: Per-process counters: ``all_gather_bytes``, the bytes of every row
#: gathered, this rank's own included; ``ppermute_bytes``, the bytes that
#: arrived at this rank through :func:`ppermute`, forward and backward;
#: ``gather_dim_bytes``, the bytes of every tensor :func:`all_gather_dim`
#: assembled, this rank's own slice included; ``sum_bytes``, the bytes of
#: every tensor summed over the ranks by :func:`psum` (forward) and
#: :func:`sum_cotangent` (backward); ``reduce_bytes``, of every tensor
#: :func:`all_reduce` reduced; ``broadcast_bytes``, of every tensor
#: :func:`broadcast`, :func:`broadcast_tree` and :func:`replicate` moved.
STATS: Dict[str, int] = {"all_gather_bytes": 0, "ppermute_bytes": 0, "gather_dim_bytes": 0, "sum_bytes": 0,
                         "reduce_bytes": 0, "broadcast_bytes": 0}
#: ``STATS`` by the group the bytes moved in: ``{label: {key: bytes}}``, the
#: label an axis' name for a sub-group a mesh made, else ``"world"``.
AXIS_STATS: Dict[str, Dict[str, int]] = {}
# Sub-group -> the axis it runs along (set by the mesh that made it).
_LABELS: Dict[Any, str] = {}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0
    AXIS_STATS.clear()


def label_group(group: Any, axis: str) -> None:
    """Count the bytes of ``group``'s exchanges under ``axis`` in ``AXIS_STATS``."""
    _LABELS[group] = axis


def _count(key: str, nbytes: int, group: Any) -> None:
    STATS[key] += nbytes
    per = AXIS_STATS.setdefault(_LABELS.get(group, "world"), dict.fromkeys(STATS, 0))
    per[key] += nbytes


def _dist():
    import torch.distributed as dist

    return dist


def _layout(tree: Tree) -> List[Tuple[str, torch.dtype, torch.Size, int]]:
    """``(name, dtype, row shape, bytes a row)`` of each leaf, in order."""
    return [(k, v.dtype, v.shape[1:], math.prod(v.shape[1:]) * v.element_size()) for k, v in tree.items()]


def _pack(tree: Tree, rows: int, device: torch.device) -> torch.Tensor:
    """The leaves' first ``n`` rows side by side as bytes, ``[rows, R]`` (rows
    past the leaves' count stay zero)."""
    layout = _layout(tree)
    buf = torch.zeros((rows, sum(nb for *_, nb in layout)), dtype=torch.uint8, device=device)
    off = 0
    for (name, _, _, nb), leaf in zip(layout, tree.values()):
        n = leaf.shape[0]
        if n and nb:
            buf[:n, off:off + nb] = leaf.detach().contiguous().reshape(n, -1).view(torch.uint8)
        off += nb
    return buf


def _unpack(buf: torch.Tensor, layout: List[Tuple[str, torch.dtype, torch.Size, int]]) -> Tree:
    out: Tree = {}
    off, n = 0, buf.shape[0]
    for name, dtype, shape, nb in layout:
        # A copy of its own: a byte column at an odd offset cannot be viewed as a wider dtype.
        out[name] = buf[:, off:off + nb].clone(memory_format=torch.contiguous_format).view(dtype).reshape((n, *shape))
        off += nb
    return out


def all_gather(tree: Tree, counts: Sequence[int], group: Any = None) -> Tree:
    """Concatenate every rank's ``[n_r, ...]`` leaves along axis 0, in rank
    order, on every rank. ``counts`` holds every rank's ``n_r`` (all leaves
    of one rank share it); every rank passes the same names, dtypes and row
    shapes."""
    dist = _dist()
    world = dist.get_world_size(group)
    first = next(iter(tree.values()))
    device = first.device
    counts = [int(c) for c in counts]
    if len(counts) != world:
        raise ValueError(f"counts has {len(counts)} entries for {world} ranks")
    layout = _layout(tree)
    me = dist.get_rank(group)
    if counts[me] != first.shape[0]:
        raise ValueError(f"rank {me} holds {first.shape[0]} rows, counts say {counts[me]}")
    width = sum(nb for *_, nb in layout)
    parts = []
    for src, n in enumerate(counts):
        if n == 0:
            continue
        buf = _pack(tree, n, device) if src == me else torch.empty((n, width), dtype=torch.uint8, device=device)
        dist.broadcast(buf, src=_global(group, src), group=group)
        parts.append(buf)
    _count("all_gather_bytes", sum(counts) * width, group)
    if not parts:
        return {name: torch.empty((0, *shape), dtype=dtype, device=device) for name, dtype, shape, _ in layout}
    return _unpack(torch.cat(parts), layout)


def gather_ordered(local: Tree, owner: Sequence[int], group: Any = None) -> Tuple[Tree, List[int]]:
    """Every row of a sequence on every rank, in the sequence's order, and
    the rows each rank brought: ``owner[i]`` is the rank that holds row
    ``i``, and ``local`` holds this rank's rows in sequence order (``[0,
    ...]`` leaves of the same layout where it holds none). One
    :func:`all_gather`; the rank-major result is put back in order."""
    world = _dist().get_world_size(group)
    counts = [list(owner).count(r) for r in range(world)]
    stack = all_gather(local, counts, group=group)
    order = [pos for r in range(world) for pos, o in enumerate(owner) if o == r]
    if order != sorted(order):
        perm = torch.as_tensor(sorted(range(len(order)), key=order.__getitem__),
                               device=next(iter(stack.values())).device)
        stack = {k: v.index_select(0, perm) for k, v in stack.items()}
    return stack, counts


def broadcast_tree(tree: Tree, src: int, group: Any = None) -> Tree:
    """Rank ``src``'s leaves on every rank. Every rank passes leaves of the
    same names, dtypes and shapes (the other ranks' values are not read)."""
    dist = _dist()
    flat = {k: v.reshape((1, *v.shape)) for k, v in tree.items()}
    buf = _pack(flat, 1, next(iter(tree.values())).device)
    dist.broadcast(buf, src=_global(group, src), group=group)
    _count("broadcast_bytes", buf.numel(), group)
    return {k: v[0] for k, v in _unpack(buf, _layout(flat)).items()}


def broadcast(t: torch.Tensor, src: int = 0, group: Any = None) -> torch.Tensor:
    """``t`` takes rank ``src``'s value on every rank (in place); returns it."""
    dist = _dist()
    dist.broadcast(t, src=_global(group, src), group=group)
    _count("broadcast_bytes", t.numel() * t.element_size(), group)
    return t


def all_reduce(t: torch.Tensor, op: str = "sum", group: Any = None) -> torch.Tensor:
    """``t`` reduced over the ranks (``"sum"``, ``"max"`` or ``"min"``), in
    place; returns it."""
    dist = _dist()
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}
    if op not in ops:
        raise ValueError(f"unknown reduction {op!r}: use {sorted(ops)}")
    dist.all_reduce(t, op=ops[op], group=group)
    _count("reduce_bytes", t.numel() * t.element_size(), group)
    return t


def broadcast_ints(values: Sequence[int], src: int = 0, group: Any = None, device: Any = "cpu") -> List[int]:
    """Rank ``src``'s list of ints on every rank (its length, then its
    values: two broadcasts of int64 tensors on ``device``; the other ranks'
    ``values`` are not read)."""
    n = broadcast(torch.tensor([len(values)], dtype=torch.int64, device=device), src, group)
    vals = torch.zeros(int(n.item()), dtype=torch.int64, device=device)
    if _dist().get_rank(group) == src:
        vals.copy_(torch.tensor([int(v) for v in values], dtype=torch.int64))
    return [int(v) for v in broadcast(vals, src, group).tolist()] if vals.numel() else []


def all_agree(ok: bool, group: Any = None, device: Any = "cpu") -> bool:
    """Whether ``ok`` holds on every rank: an ``all_reduce`` min of one flag."""
    return bool(all_reduce(torch.tensor([int(bool(ok))], dtype=torch.int64, device=device), "min", group).item())


def _global(group: Any, rank: int) -> int:
    return _dist().get_global_rank(group, rank) if group is not None else rank


# --- the seq and stage axes: differentiable exchanges ------------------------

#: (backend, device type) pairs whose route was logged, and the groups that
#: have run one collective on every rank before their first point-to-point.
_ROUTES_LOGGED: set = set()
_P2P_READY: "weakref.WeakSet" = weakref.WeakSet()


def p2p_route(device: torch.device, group: Any = None, op: str = "ppermute") -> str:
    """How ``op`` (:func:`ppermute` or :func:`all_gather_dim`) moves a
    tensor on ``device`` in ``group``: ``"direct"`` (NCCL from card to card,
    gloo between CPU tensors) or ``"host"`` (gloo with CUDA tensors: the
    tensor is copied to host memory, exchanged, and copied back; gloo has
    no point-to-point for them). Chosen by the backend, never by catching an
    error; logged once per op, backend and device type."""
    backend = str(_dist().get_backend(group))
    route = "host" if backend == "gloo" and device.type == "cuda" else "direct"
    if (op, backend, device.type) not in _ROUTES_LOGGED:
        _ROUTES_LOGGED.add((op, backend, device.type))
        log.info("%s: backend %s, %s tensors, route %s%s", op, backend, device.type, route,
                 " (gloo with CUDA tensors: copies through host memory)" if route == "host" else "")
    return route


def _check_pairs(perm: Pairs, world: int) -> List[Tuple[int, int]]:
    pairs = [(int(s), int(d)) for s, d in perm]
    srcs, dsts = [s for s, _ in pairs], [d for _, d in pairs]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError(f"ppermute: a rank may send once and receive once, got {pairs}")
    if any(not 0 <= r < world for r in srcs + dsts):
        raise ValueError(f"ppermute: pairs {pairs} name a rank outside a world of {world}")
    return pairs


def _exchange(tensors: List[torch.Tensor], pairs: List[Tuple[int, int]], group: Any) -> List[torch.Tensor]:
    """Send ``tensors`` to this rank's destination in ``pairs`` and return
    what arrived from its source (zeros where nothing arrives), every send
    and receive posted at once."""
    dist = _dist()
    me = dist.get_rank(group)
    dst = [d for s, d in pairs if s == me]
    src = [s for s, d in pairs if d == me]
    if dst == [me]:  # a rank that sends to itself keeps its tensors
        return [t.detach().clone() for t in tensors]
    if not dst and not src:
        return [torch.zeros_like(t) for t in tensors]
    pg = group if group is not None else dist.group.WORLD
    if pg not in _P2P_READY:
        # NCCL wants the first call in a group to involve every rank; every
        # rank of an SPMD program reaches its first exchange, so all take part.
        _P2P_READY.add(pg)
        dist.all_reduce(torch.zeros(1, device=tensors[0].device), group=group)
    host = p2p_route(tensors[0].device, group) == "host"
    ops = []
    if dst:
        sends = [t.detach().contiguous() for t in tensors]
        ops += [dist.P2POp(dist.isend, t.cpu() if host else t, _global(group, dst[0]), group) for t in sends]
    recvs = [torch.empty(t.shape, dtype=t.dtype, device="cpu" if host else t.device) for t in tensors] if src else []
    ops += [dist.P2POp(dist.irecv, t, _global(group, src[0]), group) for t in recvs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if not src:
        return [torch.zeros_like(t) for t in tensors]
    _count("ppermute_bytes", sum(t.numel() * t.element_size() for t in recvs), group)
    return [r.to(t.device) for r, t in zip(recvs, tensors)] if host else recvs


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pairs, group, n: int, *args):
        ctx.pairs, ctx.group, ctx.n, ctx.extra = pairs, group, n, len(args) - n
        return tuple(_exchange(list(args[:n]), pairs, group))

    @staticmethod
    def backward(ctx, *grads):
        inverse = [(d, s) for s, d in ctx.pairs]
        return (None, None, None, *_exchange(list(grads), inverse, ctx.group), *([None] * ctx.extra))


def ppermute(
    x: Union[torch.Tensor, Sequence[torch.Tensor]], perm: Pairs, group: Any = None, *,
    anchors: Sequence[torch.Tensor] = (),
) -> Union[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """``jax.lax.ppermute`` over the ranks of ``group``: each ``(source,
    destination)`` pair of ``perm`` sends the source's ``x`` (a tensor, or
    a tuple of tensors moved together) to the destination; returns what
    arrived, zeros on a rank that receives nothing. Every rank calls it with
    the same ``perm`` and tensors of the same shapes and dtypes (a rank
    that sends nothing passes a placeholder of the shape it receives).

    Gradient rule: the backward is the inverse permute, the cotangent of
    what arrived sent back to the rank it came from, so the cotangent of
    each rank's ``x`` is what its destination sends back (zeros on a rank
    that sent nothing). ``anchors`` (tensors that require grad; they get no
    gradient) keep the exchange in the backward on a rank whose ``x`` needs
    none, such as a pipeline stage that only receives this tick: its
    cotangent must still travel back to the sender.
    """
    single = isinstance(x, torch.Tensor)
    tensors = [x] if single else list(x)
    pairs = _check_pairs(perm, _dist().get_world_size(group))
    out = _PPermute.apply(pairs, group, len(tensors), *tensors, *anchors)
    return out[0] if single else out


def _sum(t: torch.Tensor, group: Any) -> torch.Tensor:
    """A contiguous copy of ``t`` summed over the ranks, counted in ``STATS``."""
    out = t.detach().clone(memory_format=torch.contiguous_format)
    _dist().all_reduce(out, group=group)
    _count("sum_bytes", out.numel() * out.element_size(), group)
    return out


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return _sum(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum(t: torch.Tensor, group: Any = None) -> torch.Tensor:
    """``jax.lax.psum``: the sum of every rank's ``t``, on every rank.

    Gradient rule: the identity. Every rank computes the same value from the
    replicated sum, and the cotangent each rank's own copy gives it is
    taken as that rank's share. A leaf that each rank applies to its own
    shard before the sum (the sequence-parallel LM's parameters) then gets
    its part of the gradient on each rank, and the train step sums those
    parts over the ranks once before the optimizer; this is the JAX
    package's gradient for parameters replicated across the shards.
    """
    return _PSum.apply(t, group)


def pmean(t: torch.Tensor, group: Any = None) -> torch.Tensor:
    """``jax.lax.pmean``: :func:`psum` divided by the world size.

    Gradient rule: :func:`psum`'s identity, then the mean's ``1 / W``: each
    rank's ``t`` gets ``g / W``. A leaf applied after the mean (the ring
    classifier's head) sees the replicated value, so every rank gets its
    whole gradient.
    """
    return psum(t, group) / _dist().get_world_size(group)


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, src: int, group):
        ctx.owner = _dist().get_rank(group) == src
        out = t.detach().clone(memory_format=torch.contiguous_format)
        _dist().broadcast(out, src=_global(group, src), group=group)
        _count("broadcast_bytes", out.numel() * out.element_size(), group)
        return out

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.owner else torch.zeros((), dtype=g.dtype, device=g.device).expand_as(g)), None, None


def replicate(t: torch.Tensor, src: int, group: Any = None) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank: the JAX pipeline's masked psum
    ``psum(t * (rank == src))``, moved as one broadcast (the other ranks'
    ``t`` is a placeholder of the same shape and dtype; its values are not
    read).

    Gradient rule: the masked psum's. The cotangent passes to ``t`` on rank
    ``src`` (the identity) and is zero on every other rank.
    """
    return _Replicate.apply(t, src, group)


class _SumCotangent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


def sum_cotangent(t: torch.Tensor, group: Any = None) -> torch.Tensor:
    """``t`` unchanged, read by some ranks only (the pipeline's input, fed by
    the first stage).

    Gradient rule: the cotangents of every rank are summed, so each rank gets
    the whole gradient of ``t`` and of the replicated leaves that made it.
    This is the transpose of a replicated (``P()``) input to the JAX
    package's ``shard_map``. Every rank calls it, and its backward runs
    after every exchange that reads ``t``.
    """
    return _SumCotangent.apply(t, group)


class _Tie(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, *extras):
        ctx.extras = [(e.shape, e.dtype, e.device, e.requires_grad) for e in extras]
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        zeros = [torch.zeros((), dtype=dt, device=dev).expand(shape) if rg else None
                 for shape, dt, dev, rg in ctx.extras]
        return (g, *zeros)


def tie(t: torch.Tensor, *extras: torch.Tensor) -> torch.Tensor:
    """``t`` unchanged; when its backward runs, every tensor of ``extras``
    gets a zero cotangent. An exchange whose result nothing reads on this
    rank (the ring's last rotation under ``causal``, a pipeline stage's
    sends) is not reached by autograd otherwise, yet its backward must run
    on every rank, since the neighbour posts the matching exchange."""
    return _Tie.apply(t, *extras)


# --- the expert and model axes: a weight split over the ranks ------------------


def _gather_dim(t: torch.Tensor, dim: int, group: Any) -> torch.Tensor:
    dist = _dist()
    src = t.detach().contiguous()
    host = p2p_route(src.device, group, "all_gather_dim") == "host"
    if host:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    _count("gather_dim_bytes", out.numel() * out.element_size(), group)
    return out.to(t.device) if host else out


class _AllGatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim: int, group):
        ctx.dim, ctx.n = dim, t.shape[dim]
        ctx.lo = _dist().get_rank(group) * ctx.n
        return _gather_dim(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.lo, ctx.n), None, None


def all_gather_dim(t: torch.Tensor, dim: int, group: Any = None) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim``, in rank order, on every
    rank (``jax.lax.all_gather(..., tiled=True)``). Every rank passes a
    tensor of the same shape and dtype. With gloo a CUDA tensor goes through
    host memory (:func:`p2p_route`).

    Gradient rule: this rank's slice of the cotangent (the rows of ``dim``
    its ``t`` filled), not a sum over the ranks. That is the transpose only
    because everything computed from the gathered tensor is replicated over
    the ranks, so every rank holds the same cotangent: the column-parallel
    layers of a model whose activations every rank holds whole. A consumer
    that differs between the ranks would need the cotangents summed first.
    """
    return _AllGatherDim.apply(t, dim, group)


__all__ = ["AXIS_STATS", "STATS", "all_agree", "all_gather", "all_gather_dim", "all_reduce", "broadcast",
           "broadcast_ints", "broadcast_tree", "gather_ordered", "label_group", "p2p_route", "pmean", "ppermute",
           "psum", "replicate", "reset_stats", "sum_cotangent", "tie"]
