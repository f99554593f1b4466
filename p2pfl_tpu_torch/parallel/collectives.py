"""Collectives over a rank mesh's process group: what the JAX package's
``nodes`` axis gets from XLA inside its round, here as explicit
``torch.distributed`` calls.

* :func:`all_gather` — a dict of stacked tensors along the leading axis, in
  rank order, where each rank may hold a different number of rows;
* :func:`broadcast_tree` — a dict of tensors from one rank to every rank;
* :func:`broadcast` and :func:`all_reduce` — small tensors, in place.

A tree travels packed: its rows, leaf after leaf, in one ``uint8`` buffer of
``[rows, bytes a row]`` (bit-exact for every dtype), unpacked on arrival.
:func:`all_gather` moves every rank's buffer as one broadcast from that rank
(none from a rank without rows), so each rank receives exactly the rows
there are, however unevenly the ranks hold them. NCCL takes CUDA tensors;
gloo takes CPU tensors and, for ``broadcast``, ``all_reduce`` and
``all_gather``, CUDA tensors too (it stages them through host memory
itself; checked on an H100 with two gloo ranks sharing the card), so no
call here copies to the host. ``STATS`` counts the bytes every
:func:`all_gather` received in this process.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence, Tuple

import torch

Tree = Dict[str, torch.Tensor]

#: Per-process counter: ``all_gather_bytes``, the bytes of every row
#: gathered, this rank's own included.
STATS: Dict[str, int] = {"all_gather_bytes": 0}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


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
        dist.broadcast(buf, src=dist.get_global_rank(group, src) if group is not None else src, group=group)
        parts.append(buf)
    STATS["all_gather_bytes"] += sum(counts) * width
    if not parts:
        return {name: torch.empty((0, *shape), dtype=dtype, device=device) for name, dtype, shape, _ in layout}
    return _unpack(torch.cat(parts), layout)


def broadcast_tree(tree: Tree, src: int, group: Any = None) -> Tree:
    """Rank ``src``'s leaves on every rank. Every rank passes leaves of the
    same names, dtypes and shapes (the other ranks' values are not read)."""
    dist = _dist()
    flat = {k: v.reshape((1, *v.shape)) for k, v in tree.items()}
    buf = _pack(flat, 1, next(iter(tree.values())).device)
    dist.broadcast(buf, src=dist.get_global_rank(group, src) if group is not None else src, group=group)
    return {k: v[0] for k, v in _unpack(buf, _layout(flat)).items()}


def broadcast(t: torch.Tensor, src: int = 0, group: Any = None) -> torch.Tensor:
    """``t`` takes rank ``src``'s value on every rank (in place); returns it."""
    dist = _dist()
    dist.broadcast(t, src=dist.get_global_rank(group, src) if group is not None else src, group=group)
    return t


def all_reduce(t: torch.Tensor, op: str = "sum", group: Any = None) -> torch.Tensor:
    """``t`` reduced over the ranks (``"sum"``, ``"max"`` or ``"min"``), in
    place; returns it."""
    dist = _dist()
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}
    if op not in ops:
        raise ValueError(f"unknown reduction {op!r}: use {sorted(ops)}")
    dist.all_reduce(t, op=ops[op], group=group)
    return t


__all__ = ["STATS", "all_gather", "all_reduce", "broadcast", "broadcast_tree", "reset_stats"]
