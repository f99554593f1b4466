"""Ring attention: exact attention over a sequence cut into the shards of a
mesh axis (counterpart of ``p2pfl_tpu/ops/ring_attention.py``).

The JAX package runs it under ``shard_map``: device ``i`` holds chunk ``i`` of
q/k/v, and the kv chunks rotate around the ring with ``ppermute`` while each
device folds the visiting chunk into its queries' online-softmax carry. The
port runs it two ways, by what the axis is
(:func:`p2pfl_tpu_torch.parallel.mesh.axis_group`):

* **Over ranks** (the axis spans a process group): as the JAX package does.
  Rank ``i`` passes its local ``[B, S / n, H, D]`` shard and gets its local
  output; it folds its own chunk first, then makes ``n - 1`` rotations,
  each sending the (k, v) it holds to its left neighbour ``i - 1`` and
  receiving ``i + 1``'s (:func:`p2pfl_tpu_torch.parallel.collectives.
  ppermute`), so the chunk of origin ``(i + r) % n`` arrives at rotation
  ``r`` (the JAX package sends the origin along; here each rank counts it).
  The backward of the blockwise ring is autograd's, the inverse permutes
  carrying dk / dv back towards the rank that owns the chunk.
* **On one process** (a virtual axis): nothing to exchange, so the same
  folds run as a loop. The functions take the *global* ``[B, S, H, D]``
  tensors, cut S into the axis' ``n`` shards
  (:func:`p2pfl_tpu_torch.parallel.mesh.axis_size`), and for shard ``i`` fold
  the chunks in the ring's rotation order ``i, i+1, ..., n-1, 0, ..., i-1``.

Self chunk first keeps the f32 sums in the JAX order and gives every causal
row a real key in its first fold. Under ``causal`` a chunk whose origin is
past ``i`` lies wholly in shard ``i``'s future and is skipped (over ranks it
is still passed on: every rank posts the same sends and receives, forward and
backward). The JAX flash ring skips it too; its blockwise ring folds it,
which is exact to skip: after the self chunk every row's ``m`` is a real
score, so a fully masked chunk gives ``p = exp(MASK - m) = 0`` and ``corr =
1``, leaving the carry and every gradient unchanged. Skipping halves the
scores the blockwise backward keeps.
"""

from __future__ import annotations

from typing import List

import torch

from p2pfl_tpu_torch.ops.attention import (
    blockwise_update,
    finalize_carry,
    flash_chunk_update,
    init_carry,
    remat_vjp,
)
from p2pfl_tpu_torch.parallel.collectives import ppermute, tie
from p2pfl_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size


def _rotation(i: int, n: int, causal: bool) -> List[int]:
    """Origins of the chunks shard ``i`` folds, in the ring's order."""
    return [j for j in ((i + r) % n for r in range(n)) if not (causal and j > i)]


def _ring(q, k, v, n: int, causal: bool, fold) -> torch.Tensor:
    """Cut q/k/v into ``n`` chunks and, for each shard, fold its chunks in
    ring order into a fresh carry with ``fold(carry, q_i, k_j, v_j,
    q_offset, kv_offset)``; returns the finalized global output. At B = 1
    the chunks are views at ``i * s * H * D`` elements into their tensor,
    16-byte aligned for D = 64 as the bf16 kernel's TMA loads need."""
    qs, ks, vs = ([c.contiguous() for c in torch.chunk(t, n, dim=1)] for t in (q, k, v))
    s = qs[0].shape[1]
    outs = []
    for i in range(n):
        carry = init_carry(qs[i].shape, q.device)
        for j in _rotation(i, n, causal):
            carry = fold(carry, qs[i], ks[j], vs[j], i * s, j * s)
        outs.append(finalize_carry(carry, q.dtype))
    return torch.cat(outs, dim=1)


def _ring_ranks(q, k, v, n: int, index: int, group, causal: bool, fold) -> torch.Tensor:
    """This rank's shard of the ring over the ranks of ``group``: its own
    chunk folded first, then ``n - 1`` rotations to the left neighbour,
    each arriving chunk folded with ``fold`` (as :func:`_ring`) unless it
    lies in the future. Differentiable: the last rotation's chunk is tied
    to the output, so its exchange takes part in the backward even where
    no fold reads it."""
    q, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    s = q.shape[1]
    left = [(j, (j - 1) % n) for j in range(n)]
    carry = init_carry(q.shape, q.device)
    for r in range(n):
        origin = (index + r) % n
        if r:
            kc, vc = ppermute((kc, vc), left, group)
        if not (causal and origin > index):
            carry = fold(carry, q, kc, vc, index * s, origin * s)
    out = finalize_carry(carry, q.dtype)
    return tie(out, kc, vc) if n > 1 and torch.is_grad_enabled() else out


def _ring_blockwise(q, k, v, n: int, causal: bool, block_k: int, index: int = 0, group=None) -> torch.Tensor:
    """The blockwise ring (differentiable through autograd); over the ranks
    of ``group`` when one is given."""
    fold = lambda c, qi, kj, vj, q_off, kv_off: blockwise_update(  # noqa: E731
        c, qi, kj, vj, causal, block_k, q_off, kv_off)
    if group is not None:
        return _ring_ranks(q, k, v, n, index, group, causal, fold)
    return _ring(q, k, v, n, causal, fold)


class _RingFlash(torch.autograd.Function):
    """Ring forward through the carry kernel, one launch per folded chunk;
    the backward rematerializes through the blockwise ring and returns its
    gradients (``_ring_flash_bwd``), so the forward keeps only q, k, v. Over
    ranks the rematerialized ring exchanges its chunks again, and the
    inverse permutes of its backward bring dk / dv home."""

    @staticmethod
    def forward(ctx, q, k, v, n: int, causal: bool, block_k: int, index: int, group):
        ctx.save_for_backward(q, k, v)
        ctx.n, ctx.causal, ctx.block_k, ctx.index, ctx.group = n, causal, block_k, index, group
        fold = lambda c, qi, kj, vj, q_off, kv_off: flash_chunk_update(  # noqa: E731
            c, qi, kj, vj, q_off, kv_off, causal, block_k=block_k)
        if group is not None:
            return _ring_ranks(q, k, v, n, index, group, causal, fold)
        return _ring(q, k, v, n, causal, fold)

    @staticmethod
    def backward(ctx, g):
        n, causal, block_k, index, group = ctx.n, ctx.causal, ctx.block_k, ctx.index, ctx.group
        dq, dk, dv = remat_vjp(
            lambda q, k, v: _ring_blockwise(q, k, v, n, causal, block_k, index, group), ctx.saved_tensors, g)
        return dq, dk, dv, None, None, None, None, None


def ring_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, axis_name: str,
    causal: bool = True, block_k: int = 512, impl: str = "blockwise",
) -> torch.Tensor:
    """Exact attention over a sequence sharded on ``axis_name``.

    Args:
        q, k, v: over ranks, this rank's local ``[B, S_local, H, D]`` shard
            (rank ``i`` holding positions ``[i * S_local, (i + 1) *
            S_local)``), as inside the JAX package's ``shard_map``; on one
            process, the global ``[B, S, H, D]`` tensors, S divisible by the
            axis' size ``n``.
        axis_name: a mesh axis bound by a ``sequence_parallel_*`` wrapper
            (:meth:`~p2pfl_tpu_torch.parallel.mesh.Mesh.bind`); ``NameError``
            outside one.
        causal: apply a global causal mask.
        block_k: key-block size of the blockwise fold.
        impl: ``"blockwise"`` (differentiable loop of blockwise folds) or
            ``"flash"`` (the carry kernel per chunk; backward through the
            blockwise ring).

    Returns:
        The output in the layout of ``q``: local over ranks, global on one
        process.
    """
    if impl not in ("blockwise", "flash"):
        raise ValueError(f"impl must be 'blockwise' or 'flash', got {impl!r}")
    if block_k < 1:
        raise ValueError(f"block_k must be >= 1, got {block_k}")
    n, group = axis_size(axis_name), axis_group(axis_name)
    if (group is None and q.shape[1] % n) or k.shape[1] != q.shape[1] or v.shape != k.shape:
        raise ValueError(
            f"ring_attention: q/k/v must share a sequence length divisible by the {axis_name!r} "
            f"axis size {n}, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    index = axis_index(axis_name)
    if impl == "flash":
        return _RingFlash.apply(q, k, v, n, causal, block_k, index, group)
    return _ring_blockwise(q, k, v, n, causal, block_k, index, group)
