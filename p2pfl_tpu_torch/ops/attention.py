"""Attention: the dense reference, the blockwise online-softmax fold, the
flash kernels' plain versions, and ``flash_attention`` with its
FlashAttention-2 gradient.

Counterpart of ``p2pfl_tpu/ops/attention.py``. All public functions take
``[batch, seq, heads, head_dim]`` ("BSHD") tensors, like the JAX package, and
the causal mask compares *global* positions: ``q_offset`` / ``kv_offset`` give
the position of the first row of q / k, so ring attention can fold chunks of
one long sequence.

The flash path has four kernels (``csrc/``, bound in :mod:`._kernels`): the
forward, written with or without the per-row logsumexp, the dq kernel, the
dk/dv kernel, and the carry fold that ring attention runs once per kv chunk
(bf16 on the tensor cores in ``flash_fwd_sm90.cu`` and ``flash_bwd_sm90.cu``,
below head size 64 ``flash_fwd_narrow_sm90.cu``, ``flash_bwd_narrow_sm90.cu``
and ``flash_carry_narrow_sm90.cu``, at head sizes 128 and 256
``flash_fwd_wide_sm90.cu`` and ``flash_bwd_wide_sm90.cu``, and above 256
``flash_fwd_grouped_sm90.cu`` and ``flash_bwd_grouped_sm90.cu``; the carry
above 64 ``flash_carry_grouped_sm90.cu``; f32 on the CUDA cores in
``flash_attn.cu``, above head size 512 ``flash_chunked.cu``). Each has a plain PyTorch version
here with the same arithmetic — inputs upcast to f32, q scaled in f32, the
causal mask writes :data:`DEFAULT_MASK_VALUE`, ``l`` clamped at 1e-30 — that
the CPU tests hold against the JAX package and that the card's smoke run
holds each kernel against. The one rounding the bf16 tensor-core kernels
add, the f32 operand of their second product (P in the forward and the
carry fold; dS, P^T and dS^T in the backward) split into two bf16 halves, is
bounded by :func:`plain_flash_row_mass`, :func:`plain_flash_chunk_mass` and
:func:`plain_flash_grad_mass`. :func:`flash_forward`,
:func:`flash_backward_dq`, :func:`flash_backward_dkv` and
:func:`flash_chunk_update` pick between them by where the tensors live: a
CPU tensor takes the plain version, a CUDA tensor launches the kernel (or
raises), anything else raises. Under a cost count (:mod:`.cost`) each of
them is one operation of its analytic work (:func:`attention_cost`) on
either device.

The online-softmax carry is ``(m, l, acc)``: running row max ``m [B, H, Sq]``,
denominator ``l [B, H, Sq]`` and unnormalized output ``acc [B, Sq, H, D]``,
all f32. The blockwise fold and the carry kernel share it.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch

from p2pfl_tpu_torch.device import DeviceLike
from p2pfl_tpu_torch.ops import _kernels, cost

Carry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def _causal_mask(scores: torch.Tensor, q_offset: int = 0, kv_offset: int = 0) -> torch.Tensor:
    """Mask ``scores [..., Sq, Sk]`` where the global q position < the global
    kv position (``q_offset`` / ``kv_offset``: positions of row 0)."""
    sq, sk = scores.shape[-2], scores.shape[-1]
    q_pos = q_offset + torch.arange(sq, device=scores.device)[:, None]
    k_pos = kv_offset + torch.arange(sk, device=scores.device)[None, :]
    return torch.where(q_pos >= k_pos, scores, torch.full_like(scores, DEFAULT_MASK_VALUE))


def dense_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
    q_offset: int = 0, kv_offset: int = 0,
) -> torch.Tensor:
    """Materialized-softmax attention (reference implementation).

    Scores are f32 products of the inputs; the probabilities are cast back
    to the value dtype before the second product, as in the JAX package.
    ``q_offset`` / ``kv_offset``: global position of the first row of q / k.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        s = _causal_mask(s, q_offset, kv_offset)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).to(q.dtype)


# --- the online-softmax carry and the blockwise fold ---------------------------


def init_carry(q_shape: tuple, device: DeviceLike) -> Carry:
    """Fresh carry for queries of shape ``[B, Sq, H, D]``: ``m`` = -inf,
    ``l`` = 0, ``acc`` = 0."""
    b, sq, h, d = q_shape
    m = torch.full((b, h, sq), -math.inf, dtype=torch.float32, device=device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=device)
    acc = torch.zeros((b, sq, h, d), dtype=torch.float32, device=device)
    return m, l, acc


def finalize_carry(carry: Carry, dtype: torch.dtype) -> torch.Tensor:
    """Normalize a carry into the attention output ``acc / max(l, 1e-30)``."""
    _, l, acc = carry
    return (acc / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]).to(dtype)


def _fold(carry: Carry, qf: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
          q_offset: int, kv_offset: int) -> Carry:
    """Fold one key block into the carry; ``qf`` is q in f32, pre-scaled."""
    m, l, acc = carry
    s = torch.einsum("bqhd,bkhd->bhqk", qf, k.float())
    if causal:
        s = _causal_mask(s, q_offset, kv_offset)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = corr * l + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return m_new, l, corr.transpose(1, 2)[..., None] * acc + pv


def blockwise_update(
    carry: Carry, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
    block_k: int, q_offset: int, kv_offset: int,
) -> Carry:
    """Fold one key/value chunk into a carry, ``block_k`` keys at a time (the
    JAX package's ``lax.scan`` becomes a loop; a shorter tail block last).

    Differentiable: autograd keeps each block's scores and probabilities.
    """
    sk = k.shape[1]
    block_k = min(block_k, sk)
    qf = q.float() * (1.0 / math.sqrt(q.shape[-1]))
    for k0 in range(0, sk, block_k):
        carry = _fold(carry, qf, k[:, k0:k0 + block_k], v[:, k0:k0 + block_k], causal,
                      q_offset, kv_offset + k0)
    return carry


def blockwise_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
    block_k: int = 512, q_offset: int = 0, kv_offset: int = 0,
) -> torch.Tensor:
    """Online-softmax attention over key blocks: never holds the ``[Sq, Sk]``
    scores of more than one block."""
    carry = blockwise_update(init_carry(q.shape, q.device), q, k, v, causal, block_k,
                             q_offset, kv_offset)
    return finalize_carry(carry, q.dtype)


# --- plain versions of the flash kernels -------------------------------------


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """``[B,H,Sq,Sk]`` f32 scores ``(q * scale) . k`` with the causal mask."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    return _causal_mask(s) if causal else s


def plain_flash_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: ``(out [B,Sq,H,D], lse [B,H,Sq])``."""
    s = _scores(q, k, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()) / l.squeeze(-1).transpose(1, 2)[..., None]
    lse = (m + torch.log(l)).squeeze(-1)
    return out.to(q.dtype), lse


def plain_flash_row_mass(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> torch.Tensor:
    """``[B,Sq,H,D]`` f32 ``sum_j (p_j / l) |v_j|``: each output element's
    absolute weighted mass. The bf16 forward kernel multiplies P split as
    ``P_hi + P_lo`` (two bf16 halves, within 2^-17 P of P), so its output may
    differ from the plain version's by a small multiple of this mass beyond
    the output's own bf16 rounding."""
    s = _scores(q, k, causal)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float().abs())


def _probs_and_dscores(q, k, v, do, lse, delta, causal):
    p = torch.exp(_scores(q, k, causal) - lse[..., None])  # masked entries -> exactly 0
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None])


def plain_flash_grad_mass(
    q, k, v, do, lse, delta, causal: bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """f32 ``(dq_mass, dk_mass, dv_mass)``, shaped like ``(q, k, v)``: each
    gradient element's absolute weighted mass, ``scale * W @ |K|``,
    ``scale * W^T @ |Q|`` and ``P^T @ |dO|`` with
    ``W = |dS| + 2^-5 P (|dO| @ |V|^T + |delta|)``.

    The bf16 backward kernels multiply dS, dS^T and P^T split as
    ``X_hi + X_lo`` (two bf16 halves, within 2^-17 X of X), so their
    gradients may differ from the plain versions' by a small multiple of
    ``|dS|`` (``P``) times the other factor, beyond their own bf16 rounding.
    The second term of ``W`` is the f32 rounding floor of ``dS = P (dP -
    delta)`` itself: where dP and delta cancel (a row that sees only its own
    key has P = 1 and out = v, so dS is exactly 0) both sides return f32
    noise of the size of one rounding of the sums ``dO . V`` and ``delta``,
    which ``|dS|`` does not measure; ``2^-15 * 2^-5`` of their absolute mass
    is 16 f32 ulps of it."""
    p, ds = _probs_and_dscores(q, k, v, do, lse, delta, causal)
    scale = 1.0 / math.sqrt(q.shape[-1])
    sums = torch.einsum("bqhd,bkhd->bhqk", do.float().abs(), v.float().abs()) + delta.abs()[..., None]
    w = ds.abs() + 2.0**-5 * p * sums
    dq_mass = scale * torch.einsum("bhqk,bkhd->bqhd", w, k.float().abs())
    dk_mass = scale * torch.einsum("bhqk,bqhd->bkhd", w, q.float().abs())
    dv_mass = torch.einsum("bhqk,bqhd->bkhd", p, do.float().abs())
    return dq_mass, dk_mass, dv_mass


def plain_flash_backward_dq(q, k, v, do, lse, delta, causal: bool) -> torch.Tensor:
    """Plain version of the dq kernel: ``dq = scale * dS . K``."""
    _, ds = _probs_and_dscores(q, k, v, do, lse, delta, causal)
    scale = 1.0 / math.sqrt(q.shape[-1])
    return (scale * torch.einsum("bhqk,bkhd->bqhd", ds, k.float())).to(q.dtype)


def plain_flash_backward_dkv(q, k, v, do, lse, delta, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dk/dv kernel: ``dv = P^T . dO``, ``dk = scale * dS^T . Q``."""
    p, ds = _probs_and_dscores(q, k, v, do, lse, delta, causal)
    scale = 1.0 / math.sqrt(q.shape[-1])
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float() * scale)
    return dk.to(k.dtype), dv.to(v.dtype)


def plain_flash_chunk_update(
    carry: Carry, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_offset: int, kv_offset: int, causal: bool,
) -> Carry:
    """Plain version of the carry kernel: the whole chunk folded in one step.

    The kernel folds one tile of keys at a time (128 keys in the bf16
    tensor-core kernel at D 64, 64 in the narrow one below 64, in the
    grouped one above 64 and in the f32 CUDA-core ones) and skips key tiles
    wholly in a q tile's future; the two differ only in rounding as long as
    every row has seen a real (unmasked) key by the end of its first folded
    tile, which ring attention's self-chunk-first order guarantees. A chunk
    wholly in the future leaves the carry bit-unchanged here too:
    ``p = exp(MASK - m) = 0`` and ``corr = 1``.
    """
    return _fold(carry, q.float() * (1.0 / math.sqrt(q.shape[-1])), k, v, causal, q_offset, kv_offset)


def plain_flash_chunk_mass(
    carry: Carry, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_offset: int, kv_offset: int, causal: bool,
) -> torch.Tensor:
    """``[B,Sq,H,D]`` f32 ``exp(S - m_new) @ |V|``: the fold's unnormalized
    absolute weighted mass, ``m_new`` the folded carry's row max. The bf16
    carry kernel multiplies P split as ``P_hi + P_lo`` (within 2^-17 P of
    P), so the ``acc`` it adds may differ from the plain version's by a
    small multiple of this mass beyond the f32 sums' own rounding (on a
    fresh carry it is :func:`plain_flash_row_mass` times the new ``l``)."""
    m, l, acc = carry
    qf = q.float() * (1.0 / math.sqrt(q.shape[-1]))
    return _fold((m, l, torch.zeros_like(acc)), qf, k, v.float().abs(), causal, q_offset, kv_offset)[2]


# --- kernel or plain version, by device --------------------------------------


def _causal_fraction(sq: int, sk: int, q_offset: int, kv_offset: int) -> float:
    """Share of the ``Sq x Sk`` score pairs a causal fold computes: 1/2 for
    a square block on the diagonal (the lower triangle, as ``bench.py`` and
    ``chip_smoke.py`` count it), else the exact share of unmasked pairs
    (0 for a block wholly in the future, 1 wholly in the past)."""
    if sq == sk and q_offset == kv_offset:
        return 0.5
    # Row i sees keys j <= q_offset + i - kv_offset, clipped to [0, sk].
    seen = sum(min(sk, max(0, q_offset + i - kv_offset + 1)) for i in range(sq))
    return seen / float(sq * sk)


def attention_cost(
    name: str, q: torch.Tensor, k: torch.Tensor, causal: bool, q_offset: int = 0, kv_offset: int = 0,
) -> Tuple[int, int]:
    """``(flops, bytes)`` of one flash call, the kernel row ``name`` on q
    ``[B, Sq, H, D]`` and k / v ``[B, Sk, H, D]``: the products over the
    pairs the causal mask keeps (:func:`_causal_fraction`; ``2 Sq Sk D`` a
    product and head: the forward and the carry fold 2 products, dq 3, dk/dv
    4), and each input read once and each output written once (q, k, v and
    the outputs in the input type; lse, delta and the carry's m / l / acc in
    f32). What :mod:`p2pfl_tpu_torch.ops.cost` counts for the call on
    either device."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    frac = _causal_fraction(sq, sk, q_offset, kv_offset) if causal else 1.0
    pair_flops = 2 * b * h * sq * sk * d * frac
    esize = q.element_size()
    q_bytes, kv_bytes, rows = b * sq * h * d * esize, b * sk * h * d * esize, b * h * sq * 4
    products, nbytes = {
        "flash_fwd": (2, 2 * q_bytes + 2 * kv_bytes + rows),
        "flash_fwd_no_lse": (2, 2 * q_bytes + 2 * kv_bytes),
        "flash_bwd_dq": (3, 3 * q_bytes + 2 * kv_bytes + 2 * rows),
        "flash_bwd_dkv": (4, 2 * q_bytes + 4 * kv_bytes + 2 * rows),
        "flash_carry": (2, q_bytes + 2 * kv_bytes + 2 * (2 * rows + b * sq * h * d * 4)),
    }[name]
    return int(products * pair_flops), int(nbytes)


def _counted(name: str, q: torch.Tensor, k: torch.Tensor, causal: bool, q_offset: int = 0, kv_offset: int = 0):
    """The flash call as one operation of an open cost count (its analytic
    work, :func:`attention_cost`); a no-op context otherwise."""
    if cost.active() is None:
        return contextlib.nullcontext()
    return cost.opaque(*attention_cost(name, q, k, causal, q_offset, kv_offset))


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cpu or cuda tensors, got {t.device}")
    return t.device.type


def flash_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, with_lse: bool = True
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Flash forward: ``(out, lse)``, or ``(out, None)`` with ``with_lse=False``
    (the kernel then writes no logsumexp at all)."""
    with _counted("flash_fwd" if with_lse else "flash_fwd_no_lse", q, k, causal):
        if _route(q) == "cuda":
            return _kernels.flash_fwd(q, k, v, causal, with_lse)
        out, lse = plain_flash_forward(q, k, v, causal)
        return out, (lse if with_lse else None)


def flash_backward_dq(q, k, v, do, lse, delta, causal: bool) -> torch.Tensor:
    with _counted("flash_bwd_dq", q, k, causal):
        if _route(q) == "cuda":
            return _kernels.flash_bwd_dq(q, k, v, do, lse, delta, causal)
        return plain_flash_backward_dq(q, k, v, do, lse, delta, causal)


def flash_backward_dkv(q, k, v, do, lse, delta, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    with _counted("flash_bwd_dkv", q, k, causal):
        if _route(q) == "cuda":
            return _kernels.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
        return plain_flash_backward_dkv(q, k, v, do, lse, delta, causal)


def flash_chunk_update(
    carry: Carry, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_offset: int, kv_offset: int, causal: bool = True, block_q: int = 512, block_k: int = 512,
) -> Carry:
    """Fold one kv chunk (``k``/``v`` ``[B, Sk, H, D]`` at global offset
    ``kv_offset``) into the carry of queries ``q [B, Sq, H, D]`` at
    ``q_offset``; returns the new, unnormalized carry (new tensors: the
    incoming carry is left as it was). ``block_q``/``block_k`` are the JAX
    package's tile requests; the kernel owns its tiling, so they are only
    validated."""
    if block_q < 1 or block_k < 1:
        raise ValueError(f"block sizes must be >= 1, got {block_q}, {block_k}")
    with _counted("flash_carry", q, k, causal, q_offset, kv_offset):
        if _route(q) == "cuda":
            return _kernels.flash_carry(carry, q, k, v, q_offset, kv_offset, causal)
        return plain_flash_chunk_update(carry, q, k, v, q_offset, kv_offset, causal)


def flash_backward(
    q, k, v, out, lse, g, causal: bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """FlashAttention-2 backward: ``D = rowsum(dO * O)`` in f32 (as the JAX
    wrapper computes it, from the f32 cotangent), then the dq kernel and the
    dk/dv kernel, both fed dO rounded to the input dtype."""
    delta = (g.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()  # [B,H,S]
    do = g.to(q.dtype).contiguous()
    dq = flash_backward_dq(q, k, v, do, lse, delta, causal)
    dk, dv = flash_backward_dkv(q, k, v, do, lse, delta, causal)
    return dq, dk, dv


def remat_vjp(fn, inputs: Tuple[torch.Tensor, ...], g: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Gradients of ``fn(*inputs)`` against cotangent ``g``, recomputing the
    forward with autograd on (``jax.vjp`` of a function inside a
    ``custom_vjp`` backward): only the graph of this one call is alive."""
    with torch.enable_grad():
        leaves = tuple(t.detach().requires_grad_(True) for t in inputs)
        return torch.autograd.grad(fn(*leaves), leaves, g)


class FlashAttention(torch.autograd.Function):
    """``custom_vjp`` counterpart. ``bwd_kernel="pallas"`` (the kernel
    backward): the forward saves ``(q, k, v, out, lse)`` and the backward
    runs :func:`flash_backward`. ``"remat"``: the forward saves ``(q, k, v)``
    and the backward differentiates :func:`blockwise_attention`."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, block_k: int, bwd_kernel: str):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        ctx.causal, ctx.block_k, ctx.bwd_kernel = causal, block_k, bwd_kernel
        if bwd_kernel == "remat":
            ctx.save_for_backward(q, k, v)
            return flash_forward(q, k, v, causal, with_lse=False)[0]
        out, lse = flash_forward(q, k, v, causal, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.bwd_kernel == "remat":
            causal, block_k = ctx.causal, ctx.block_k
            dq, dk, dv = remat_vjp(
                lambda q, k, v: blockwise_attention(q, k, v, causal, block_k), ctx.saved_tensors, g)
        else:
            q, k, v, out, lse = ctx.saved_tensors
            dq, dk, dv = flash_backward(q, k, v, out, lse, g, ctx.causal)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
    block_q: int = 512, block_k: int = 512, bwd_kernel: str = "pallas",
) -> torch.Tensor:
    """Flash attention over ``[B, S, H, D]`` tensors.

    Under autograd the forward writes the logsumexp for the backward; a
    call that needs no gradient (evaluation) runs the forward that writes
    none. ``block_q``/``block_k`` are the JAX package's tile requests; here
    the kernels own their tiling and mask ragged tails, and the
    result does not depend on them, so they are only validated (``block_k``
    is also the key block of the ``"remat"`` backward). ``bwd_kernel``:
    ``"pallas"`` (the name the JAX package gives its kernel backward: here
    the dq and dk/dv kernels) or ``"remat"`` (differentiate the blockwise
    fold instead; the independently derived cross-check).
    """
    if block_q < 1 or block_k < 1:
        raise ValueError(f"block sizes must be >= 1, got {block_q}, {block_k}")
    if bwd_kernel not in ("pallas", "remat"):
        raise ValueError(f"bwd_kernel must be 'pallas' or 'remat', got {bwd_kernel!r}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, block_k, bwd_kernel)
    return flash_forward(q.contiguous(), k.contiguous(), v.contiguous(), causal, with_lse=False)[0]
