"""Attention: the dense reference, the flash kernels' plain versions, and
``flash_attention`` with its FlashAttention-2 gradient.

Counterpart of ``p2pfl_tpu/ops/attention.py``. All public functions take
``[batch, seq, heads, head_dim]`` ("BSHD") tensors, like the JAX package.

The flash path has three kernels (``csrc/flash_attn.cu``, bound in
:mod:`._kernels`): the forward, written with or without the per-row
logsumexp, the dq kernel and the dk/dv kernel. Each has a plain PyTorch
version here with the same arithmetic — inputs upcast to f32, q scaled in
f32, the causal mask writes :data:`DEFAULT_MASK_VALUE`, ``l`` clamped at
1e-30 — that the CPU tests hold against the JAX package and that the card's
smoke run holds each kernel against. :func:`flash_forward`,
:func:`flash_backward_dq` and :func:`flash_backward_dkv` pick between them
by where the tensors live: a CPU tensor takes the plain version, a CUDA
tensor launches the kernel (or raises), anything else raises.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from p2pfl_tpu_torch.ops import _kernels

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def _causal_mask(scores: torch.Tensor) -> torch.Tensor:
    """Mask ``scores [..., Sq, Sk]`` where the q position < the kv position."""
    sq, sk = scores.shape[-2], scores.shape[-1]
    q_pos = torch.arange(sq, device=scores.device)[:, None]
    k_pos = torch.arange(sk, device=scores.device)[None, :]
    return torch.where(q_pos >= k_pos, scores, torch.full_like(scores, DEFAULT_MASK_VALUE))


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """Materialized-softmax attention (reference implementation).

    Scores are f32 products of the inputs; the probabilities are cast back
    to the value dtype before the second product, as in the JAX package.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        s = _causal_mask(s)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).to(q.dtype)


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


def _probs_and_dscores(q, k, v, do, lse, delta, causal):
    p = torch.exp(_scores(q, k, causal) - lse[..., None])  # masked entries -> exactly 0
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None])


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


# --- kernel or plain version, by device --------------------------------------


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cpu or cuda tensors, got {t.device}")
    return t.device.type


def flash_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, with_lse: bool = True
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Flash forward: ``(out, lse)``, or ``(out, None)`` with ``with_lse=False``
    (the kernel then writes no logsumexp at all)."""
    if _route(q) == "cuda":
        return _kernels.flash_fwd(q, k, v, causal, with_lse)
    out, lse = plain_flash_forward(q, k, v, causal)
    return out, (lse if with_lse else None)


def flash_backward_dq(q, k, v, do, lse, delta, causal: bool) -> torch.Tensor:
    if _route(q) == "cuda":
        return _kernels.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    return plain_flash_backward_dq(q, k, v, do, lse, delta, causal)


def flash_backward_dkv(q, k, v, do, lse, delta, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    if _route(q) == "cuda":
        return _kernels.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    return plain_flash_backward_dkv(q, k, v, do, lse, delta, causal)


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


class FlashAttention(torch.autograd.Function):
    """``custom_vjp`` counterpart: the forward saves ``(q, k, v, out, lse)``;
    the backward runs :func:`flash_backward`."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_forward(q, k, v, causal, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, g, ctx.causal)
        return dq, dk, dv, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
    block_q: int = 512, block_k: int = 512,
) -> torch.Tensor:
    """Flash attention over ``[B, S, H, D]`` tensors.

    Under autograd the forward writes the logsumexp for the backward; a
    call that needs no gradient (evaluation) runs the forward that writes
    none. ``block_q``/``block_k`` are the JAX package's tile requests; here
    the kernel owns its tiling (64 x 64) and masks ragged tails, and the
    result does not depend on them, so they are only validated.
    """
    if block_q < 1 or block_k < 1:
        raise ValueError(f"block sizes must be >= 1, got {block_q}, {block_k}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal)
    return flash_forward(q.contiguous(), k.contiguous(), v.contiguous(), causal, with_lse=False)[0]
