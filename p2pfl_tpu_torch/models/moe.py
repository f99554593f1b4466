"""Mixture-of-Experts transformer LM (counterpart of
``p2pfl_tpu/models/moe.py``): switch-transformer top-1 routing with
capacity-limited dispatch and combine, every second block routed.

The expert FFN weights are stacked ``wi [X, E, M]`` / ``wo [X, M, E]`` (the
JAX package's layout). On one process every expert runs on the one card
inside the einsums, and :func:`shard_moe_params` only places the leaves.
Over ranks (a mesh whose ``expert`` axis spans W ranks, bound while the
model runs) :func:`shard_moe_params` keeps this rank's contiguous ``X / W``
experts, as the JAX package shards that leading axis over its ``expert``
axis. The tokens enter replicated, so every rank computes the router, the
load-balance loss, ``cap`` (of the global T) and the dispatch and combine
tensors from all of them; its experts run over its own capacity slots, and
the block's output is the ``psum`` of the partial combines. The tokens and
the gate enter the experts through ``sum_cotangent``, so the router and
every leaf before the block get their whole gradient on every rank. No
all-to-all: it would arise only if the tokens were split over the same
axis, and the JAX package never splits them there.

What it keeps of the JAX package:

- the router runs in f32 (a bias-free Dense over the f32 tokens); ``argmax``
  keeps the first maximum, as ``jnp.argmax`` does;
- ``cap = max(1, int(capacity_factor * T / X))``; a token's position in its
  expert's queue is the running count of earlier tokens routed there, and a
  token at or past ``cap`` falls through the residual (its one-hot position
  row is zero: the position is clamped for ``F.one_hot``, then masked);
- the load-balance loss ``X * sum(fraction * mean_prob)``, which the JAX
  package ``sow``s into a ``"losses"`` collection, is returned by the
  forward (``forward(tokens, with_aux=True)``; summed over the routed
  blocks);
- the experts compute in ``compute_dtype`` with the tanh GELU. Over expert
  ranks the partial combines are summed in ``compute_dtype`` (bf16: 8 MiB a
  routed block's forward at 8 x 1024 tokens of width 512). Top-1 routing
  gives each token one expert, so one rank holds its partial and the others
  exact zeros: the sum adds nothing to the rounding.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

from p2pfl_tpu_torch.device import DeviceLike
from p2pfl_tpu_torch.models.model_handle import ModelHandle
from p2pfl_tpu_torch.models.transformer import (
    LN_EPS,
    MLP_RATIO,
    Block,
    SelfAttention,
    _embed,
    _layer_norm,
    _linear,
    init_params,
)
from p2pfl_tpu_torch.parallel.collectives import psum, sum_cotangent
from p2pfl_tpu_torch.parallel.mesh import Mesh, axis_index
from p2pfl_tpu_torch.parallel.tensor_parallel import column_group

Params = Dict[str, torch.Tensor]


class MoEMLP(nn.Module):
    """Capacity-limited top-1 routed expert FFN over ``[B, S, E]``; returns
    ``(out [B, S, E], aux)``."""

    def __init__(
        self, embed_dim: int, num_experts: int = 4, mlp_ratio: int = MLP_RATIO, capacity_factor: float = 1.25,
        compute_dtype: torch.dtype = torch.bfloat16,
    ) -> None:
        super().__init__()
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.compute_dtype = compute_dtype
        self.router = nn.Linear(embed_dim, num_experts, bias=False)
        m = mlp_ratio * embed_dim
        self.wi = nn.Parameter(torch.empty(num_experts, embed_dim, m))
        self.wo = nn.Parameter(torch.empty(num_experts, m, embed_dim))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        b, s, e = x.shape
        t, nx = b * s, self.num_experts
        cap = max(1, int(self.capacity_factor * t / nx))
        tokens = x.reshape(t, e)

        held = self.wi.shape[0]
        group = column_group(held, nx, "the MoE's stacked experts", axis="expert")

        # --- router (f32) ---
        probs = torch.softmax(_linear(tokens.float(), self.router, torch.float32), dim=-1)  # [T, X]
        gate, expert = probs.max(dim=-1).values, torch.argmax(probs, dim=-1)
        onehot = F.one_hot(expert, nx).float()
        aux = nx * torch.sum(onehot.mean(dim=0) * probs.mean(dim=0))

        # --- capacity-limited dispatch ---
        pos = (torch.cumsum(onehot, dim=0) - 1.0) * onehot  # [T, X]
        in_cap = (pos < cap) & (onehot > 0)
        pos_oh = F.one_hot(pos.long().clamp(0, cap - 1), cap).float()  # [T, X, C]
        dispatch = in_cap[..., None].float() * pos_oh

        # --- experts over the stacked axis ---
        cd = self.compute_dtype
        tokens = tokens.to(cd)
        if group is not None:  # this rank's experts: their dispatch slots, the partial combine summed
            lo = axis_index("expert") * held
            dispatch = dispatch[:, lo:lo + held]
            gate, tokens = sum_cotangent(gate, group), sum_cotangent(tokens, group)
        combine = dispatch * gate[:, None, None]
        xe = torch.einsum("txc,te->xce", dispatch.to(cd), tokens)
        h = F.gelu(torch.einsum("xce,xem->xcm", xe, self.wi.to(cd)), approximate="tanh")
        out_e = torch.einsum("xcm,xme->xce", h, self.wo.to(cd))
        out = torch.einsum("txc,xce->te", combine.to(cd), out_e)
        if group is not None:
            out = psum(out, group)
        return out.reshape(b, s, e).to(x.dtype), aux


class MoEBlock(nn.Module):
    """Pre-LN block: attention + routed MoE FFN; returns ``(x, aux)``."""

    def __init__(
        self, embed_dim: int, num_heads: int, num_experts: int = 4, mlp_ratio: int = MLP_RATIO,
        capacity_factor: float = 1.25, attention_kind: str = "blockwise", axis_name: Optional[str] = None,
        block_k: int = 512, compute_dtype: torch.dtype = torch.bfloat16,
    ) -> None:
        super().__init__()
        self.compute_dtype = compute_dtype
        self.ln1 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.attn = SelfAttention(embed_dim, num_heads, attention_kind, compute_dtype, axis_name, block_k)
        self.ln2 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.moe = MoEMLP(embed_dim, num_experts, mlp_ratio, capacity_factor, compute_dtype)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.attn(_layer_norm(x, self.ln1).to(self.compute_dtype))
        x = x + h.to(x.dtype)
        h, aux = self.moe(_layer_norm(x, self.ln2).to(self.compute_dtype))
        return x + h.to(x.dtype), aux


class MoETransformerLM(nn.Module):
    """Decoder-only LM alternating dense and MoE blocks (every second block
    is routed): tokens ``[B, S]`` -> logits ``[B, S, V]`` (f32), or ``(logits,
    aux)`` with ``with_aux=True``."""

    def __init__(
        self, vocab_size: int = 256, num_layers: int = 4, num_heads: int = 4, embed_dim: int = 256,
        num_experts: int = 4, capacity_factor: float = 1.25, attention_kind: str = "blockwise",
        axis_name: Optional[str] = None, block_k: int = 512, compute_dtype: torch.dtype = torch.bfloat16,
    ) -> None:
        super().__init__()
        self.compute_dtype = compute_dtype
        self.axis_name = axis_name
        self.embed = nn.Embedding(vocab_size, embed_dim)
        self.blocks = nn.ModuleList(
            MoEBlock(embed_dim, num_heads, num_experts, MLP_RATIO, capacity_factor, attention_kind, axis_name,
                     block_k, compute_dtype)
            if i % 2 == 1 else
            Block(embed_dim, num_heads, attention_kind, compute_dtype, axis_name, block_k)
            for i in range(num_layers)
        )
        self.ln_f = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.lm_head = nn.Linear(embed_dim, vocab_size, bias=False)

    def forward(self, tokens: torch.Tensor, with_aux: bool = False):
        x = _embed(self.embed, tokens, self.compute_dtype)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for block in self.blocks:
            if isinstance(block, MoEBlock):
                x, a = block(x)
                aux = aux + a
            else:
                x = block(x)
        logits = _linear(_layer_norm(x, self.ln_f), self.lm_head, self.compute_dtype).float()
        return (logits, aux) if with_aux else logits


def moe_lm_apply_with_aux(module: MoETransformerLM) -> Callable[[Params, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """``f(params, tokens) -> (logits, aux_loss)``, ``aux_loss`` the summed
    router load-balance loss of all MoE blocks."""

    def apply(params: Params, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return functional_call(module, params, (tokens,), {"with_aux": True})

    return apply


def moe_lm_model(
    seed: int = 0,
    seq_len: int = 128,
    vocab_size: int = 256,
    num_layers: int = 4,
    num_heads: int = 4,
    embed_dim: int = 256,
    num_experts: int = 4,
    attention_kind: str = "blockwise",
    axis_name: Optional[str] = None,
    device: DeviceLike = "cuda",
) -> ModelHandle:
    """A :class:`MoETransformerLM` with random weights from ``seed``, in a
    :class:`ModelHandle` whose ``apply`` returns logits only (train with
    :func:`moe_lm_apply_with_aux`); arguments in the JAX function's order.
    ``seq_len`` is validated and otherwise unused, as in
    :func:`~p2pfl_tpu_torch.models.transformer.transformer_lm_model`."""
    if int(seq_len) != seq_len or seq_len < 1:
        raise ValueError(f"seq_len must be a positive integer, got {seq_len!r}")
    with torch.device("meta"):
        module = MoETransformerLM(
            vocab_size=vocab_size, num_layers=num_layers, num_heads=num_heads, embed_dim=embed_dim,
            num_experts=num_experts, attention_kind=attention_kind, axis_name=axis_name,
        )
    return ModelHandle(init_params(module, seed, device), module)


def shard_moe_params(params: Any, mesh: Mesh, expert_axis: str = "expert") -> Any:
    """The JAX package's expert-axis placement: every leaf on the mesh's
    device, and over ranks (``expert_axis`` spanning W ranks) each MoE
    block's ``wi`` / ``wo`` cut to this rank's contiguous ``X / W`` experts
    where X divides by W (a block whose X does not stays whole, as in the
    JAX package, and runs without a sum); everything else replicated. On
    one process nothing is split. Run the model inside ``mesh.bind()``."""
    n = mesh.check_axis(expert_axis)
    ranked = mesh.rank_axis == expert_axis
    out = {}
    for k, v in params.items():
        v = v.to(mesh.device)
        if ranked and ".moe." in k and k.rsplit(".", 1)[-1] in ("wi", "wo") and v.dim() == 3 and v.shape[0] % n == 0:
            per = v.shape[0] // n
            v = v[mesh.rank * per:(mesh.rank + 1) * per].clone()
        out[k] = v
    return out
