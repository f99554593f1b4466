"""Decoder-only transformer LM (counterpart of
``p2pfl_tpu/models/transformer.py``; this slice ports the ``dense`` and
``flash`` attention kinds).

The dtype flow is the JAX package's: parameters are f32; dense layers run in
``compute_dtype`` (bf16 by default); the token embedding is cast to
``compute_dtype`` too, so the residual stream is bf16; LayerNorm runs in f32
with eps 1e-6; GELU is the tanh approximation; logits come out f32.
``qkv``, ``proj`` and ``lm_head`` carry no bias, ``mlp_in``/``mlp_out`` do.
``nn.Linear.weight`` is ``[out, in]``, the transpose of a flax ``kernel``
(:mod:`p2pfl_tpu_torch.models.convert` carries weights across).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from p2pfl_tpu_torch.device import DeviceLike, resolve_device
from p2pfl_tpu_torch.models.model_handle import ModelHandle
from p2pfl_tpu_torch.ops.attention import dense_attention, flash_attention

ATTENTION_KINDS = ("dense", "flash")
LN_EPS = 1e-6  # flax nn.LayerNorm's default
MLP_RATIO = 4
ROPE_BASE = 10000.0


def rotary_embedding(x: torch.Tensor) -> torch.Tensor:
    """Apply RoPE to ``[B, S, H, D]`` (D even) at positions ``[0, S)``: half
    split (not interleaved pairs), computed in f32, cast back."""
    _, s, _, d = x.shape
    half = d // 2
    freqs = ROPE_BASE ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    pos = torch.arange(s, dtype=torch.float32, device=x.device)[:, None]
    angles = pos * freqs[None, :]  # [S, half]
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1).to(x.dtype)


def _linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=...)``: inputs, kernel and bias cast to ``dtype``."""
    bias = layer.bias.to(dtype) if layer.bias is not None else None
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, LN_EPS)


class SelfAttention(nn.Module):
    """Multi-head causal self-attention with a pluggable kernel."""

    def __init__(
        self, embed_dim: int, num_heads: int, attention_kind: str = "flash",
        compute_dtype: torch.dtype = torch.bfloat16,
    ) -> None:
        super().__init__()
        if attention_kind not in ATTENTION_KINDS:
            raise ValueError(f"unknown attention_kind {attention_kind!r} (have {ATTENTION_KINDS})")
        self.num_heads = num_heads
        self.attention_kind = attention_kind
        self.compute_dtype = compute_dtype
        self.qkv = nn.Linear(embed_dim, 3 * embed_dim, bias=False)
        self.proj = nn.Linear(embed_dim, embed_dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, e = x.shape
        head_dim = e // self.num_heads
        qkv = _linear(x, self.qkv, self.compute_dtype)
        # [B, S, 3H, hd] split along heads: columns are [q heads | k heads | v heads]
        q, k, v = torch.split(qkv.reshape(b, s, 3 * self.num_heads, head_dim), self.num_heads, dim=2)
        q = rotary_embedding(q)
        k = rotary_embedding(k)
        if self.attention_kind == "dense":
            out = dense_attention(q, k, v, causal=True)
        else:
            out = flash_attention(q, k, v, causal=True)
        return _linear(out.reshape(b, s, e), self.proj, self.compute_dtype)


class Block(nn.Module):
    """Pre-LN transformer block."""

    def __init__(
        self, embed_dim: int, num_heads: int, attention_kind: str = "flash",
        compute_dtype: torch.dtype = torch.bfloat16,
    ) -> None:
        super().__init__()
        self.compute_dtype = compute_dtype
        self.ln1 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.attn = SelfAttention(embed_dim, num_heads, attention_kind, compute_dtype)
        self.ln2 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.mlp_in = nn.Linear(embed_dim, MLP_RATIO * embed_dim)
        self.mlp_out = nn.Linear(MLP_RATIO * embed_dim, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.attn(_layer_norm(x, self.ln1).to(self.compute_dtype))
        x = x + h.to(x.dtype)
        h = _linear(_layer_norm(x, self.ln2), self.mlp_in, self.compute_dtype)
        h = _linear(F.gelu(h, approximate="tanh"), self.mlp_out, self.compute_dtype)
        return x + h.to(x.dtype)


class TransformerLM(nn.Module):
    """Decoder-only language model: tokens ``[B, S]`` -> logits ``[B, S, V]`` (f32)."""

    def __init__(
        self, vocab_size: int = 256, num_layers: int = 4, num_heads: int = 4,
        embed_dim: int = 256, attention_kind: str = "flash",
        compute_dtype: torch.dtype = torch.bfloat16,
    ) -> None:
        super().__init__()
        self.compute_dtype = compute_dtype
        self.embed = nn.Embedding(vocab_size, embed_dim)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, attention_kind, compute_dtype)
            for _ in range(num_layers)
        )
        self.ln_f = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.lm_head = nn.Linear(embed_dim, vocab_size, bias=False)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed.weight.to(self.compute_dtype)[tokens.long()]
        for block in self.blocks:
            x = block(x)
        return _linear(_layer_norm(x, self.ln_f), self.lm_head, self.compute_dtype).float()


def causal_lm_loss(
    logits: torch.Tensor, tokens: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Next-token cross entropy: predict ``tokens[:, 1:]`` from positions
    ``[:, :-1]``; f32 throughout."""
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    targets = tokens[:, 1:].long()
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    if mask is None:
        return nll.mean()
    m = mask[:, 1:].float()
    return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)


def init_params(module: nn.Module, seed: int, device: DeviceLike = "cuda") -> dict:
    """Random f32 parameters for ``module`` from ``seed``, following flax's
    default initializers: Dense kernels lecun-normal (truncated normal,
    variance 1/fan_in), biases 0, LayerNorm scale 1, embeddings normal with
    variance 1/vocab. Drawn on the CPU from one generator, so the same seed
    gives the same weights on every machine, then moved to ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params = {}
    for name, p in module.named_parameters():
        t = torch.empty(p.shape, dtype=torch.float32)
        if name.endswith("embed.weight"):
            t.normal_(0.0, p.shape[0] ** -0.5, generator=gen)
        elif ".ln" in name or name.startswith("ln"):
            t.fill_(1.0 if name.endswith("weight") else 0.0)
        elif name.endswith("bias"):
            t.zero_()
        else:  # [out, in] kernel
            std = (1.0 / p.shape[1]) ** 0.5 / 0.87962566103423978
            nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=gen)
        params[name] = t.to(dev)
    return params


def transformer_lm_model(
    seed: int = 0,
    vocab_size: int = 256,
    num_layers: int = 4,
    num_heads: int = 4,
    embed_dim: int = 256,
    attention_kind: str = "flash",
    device: DeviceLike = "cuda",
) -> ModelHandle:
    """A :class:`TransformerLM` with random weights from ``seed``, in a
    :class:`ModelHandle`. The module holds no weights of its own (it lives on
    the meta device); the handle's params are run through it."""
    with torch.device("meta"):
        module = TransformerLM(
            vocab_size=vocab_size, num_layers=num_layers, num_heads=num_heads,
            embed_dim=embed_dim, attention_kind=attention_kind,
        )
    return ModelHandle(init_params(module, seed, device), module)
