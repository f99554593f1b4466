"""Decoder-only transformer LM and the mean-pool transformer classifier
(counterpart of ``p2pfl_tpu/models/transformer.py``): attention kinds
``dense``, ``blockwise`` (the default, as in the JAX package), ``flash``,
and the sequence-parallel ``ring`` and ``ring_flash``.

The ring kinds run on the *global* ``[B, S]`` tokens inside a
``sequence_parallel_*`` wrapper (:mod:`p2pfl_tpu_torch.parallel.sequence`),
which binds ``axis_name``; only attention sees the shards. RoPE over the
global positions ``[0, S)`` is what the JAX package computes per shard with
the offset ``axis_index * S_local``.

The dtype flow is the JAX package's: parameters are f32; dense layers run in
``compute_dtype`` (bf16 by default); the token embedding is cast to
``compute_dtype`` too, so the residual stream is bf16; LayerNorm runs in f32
with eps 1e-6; GELU is the tanh approximation; logits come out f32.
``qkv``, ``proj`` and ``lm_head`` carry no bias, ``mlp_in``/``mlp_out`` do.
``nn.Linear.weight`` is ``[out, in]``, the transpose of a flax ``kernel``
(:mod:`p2pfl_tpu_torch.models.convert` carries weights across).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from p2pfl_tpu_torch.device import DeviceLike, resolve_device
from p2pfl_tpu_torch.models.model_handle import ModelHandle
from p2pfl_tpu_torch.ops.attention import blockwise_attention, dense_attention, flash_attention
from p2pfl_tpu_torch.ops.ring_attention import ring_attention

ATTENTION_KINDS = ("dense", "blockwise", "flash", "ring", "ring_flash")
RING_KINDS = ("ring", "ring_flash")
LN_EPS = 1e-6  # flax nn.LayerNorm's default
MLP_RATIO = 4
ROPE_BASE = 10000.0


def rotary_embedding(x: torch.Tensor, position_offset: int = 0, base: float = ROPE_BASE) -> torch.Tensor:
    """Apply RoPE to ``[B, S, H, D]`` (D even) at global positions
    ``position_offset + [0, S)``: half split (not interleaved pairs),
    computed in f32, cast back."""
    _, s, _, d = x.shape
    half = d // 2
    freqs = base ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    pos = position_offset + torch.arange(s, dtype=torch.float32, device=x.device)[:, None]
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
    """Multi-head causal self-attention with a pluggable kernel.

    ``axis_name``: the sequence-parallel mesh axis; required by the ring
    kinds and refused by the others (a non-ring kernel under a sharded
    sequence would attend only within a shard, as the JAX package warns).
    """

    def __init__(
        self, embed_dim: int, num_heads: int, attention_kind: str = "blockwise",
        compute_dtype: torch.dtype = torch.bfloat16, axis_name: Optional[str] = None,
        block_k: int = 512,
    ) -> None:
        super().__init__()
        if attention_kind not in ATTENTION_KINDS:
            raise ValueError(f"unknown attention_kind {attention_kind!r} (have {ATTENTION_KINDS})")
        if axis_name is not None and attention_kind not in RING_KINDS:
            raise ValueError(
                f"axis_name={axis_name!r} requires attention_kind='ring' or 'ring_flash', "
                f"got {attention_kind!r}"
            )
        if attention_kind in RING_KINDS and axis_name is None:
            raise ValueError(f"attention_kind={attention_kind!r} requires axis_name")
        self.num_heads = num_heads
        self.attention_kind = attention_kind
        self.compute_dtype = compute_dtype
        self.axis_name = axis_name
        self.block_k = block_k
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
        kind = self.attention_kind
        if kind == "dense":
            out = dense_attention(q, k, v, causal=True)
        elif kind == "blockwise":
            out = blockwise_attention(q, k, v, causal=True, block_k=self.block_k)
        elif kind == "flash":
            out = flash_attention(q, k, v, True, min(self.block_k, s), self.block_k)
        else:
            out = ring_attention(q, k, v, self.axis_name, causal=True, block_k=self.block_k,
                                 impl="flash" if kind == "ring_flash" else "blockwise")
        return _linear(out.reshape(b, s, e), self.proj, self.compute_dtype)


class Block(nn.Module):
    """Pre-LN transformer block."""

    def __init__(
        self, embed_dim: int, num_heads: int, attention_kind: str = "blockwise",
        compute_dtype: torch.dtype = torch.bfloat16, axis_name: Optional[str] = None,
        block_k: int = 512,
    ) -> None:
        super().__init__()
        self.compute_dtype = compute_dtype
        self.ln1 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.attn = SelfAttention(embed_dim, num_heads, attention_kind, compute_dtype, axis_name, block_k)
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
        embed_dim: int = 256, attention_kind: str = "blockwise",
        compute_dtype: torch.dtype = torch.bfloat16, axis_name: Optional[str] = None,
        block_k: int = 512,
    ) -> None:
        super().__init__()
        self.compute_dtype = compute_dtype
        self.embed = nn.Embedding(vocab_size, embed_dim)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, attention_kind, compute_dtype, axis_name, block_k)
            for _ in range(num_layers)
        )
        self.ln_f = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.lm_head = nn.Linear(embed_dim, vocab_size, bias=False)

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """Tokens ``[B, S]`` -> the residual stream ``[B, S, E]`` in ``compute_dtype``."""
        return self.embed.weight.to(self.compute_dtype)[tokens.long()]

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """The residual stream -> f32 logits: ``ln_f`` (f32), then ``lm_head``."""
        return _linear(_layer_norm(x, self.ln_f), self.lm_head, self.compute_dtype).float()

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed_tokens(tokens)
        for block in self.blocks:
            x = block(x)
        return self.head(x)


class TransformerClassifier(nn.Module):
    """Transformer trunk + mean-pool classification head: tokens ``[B, S]``
    -> logits ``[B, num_classes]`` (f32).

    The trunk is :class:`TransformerLM`'s (bf16 residual stream by default);
    then the f32 ``ln_f``, a mean over S and an f32 ``head`` with a bias.
    Under a sequence-parallel wrapper the model runs on the global tokens,
    so the mean is already over the global S (the JAX package's ``pmean``
    of the shards' means).
    """

    def __init__(
        self, num_classes: int = 10, vocab_size: int = 256, num_layers: int = 2, num_heads: int = 4,
        embed_dim: int = 128, attention_kind: str = "blockwise",
        compute_dtype: torch.dtype = torch.bfloat16, axis_name: Optional[str] = None,
        block_k: int = 512,
    ) -> None:
        super().__init__()
        self.compute_dtype = compute_dtype
        self.embed = nn.Embedding(vocab_size, embed_dim)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, attention_kind, compute_dtype, axis_name, block_k)
            for _ in range(num_layers)
        )
        self.ln_f = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.head = nn.Linear(embed_dim, num_classes)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed.weight.to(self.compute_dtype)[tokens.long()]
        for block in self.blocks:
            x = block(x)
        pooled = _layer_norm(x, self.ln_f).mean(dim=1)
        return F.linear(pooled, self.head.weight, self.head.bias)


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
    default initializers: Dense and Conv kernels lecun-normal (truncated
    normal, variance 1/fan_in; fan_in is ``in * kh * kw`` for an OIHW conv
    kernel and, as flax counts it, ``experts * in`` for the MoE's stacked
    ``wi`` / ``wo``), biases 0, LayerNorm and GroupNorm scales 1, embeddings
    normal with variance 1/vocab. Drawn on the CPU from one generator, so the
    same seed gives the same weights on every machine, then moved to
    ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params = {}
    for name, p in module.named_parameters():
        t = torch.empty(p.shape, dtype=torch.float32)
        leaf = name.rsplit(".", 1)[-1]
        if name.endswith("embed.weight"):
            t.normal_(0.0, p.shape[0] ** -0.5, generator=gen)
        elif ".ln" in name or name.startswith("ln") or "GroupNorm" in name:
            t.fill_(1.0 if name.endswith("weight") else 0.0)
        elif name.endswith("bias"):
            t.zero_()
        else:  # [out, in] or [out, in, kh, kw] kernel; [X, in, out] stacked experts
            fan_in = p.shape[0] * p.shape[1] if leaf in ("wi", "wo") else math.prod(p.shape[1:])
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=gen)
        params[name] = t.to(dev)
    return params


def transformer_lm_model(
    seed: int = 0,
    seq_len: int = 128,
    vocab_size: int = 256,
    num_layers: int = 4,
    num_heads: int = 4,
    embed_dim: int = 256,
    attention_kind: str = "blockwise",
    axis_name: Optional[str] = None,
    device: DeviceLike = "cuda",
) -> ModelHandle:
    """A :class:`TransformerLM` with random weights from ``seed``, in a
    :class:`ModelHandle`; arguments in the JAX function's order. ``seq_len``
    (the JAX package's init example length) is validated and otherwise
    unused: the weights do not depend on it. The module holds no weights of
    its own (it lives on the meta device); the handle's params are run
    through it. Parameter names are the same for every attention kind."""
    if int(seq_len) != seq_len or seq_len < 1:
        raise ValueError(f"seq_len must be a positive integer, got {seq_len!r}")
    with torch.device("meta"):
        module = TransformerLM(
            vocab_size=vocab_size, num_layers=num_layers, num_heads=num_heads,
            embed_dim=embed_dim, attention_kind=attention_kind, axis_name=axis_name,
        )
    return ModelHandle(init_params(module, seed, device), module)


def transformer_classifier_model(
    seed: int = 0,
    seq_len: int = 64,
    num_classes: int = 10,
    vocab_size: int = 256,
    num_layers: int = 2,
    num_heads: int = 4,
    embed_dim: int = 128,
    attention_kind: str = "blockwise",
    device: DeviceLike = "cuda",
) -> ModelHandle:
    """A :class:`TransformerClassifier` with random weights from ``seed``, in
    a :class:`ModelHandle`; arguments in the JAX function's order.
    ``seq_len`` is validated and otherwise unused, as in
    :func:`transformer_lm_model`."""
    if int(seq_len) != seq_len or seq_len < 1:
        raise ValueError(f"seq_len must be a positive integer, got {seq_len!r}")
    with torch.device("meta"):
        module = TransformerClassifier(
            num_classes=num_classes, vocab_size=vocab_size, num_layers=num_layers,
            num_heads=num_heads, embed_dim=embed_dim, attention_kind=attention_kind,
        )
    return ModelHandle(init_params(module, seed, device), module)
