"""Loss functions of the learner (counterpart of
``p2pfl_tpu/learning/learner.py``; this slice needs only the LM loss)."""

from __future__ import annotations

import torch

from p2pfl_tpu_torch.models.transformer import causal_lm_loss


def masked_lm_loss(logits: torch.Tensor, tokens: torch.Tensor, seq_mask: torch.Tensor) -> torch.Tensor:
    """Next-token CE over ``logits [B, L, V]`` / ``tokens [B, L]`` with a
    per-sequence validity mask ``[B]`` (padded rows contribute zero)."""
    mask = seq_mask[:, None].expand(tokens.shape)
    return causal_lm_loss(logits, tokens, mask)
