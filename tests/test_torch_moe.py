"""The port's MoE transformer against the JAX package's: routed FFN, LM
logits and load-balance loss, gradients, and the flash attention path.

Same inputs (numpy, from a seed) go through the flax modules and the port's,
on weights carried across with ``p2pfl_tpu_torch.models.convert``.
Tolerances: f32 forwards (outputs, logits, aux) 1e-5, f32 gradients 1e-4;
bf16 logits a bar from bf16 rounding at the logits' scale (stated at the
test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from p2pfl_tpu.models import moe as jax_moe
from p2pfl_tpu_torch.models import moe
from p2pfl_tpu_torch.models.convert import flax_to_torch, torch_to_flax
from p2pfl_tpu_torch.optim import adam, apply_updates
from p2pfl_tpu_torch.parallel.mesh import Mesh

VOCAB, SEQ = 64, 32


def _mlp_pair(nx, ratio, cap, e=16, seed=1):
    layer = jax_moe.MoEMLP(num_experts=nx, mlp_ratio=ratio, capacity_factor=cap, compute_dtype=jnp.float32)
    x = np.random.default_rng(seed).standard_normal((2, 8, e)).astype(np.float32)
    params = {"params": layer.init(jax.random.key(seed), jnp.asarray(x))["params"]}
    with torch.device("meta"):
        pm = moe.MoEMLP(e, nx, ratio, cap, torch.float32)
    return layer, params, pm, flax_to_torch(params, device="cpu"), x


@pytest.mark.parametrize("nx,ratio,cap", [(4, 2, 16.0), (4, 2, 1.25), (2, 1, 0.125)],
                         ids=["ample", "default", "overflow"])
def test_moe_mlp_matches_jax(nx, ratio, cap):
    """Out and aux within 1e-5 at ample capacity, the default 1.25 and an
    overflowing one (cap = 1 token an expert: at most nx rows nonzero, the
    rest fall through to the residual as zeros)."""
    layer, params, pm, p, x = _mlp_pair(nx, ratio, cap)
    ref, state = layer.apply(params, jnp.asarray(x), mutable=["losses"])
    ref_aux = float(jax.tree.leaves(state["losses"])[0])
    with torch.no_grad():
        out, aux = functional_call(pm, p, (torch.from_numpy(x),))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    assert abs(float(aux) - ref_aux) < 1e-5
    if cap < 1:
        rows = np.abs(out.numpy().reshape(-1, x.shape[-1])).sum(axis=1) > 1e-9
        assert rows.sum() <= nx


def _lm_pair(compute=(jnp.float32, torch.float32), kind="blockwise", layers=4, heads=2, e=32, nx=4, seed=0):
    jm = jax_moe.MoETransformerLM(vocab_size=VOCAB, num_layers=layers, num_heads=heads, embed_dim=e,
                                  num_experts=nx, attention_kind=kind, block_k=16, compute_dtype=compute[0])
    # Only the "params" collection: init also returns the "losses" its sow
    # wrote, which an apply with mutable=["losses"] would add to.
    params = {"params": jm.init(jax.random.key(seed), jnp.zeros((1, SEQ), jnp.int32))["params"]}
    with torch.device("meta"):
        pm = moe.MoETransformerLM(VOCAB, layers, heads, e, nx, attention_kind=kind, block_k=16,
                                  compute_dtype=compute[1])
    return jm, params, pm, flax_to_torch(params, device="cpu")


def _tokens(b=3, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, SEQ)).astype(np.int32)


def test_moe_lm_leaves_round_trip_and_names():
    """Stacked expert kernels keep the reference's layout ([X, E, M] / [X, M,
    E]); the router is a Dense kernel; flax -> port -> flax is exact."""
    _, params, pm, p = _lm_pair()
    assert p["blocks.1.moe.wi"].shape == (4, 32, 128) and p["blocks.1.moe.wo"].shape == (4, 128, 32)
    assert p["blocks.1.moe.router.weight"].shape == (4, 32)  # [X, E], the transpose of flax's kernel
    for got, want in zip(jax.tree.leaves(torch_to_flax(p)), jax.tree.leaves(params)):
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("kind", ["blockwise", "dense"])
def test_moe_lm_logits_and_aux_match_jax(kind):
    jm, params, pm, p = _lm_pair(kind=kind)
    x = _tokens()
    ref_logits, ref_aux = jax_moe.moe_lm_apply_with_aux(jm)(params, jnp.asarray(x))
    with torch.no_grad():
        logits, aux = moe.moe_lm_apply_with_aux(pm)(p, torch.from_numpy(x))
        plain = functional_call(pm, p, (torch.from_numpy(x),))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=1e-5, rtol=0)
    assert abs(float(aux) - float(ref_aux)) < 1e-5 and float(aux) > 0
    assert torch.equal(plain, logits)  # apply returns the logits alone


def test_moe_lm_flash_path_matches_jax_flash():
    """attention_kind="flash": the JAX package's Pallas kernels (interpret
    mode on the CPU) against the port's plain versions, f32, head size 16."""
    jm, params, pm, p = _lm_pair(kind="flash", layers=2)
    x = _tokens(2)
    ref_logits, ref_aux = jax_moe.moe_lm_apply_with_aux(jm)(params, jnp.asarray(x))
    with torch.no_grad():
        logits, aux = moe.moe_lm_apply_with_aux(pm)(p, torch.from_numpy(x))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=1e-5, rtol=0)
    assert abs(float(aux) - float(ref_aux)) < 1e-5


def test_moe_lm_bf16_logits_match_jax():
    """bf16 compute on both sides: every layer rounds to bf16 (2^-8
    relative), so the bar is 2^-4 of the largest logit over the 4 layers."""
    jm, params, pm, p = _lm_pair(compute=(jnp.bfloat16, torch.bfloat16))
    x = _tokens()
    ref_logits, ref_aux = jax_moe.moe_lm_apply_with_aux(jm)(params, jnp.asarray(x))
    with torch.no_grad():
        logits, aux = moe.moe_lm_apply_with_aux(pm)(p, torch.from_numpy(x))
    ref = np.asarray(ref_logits)
    np.testing.assert_allclose(logits.numpy(), ref, atol=2.0 ** -4 * float(np.abs(ref).max()), rtol=0)
    assert abs(float(aux) - float(ref_aux)) < 5e-2


def test_moe_lm_loss_gradients_match_jax():
    """Gradients of ``lm loss + 0.01 aux`` (the train objective) within 1e-4."""
    from p2pfl_tpu.models.transformer import causal_lm_loss as jax_loss
    from p2pfl_tpu_torch.models.transformer import causal_lm_loss

    jm, params, pm, p = _lm_pair()
    x = _tokens()
    apply = jax_moe.moe_lm_apply_with_aux(jm)

    def jax_objective(pp):
        logits, aux = apply(pp, jnp.asarray(x))
        return jax_loss(logits, jnp.asarray(x)) + 0.01 * aux

    ref = jax.grad(jax_objective)(params)
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    logits, aux = moe.moe_lm_apply_with_aux(pm)(leaves, torch.from_numpy(x))
    grads = torch.autograd.grad(causal_lm_loss(logits, torch.from_numpy(x)) + 0.01 * aux, list(leaves.values()))
    for got, want in zip(jax.tree.leaves(torch_to_flax(dict(zip(leaves, grads)))), jax.tree.leaves(ref)):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=0)


def test_moe_lm_model_trains_and_shards_as_the_identity():
    model = moe.moe_lm_model(seed=0, seq_len=SEQ, vocab_size=VOCAB, num_layers=2, num_heads=2, embed_dim=32,
                             num_experts=4, device="cpu")
    sharded = moe.shard_moe_params(model.params, Mesh({"expert": 4}, device="cpu"))
    assert all(torch.equal(sharded[k], v) for k, v in model.params.items())
    with pytest.raises(ValueError, match="axis"):
        moe.shard_moe_params(model.params, Mesh({"stage": 4}, device="cpu"))
    from p2pfl_tpu_torch.models.transformer import causal_lm_loss

    apply = moe.moe_lm_apply_with_aux(model.module)
    toks = torch.from_numpy(np.arange(4 * SEQ).reshape(4, SEQ) % VOCAB)
    opt = adam(5e-3)
    params, state, losses = dict(model.params), adam(5e-3).init(model.params), []
    for _ in range(20):
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        logits, aux = apply(leaves, toks)
        loss = causal_lm_loss(logits, toks) + 0.01 * aux
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        updates, state = opt.update(grads, state, params)
        params = apply_updates({k: v.detach() for k, v in params.items()}, updates)
        losses.append(float(loss.detach()))
    assert np.isfinite(losses).all() and losses[-1] < 0.5 * losses[0], losses


def test_moe_lm_model_signature_matches_jax():
    import inspect

    ref = list(inspect.signature(jax_moe.moe_lm_model).parameters)
    assert list(inspect.signature(moe.moe_lm_model).parameters) == ref + ["device"]
