"""The port's transformer LM against the JAX package's, on weights carried
across with ``p2pfl_tpu_torch.models.convert``.

Same tokens (numpy, from a seed) go through flax ``TransformerLM(attention_kind
="flash")`` (Pallas in interpret mode on the CPU) and the port's
``TransformerLM`` (plain attention versions on the CPU). Tolerances: bf16
logits 6e-2 (tests/test_transformer.py's bar), f32 logits and loss
gradients 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from p2pfl_tpu.models.transformer import TransformerLM as JaxTransformerLM
from p2pfl_tpu.models.transformer import causal_lm_loss as jax_causal_lm_loss
from p2pfl_tpu.models.transformer import rotary_embedding as jax_rotary_embedding
from p2pfl_tpu_torch.models.convert import adam_state_from_optax, flax_to_torch, torch_to_flax
from p2pfl_tpu_torch.models.model_handle import ModelHandle
from p2pfl_tpu_torch.models.transformer import (
    TransformerLM,
    causal_lm_loss,
    rotary_embedding,
    transformer_lm_model,
)
from p2pfl_tpu_torch.optim import adam_init, adam_step

VOCAB, SEQ, B, LAYERS, HEADS, EMBED = 64, 32, 2, 2, 2, 32


def _jax_model(compute_dtype):
    module = JaxTransformerLM(
        vocab_size=VOCAB, num_layers=LAYERS, num_heads=HEADS, embed_dim=EMBED,
        attention_kind="flash", compute_dtype=compute_dtype,
    )
    params = module.init(jax.random.key(0), jnp.zeros((1, SEQ), jnp.int32))
    return module, params


def _port_model(flax_params, compute_dtype):
    module = TransformerLM(
        vocab_size=VOCAB, num_layers=LAYERS, num_heads=HEADS, embed_dim=EMBED,
        attention_kind="flash", compute_dtype=compute_dtype,
    )
    return ModelHandle(flax_to_torch(flax_params, device="cpu"), module)


def _tokens(seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, size=(B, SEQ)).astype(np.int32)


def test_rotary_matches_jax():
    x = np.random.default_rng(1).standard_normal((B, SEQ, HEADS, 16)).astype(np.float32)
    ref = jax_rotary_embedding(jnp.asarray(x))
    np.testing.assert_allclose(rotary_embedding(torch.from_numpy(x)).numpy(), np.asarray(ref), atol=1e-5)


def test_convert_round_trips_and_transposes_kernels():
    _, params = _jax_model(jnp.float32)
    port = flax_to_torch(params, device="cpu")
    qkv = params["params"]["block0"]["attn"]["qkv"]["kernel"]
    assert tuple(port["blocks.0.attn.qkv.weight"].shape) == (3 * EMBED, EMBED)
    np.testing.assert_array_equal(port["blocks.0.attn.qkv.weight"].numpy(), np.asarray(qkv).T)
    back = torch_to_flax(port)
    flat_ref = jax.tree_util.tree_leaves_with_path(params)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_ref) == len(flat_back)
    for path, leaf in flat_ref:
        np.testing.assert_array_equal(flat_back[path], np.asarray(leaf))


def test_bf16_logits_match_jax():
    module, params = _jax_model(jnp.bfloat16)
    toks = _tokens()
    ref = np.asarray(module.apply(params, jnp.asarray(toks)))
    model = _port_model(params, torch.bfloat16)
    with torch.no_grad():
        out = model.apply(model.params, torch.from_numpy(toks))
    assert out.dtype == torch.float32 and out.shape == (B, SEQ, VOCAB)
    np.testing.assert_allclose(out.numpy(), ref, atol=6e-2)


def test_f32_logits_and_loss_grads_match_jax():
    module, params = _jax_model(jnp.float32)
    toks = _tokens(2)
    mask = np.ones((B, SEQ), np.float32)
    mask[1, SEQ // 2:] = 0.0

    def loss_j(p):
        return jax_causal_lm_loss(module.apply(p, jnp.asarray(toks)), jnp.asarray(toks), jnp.asarray(mask))

    ref_logits = np.asarray(module.apply(params, jnp.asarray(toks)))
    ref_loss, ref_grads = jax.value_and_grad(loss_j)(params)
    model = _port_model(params, torch.float32)
    leaves = {k: v.clone().requires_grad_(True) for k, v in model.params.items()}
    logits = model.apply(leaves, torch.from_numpy(toks))
    np.testing.assert_allclose(logits.detach().numpy(), ref_logits, atol=1e-4)
    loss = causal_lm_loss(logits, torch.from_numpy(toks), torch.from_numpy(mask))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=1e-5)
    ref_port = flax_to_torch(ref_grads, device="cpu")
    for name, leaf in leaves.items():
        np.testing.assert_allclose(leaf.grad.numpy(), ref_port[name].numpy(), atol=1e-4, err_msg=name)


def test_adam_matches_optax_over_steps():
    rng = np.random.default_rng(3)
    _, params = _jax_model(jnp.float32)
    tx = optax.adam(1e-3)
    state_j = tx.init(params)
    p_j = params
    p_t = flax_to_torch(params, device="cpu")
    state_t = adam_init(p_t)
    for _ in range(3):
        grads = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape), jnp.float32), params)
        upd, state_j = tx.update(grads, state_j, p_j)
        p_j = optax.apply_updates(p_j, upd)
        p_t, state_t = adam_step(p_t, flax_to_torch(grads, device="cpu"), state_t, 1e-3)
    ref_p = flax_to_torch(p_j, device="cpu")
    ref_s = adam_state_from_optax(state_j, device="cpu")
    assert int(state_t.count) == int(ref_s.count) == 3
    for name in p_t:
        np.testing.assert_allclose(p_t[name].numpy(), ref_p[name].numpy(), atol=1e-6, err_msg=name)
        np.testing.assert_allclose(state_t.mu[name].numpy(), ref_s.mu[name].numpy(), atol=1e-6)
        np.testing.assert_allclose(state_t.nu[name].numpy(), ref_s.nu[name].numpy(), atol=1e-6)


def test_transformer_lm_model_is_seeded_and_shaped():
    a = transformer_lm_model(seed=3, vocab_size=VOCAB, num_layers=LAYERS, num_heads=HEADS,
                             embed_dim=EMBED, device="cpu")
    b = transformer_lm_model(seed=3, vocab_size=VOCAB, num_layers=LAYERS, num_heads=HEADS,
                             embed_dim=EMBED, device="cpu")
    _, ref = _jax_model(jnp.float32)
    shapes = {k: tuple(v.shape) for k, v in flax_to_torch(ref, device="cpu").items()}
    assert {k: tuple(v.shape) for k, v in a.params.items()} == shapes
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k])
    with torch.no_grad():
        logits = a.apply(a.params, torch.from_numpy(_tokens()))
    assert torch.isfinite(logits).all()
    with pytest.raises(ValueError, match="missing"):
        ModelHandle({}, a.module)
