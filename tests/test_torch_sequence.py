"""The port's sequence-parallel LM path against the JAX package's.

The JAX side runs ``TransformerLM(attention_kind="ring" | "ring_flash",
axis_name="seq")`` under ``shard_map`` on 4 devices of the virtual CPU mesh
(``sequence_parallel_apply`` / ``_lm_loss`` / ``make_sequence_parallel_train_step``,
Pallas in interpret mode); the port runs the same weights, carried across
with ``models/convert.py``, on one device with a 4-shard ``"seq"`` axis.
Tolerances: f32 logits and loss 1e-4, bf16 logits 6e-2
(tests/test_transformer.py's bar), params after 3 Adam steps 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from p2pfl_tpu.models.transformer import TransformerLM as JaxTransformerLM
from p2pfl_tpu.models.transformer import transformer_lm_model as jax_transformer_lm_model
from p2pfl_tpu.parallel.sequence import make_sequence_parallel_train_step as jax_train_step
from p2pfl_tpu.parallel.sequence import sequence_parallel_apply as jax_sp_apply
from p2pfl_tpu.parallel.sequence import sequence_parallel_lm_loss as jax_sp_loss
from p2pfl_tpu_torch.models.convert import flax_to_torch
from p2pfl_tpu_torch.models.model_handle import ModelHandle
from p2pfl_tpu_torch.models.transformer import TransformerLM, transformer_lm_model
from p2pfl_tpu_torch.optim import adam
from p2pfl_tpu_torch.parallel.mesh import Mesh
from p2pfl_tpu_torch.parallel.sequence import (
    make_sequence_parallel_train_step,
    sequence_parallel_apply,
    sequence_parallel_attention,
    sequence_parallel_lm_loss,
    shard_tokens,
)

VOCAB, SEQ, B, LAYERS, HEADS, EMBED, N = 64, 64, 2, 2, 2, 32, 4


def _models(kind, compute_dtype):
    jax_dtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[compute_dtype]
    jm = JaxTransformerLM(vocab_size=VOCAB, num_layers=LAYERS, num_heads=HEADS, embed_dim=EMBED,
                          attention_kind=kind, axis_name="seq", block_k=8, compute_dtype=jax_dtype)
    # Init never runs the ring: the blockwise twin has the same parameters.
    params = jm.copy(attention_kind="blockwise", axis_name=None).init(
        jax.random.key(0), jnp.zeros((1, SEQ), jnp.int32))
    with torch.device("meta"):
        pm = TransformerLM(vocab_size=VOCAB, num_layers=LAYERS, num_heads=HEADS, embed_dim=EMBED,
                           attention_kind=kind, axis_name="seq", block_k=8, compute_dtype=compute_dtype)
    return jm, params, ModelHandle(flax_to_torch(params, device="cpu"), pm)


def _meshes():
    return JaxMesh(np.array(jax.devices()[:N]), ("seq",)), Mesh({"seq": N}, device="cpu")


def _tokens(seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, size=(B, SEQ)).astype(np.int32)


@pytest.mark.parametrize("kind", ["ring", "ring_flash"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 6e-2)])
def test_ring_lm_logits_and_loss_match_jax(kind, dtype, tol):
    jm, params, model = _models(kind, dtype)
    jmesh, mesh = _meshes()
    toks = _tokens()
    ref = np.asarray(jax.jit(jax_sp_apply(jm.apply, jmesh, "seq"))(params, jnp.asarray(toks)))
    ref_loss = float(jax.jit(jax_sp_loss(jm.apply, jmesh, "seq"))(params, jnp.asarray(toks)))
    tokens = shard_tokens(toks, mesh)
    with torch.no_grad():
        out = sequence_parallel_apply(model.apply, mesh)(model.params, tokens)
        loss = sequence_parallel_lm_loss(model.apply, mesh)(model.params, tokens)
    assert out.dtype == torch.float32 and out.shape == (B, SEQ, VOCAB)
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), ref, atol=tol)
    np.testing.assert_allclose(loss.item(), ref_loss, atol=tol)


def test_ring_flash_train_steps_match_jax():
    """Three ``make_sequence_parallel_train_step`` steps (f32 compute, Adam
    1e-3) from the same weights on the same tokens: losses and params."""
    jm, params, model = _models("ring_flash", torch.float32)
    jmesh, mesh = _meshes()
    toks = _tokens(1)
    tx = optax.adam(1e-3)
    step_j = jax_train_step(jm.apply, tx, jmesh, "seq")
    p_j, s_j = params, tx.init(params)
    opt = adam(1e-3)
    step = make_sequence_parallel_train_step(model.apply, opt, mesh, "seq")
    p_t, s_t = model.params, opt.init(model.params)
    tokens = shard_tokens(toks, mesh)
    losses = []
    for i in range(3):
        p_j, s_j, loss_j = step_j(p_j, s_j, jnp.asarray(toks))
        p_t, s_t, loss_t = step(p_t, s_t, tokens)
        np.testing.assert_allclose(loss_t.item(), float(loss_j), atol=1e-4, err_msg=f"step {i}")
        losses.append(loss_t.item())
    assert int(s_t.count) == 3 and losses[-1] < losses[0]
    ref = flax_to_torch(p_j, device="cpu")
    for name, p in p_t.items():
        np.testing.assert_allclose(p.numpy(), ref[name].numpy(), atol=1e-4, err_msg=name)


def test_sequence_parallel_attention_is_exact_attention():
    from p2pfl_tpu_torch.ops.attention import dense_attention

    rng = np.random.default_rng(2)
    q, k, v = (torch.tensor(rng.standard_normal((B, SEQ, HEADS, 16)), dtype=torch.float32) for _ in range(3))
    _, mesh = _meshes()
    for impl, tol in (("blockwise", 1e-5), ("flash", 2e-3)):
        out = sequence_parallel_attention(mesh, "seq", True, 8, impl)(q, k, v)
        torch.testing.assert_close(out, dense_attention(q, k, v), atol=tol, rtol=0)


def test_wrappers_validate_axes_and_shapes():
    _, _, model = _models("ring", torch.float32)
    mesh = Mesh({"seq": N, "data": 2}, device="cpu")
    with pytest.raises(ValueError, match="no axis 'model'"):
        sequence_parallel_apply(model.apply, mesh, "model")
    with pytest.raises(ValueError, match="no axis 'batch'"):
        sequence_parallel_lm_loss(model.apply, mesh, "seq", batch_axis="batch")
    with pytest.raises(ValueError, match="does not divide"):
        shard_tokens(np.zeros((B, SEQ - 2), np.int32), mesh)
    with pytest.raises(ValueError, match="does not divide"):
        shard_tokens(np.zeros((3, SEQ), np.int32), mesh, batch_axis="data")
    with pytest.raises(ValueError, match="integers"):
        shard_tokens(np.zeros((B, SEQ), np.float32), mesh)
    # A batch axis collapses on one card: the same loss as without it.
    toks = shard_tokens(_tokens(3), mesh, batch_axis="data")
    with torch.no_grad():
        a = sequence_parallel_lm_loss(model.apply, mesh, "seq", "data")(model.params, toks)
        b = sequence_parallel_lm_loss(model.apply, mesh, "seq")(model.params, toks)
    assert torch.equal(a, b)
    # The ring model outside a wrapper has no bound axis.
    with pytest.raises(NameError, match="unbound axis name"):
        model.apply(model.params, toks)


def test_transformer_lm_model_takes_the_jax_argument_order():
    """``(seed, seq_len, vocab_size, num_layers, num_heads, embed_dim,
    attention_kind, axis_name)`` positionally, as in the JAX package: the
    same parameter names and shapes for a ring model."""
    ref = jax_transformer_lm_model(3, SEQ, VOCAB, LAYERS, HEADS, EMBED, "ring", "seq")
    got = transformer_lm_model(3, SEQ, VOCAB, LAYERS, HEADS, EMBED, "ring", "seq", "cpu")
    shapes = {k: tuple(v.shape) for k, v in flax_to_torch(ref.params, device="cpu").items()}
    assert {k: tuple(v.shape) for k, v in got.params.items()} == shapes
    assert got.module.blocks[0].attn.axis_name == "seq"
    for bad in (0, 2.5):
        with pytest.raises(ValueError, match="seq_len"):
            transformer_lm_model(3, bad, VOCAB, device="cpu")
