"""The port's one-card GPipe schedule against sequential application and the
JAX package: ``pipeline_apply``, the pipelined train step and the pipelined
transformer LM.

Tolerances: f32 forwards 1e-5 (the pipeline runs each microbatch through the
same stages, so it differs from sequential application only in how the
batch is cut), the train step's parameters 1e-6 after one Adam step on
equal gradients. The JAX GPipe program itself (``shard_map`` over a stage
mesh) is not compiled here; its sequential semantics are, and the JAX
TransformerLM is the reference for the pipelined LM.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2pfl_tpu.models import transformer as jax_transformer
from p2pfl_tpu.parallel import pipeline as jax_pipeline
from p2pfl_tpu_torch.models.convert import flax_to_torch
from p2pfl_tpu_torch.models.model_handle import ModelHandle
from p2pfl_tpu_torch.models.transformer import TransformerLM, causal_lm_loss, init_params, transformer_lm_model
from p2pfl_tpu_torch.optim import adam, apply_updates
from p2pfl_tpu_torch.parallel import pipeline
from p2pfl_tpu_torch.parallel.mesh import Mesh

D, STAGES = 16, 4


def _stages(seed=0, n=STAGES):
    rng = np.random.default_rng(seed)
    return [{"w": rng.normal(scale=0.5, size=(D, D)).astype(np.float32),
             "b": rng.normal(scale=0.1, size=(D,)).astype(np.float32)} for _ in range(n)]


def _block(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _jax_block(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


@pytest.mark.parametrize("microbatches", [1, 2, 4, 8])
def test_pipeline_apply_equals_sequential_and_jax(microbatches):
    stages = _stages()
    mesh = Mesh({"stage": STAGES}, device="cpu")
    stacked = pipeline.stack_stage_params([{k: torch.from_numpy(v) for k, v in s.items()} for s in stages], mesh)
    x = np.random.default_rng(1).standard_normal((8 * STAGES, D)).astype(np.float32)
    piped = pipeline.pipeline_apply(stacked, torch.from_numpy(x), _block, mesh, microbatches)
    seq = pipeline.sequential_apply(stacked, torch.from_numpy(x), _block, STAGES)
    ref = jax_pipeline.sequential_apply(jax.tree.map(lambda *a: jnp.stack(a), *stages), jnp.asarray(x), _jax_block,
                                        STAGES)
    torch.testing.assert_close(piped, seq, atol=1e-5, rtol=0)
    np.testing.assert_allclose(piped.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_pipeline_schedule_runs_each_cell_once():
    """M microbatches through S stages: S * M block applications (the bubble
    cells hold no data), stage s seeing microbatch m at tick m + s."""
    seen = []

    def block(p, x):
        seen.append((int(p["id"]), int(x[0, 0])))
        return x + 1

    mesh = Mesh({"stage": 3}, device="cpu")
    stacked = pipeline.stack_stage_params([{"id": torch.tensor(s)} for s in range(3)])
    x = torch.arange(4, dtype=torch.float32).repeat_interleave(2)[:, None] * 10  # microbatch m holds 10 m
    out = pipeline.pipeline_apply(stacked, x, block, mesh, 4)
    torch.testing.assert_close(out, x + 3)
    assert len(seen) == 12
    assert seen[:3] == [(0, 0), (0, 10), (1, 1)]  # tick 0: stage 0 on mb 0; tick 1: stage 0 on mb 1, stage 1 on mb 0


def test_pipeline_rejects_what_the_reference_rejects():
    mesh = Mesh({"stage": STAGES}, device="cpu")
    stacked = pipeline.stack_stage_params([{k: torch.from_numpy(v) for k, v in s.items()} for s in _stages()])
    with pytest.raises(ValueError, match="microbatches"):
        pipeline.pipeline_apply(stacked, torch.zeros(6, D), _block, mesh, 4)
    with pytest.raises(ValueError, match="stages"):
        pipeline.pipeline_apply(stacked, torch.zeros(8, D), _block, Mesh({"stage": 2}, device="cpu"), 4)
    lm = transformer_lm_model(seed=0, vocab_size=32, num_layers=3, num_heads=2, embed_dim=16, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        pipeline.make_pipelined_transformer_lm(lm, Mesh({"stage": 2}, device="cpu"), 2)
    ring = transformer_lm_model(seed=0, vocab_size=32, num_layers=2, num_heads=2, embed_dim=16,
                                attention_kind="ring", axis_name="seq", device="cpu")
    with pytest.raises(ValueError, match="ring"):
        pipeline.make_pipelined_transformer_lm(ring, Mesh({"stage": 2}, device="cpu"), 2)


def test_pipeline_train_step_equals_the_unpipelined_step():
    """One Adam step through the pipelined forward and backward equals one on
    sequential application: loss 1e-6, gradients (hence parameters) 1e-6."""
    stages = _stages(2)
    mesh = Mesh({"stage": STAGES}, device="cpu")
    stacked = pipeline.stack_stage_params([{k: torch.from_numpy(v) for k, v in s.items()} for s in stages], mesh)
    rng = np.random.default_rng(3)
    x, y = (torch.from_numpy(rng.standard_normal((16, D)).astype(np.float32)) for _ in range(2))

    def loss_fn(o, t):
        return torch.mean((o - t) ** 2)

    opt = adam(1e-2)
    step = pipeline.make_pipeline_train_step(_block, loss_fn, opt, mesh, 4)
    new, _, loss = step(stacked, opt.init(pipeline._flatten(stacked)), x, y)
    flat = {k: v.detach().requires_grad_(True) for k, v in pipeline._flatten(stacked).items()}
    ref_loss = loss_fn(pipeline.sequential_apply(pipeline._unflatten(flat), x, _block, STAGES), y)
    grads = dict(zip(flat, torch.autograd.grad(ref_loss, list(flat.values()))))
    updates, _ = opt.update(grads, opt.init(flat), flat)
    ref = pipeline._unflatten(apply_updates(flat, updates))
    assert abs(float(loss) - float(ref_loss.detach())) < 1e-6
    for k in ("w", "b"):
        torch.testing.assert_close(new[k], ref[k], atol=1e-6, rtol=0)
        assert not torch.equal(new[k], stacked[k])


@pytest.mark.parametrize("kind", ["blockwise", "flash"])
def test_pipelined_lm_equals_jax_transformer_lm(kind):
    """The pipelined LM (4 layers over 2 stages, 2 microbatches) equals the
    JAX package's TransformerLM.apply on the same weights (f32, 1e-5) and
    the port's unpipelined model."""
    jm = jax_transformer.TransformerLM(vocab_size=32, num_layers=4, num_heads=2, embed_dim=32,
                                       attention_kind=kind, block_k=8, compute_dtype=jnp.float32)
    params = jm.init(jax.random.key(0), jnp.zeros((1, 16), jnp.int32))
    with torch.device("meta"):
        pm = TransformerLM(32, 4, 2, 32, kind, torch.float32, block_k=8)
    model = ModelHandle(flax_to_torch(params, device="cpu"), pm)
    toks = np.random.default_rng(0).integers(0, 32, (4, 16)).astype(np.int32)
    ref = np.asarray(jm.apply(params, jnp.asarray(toks)))
    pp_params, apply_fn = pipeline.make_pipelined_transformer_lm(model, Mesh({"stage": 2}, device="cpu"), 2)
    assert pp_params["stages"]["b0.attn.qkv.weight"].shape == (2, 96, 32)
    with torch.no_grad():
        got = apply_fn(pp_params, torch.from_numpy(toks))
        plain = model.apply(model.params, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    torch.testing.assert_close(got, plain, atol=1e-5, rtol=0)


def test_pipelined_lm_gradients_equal_the_unpipelined_model():
    """f32: the pipelined LM's loss gradients within 1e-5 of the model's."""
    with torch.device("meta"):
        module = TransformerLM(32, 4, 2, 32, "blockwise", torch.float32)
    model = ModelHandle(init_params(module, 0, "cpu"), module)
    pp_params, apply_fn = pipeline.make_pipelined_transformer_lm(model, Mesh({"stage": 4}, device="cpu"), 2)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 32, (4, 16)))
    flat = {k: v.clone().requires_grad_(True) for k, v in pipeline._flatten(pp_params).items()}
    g_pp = torch.autograd.grad(causal_lm_loss(apply_fn(pipeline._unflatten(flat), toks), toks), list(flat.values()))
    leaves = {k: v.clone().requires_grad_(True) for k, v in model.params.items()}
    g = dict(zip(leaves, torch.autograd.grad(causal_lm_loss(model.apply(leaves, toks), toks), list(leaves.values()))))
    got = dict(zip(flat, g_pp))
    for layer in range(4):
        for name in ("attn.qkv.weight", "mlp_out.bias", "ln1.weight"):
            torch.testing.assert_close(got[f"stages/b0.{name}"][layer], g[f"blocks.{layer}.{name}"],
                                       atol=1e-5, rtol=0)
    torch.testing.assert_close(got["embed/embed.weight"], g["embed.weight"], atol=1e-5, rtol=0)
