"""The port's classification models against the JAX package's, on weights
carried across with ``p2pfl_tpu_torch.models.convert``.

Same inputs (numpy, from a seed) go through the flax modules and the
port's. Tolerances: MLP logits 5e-2 in bf16 (one bf16 rounding of values
of order 1 per layer) and 1e-5 in f32; the classifier's f32 logits and loss
gradients 1e-5 / 1e-4 at every attention kind (flash through Pallas in
interpret mode on the JAX side, the plain versions on the port's); the
flash path at head sizes 16 and 32 within tests/test_attention.py's f32
tolerances (forward 1e-5, gradients 1e-4).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2pfl_tpu.learning.learner import softmax_cross_entropy as jax_softmax_cross_entropy
from p2pfl_tpu.models import mlp as jax_mlp
from p2pfl_tpu.models import transformer as jax_transformer
from p2pfl_tpu.ops.attention import flash_attention as jax_flash_attention
from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.learning.learner import softmax_cross_entropy
from p2pfl_tpu_torch.models import mlp, transformer
from p2pfl_tpu_torch.models.convert import flax_to_torch, torch_to_flax
from p2pfl_tpu_torch.models.model_handle import ModelHandle
from p2pfl_tpu_torch.ops import attention as port_attention

B, SEQ, VOCAB, CLASSES = 3, 32, 32, 4
# (embed_dim, heads): head size 16 and 32, one layer each.
WIDTHS = [(32, 2), (64, 2)]


def _mlp_pair(compute_jax, compute_torch):
    jm = jax_mlp.MLP(hidden_sizes=(16, 8), out_channels=10, compute_dtype=compute_jax)
    params = jm.init(jax.random.key(0), jnp.zeros((1, 28, 28)))
    with torch.device("meta"):
        pm = mlp.MLP(784, (16, 8), 10, compute_torch)
    return jm, params, ModelHandle(flax_to_torch(params, device="cpu"), pm)


def _images(seed=0):
    return np.random.default_rng(seed).standard_normal((B, 28, 28)).astype(np.float32)


@pytest.mark.parametrize(
    "compute_jax,compute_torch,atol",
    [(jnp.float32, torch.float32, 1e-5), (jnp.bfloat16, torch.bfloat16, 5e-2)],
    ids=["f32", "bf16"],
)
def test_mlp_logits_match_jax(compute_jax, compute_torch, atol):
    jm, params, model = _mlp_pair(compute_jax, compute_torch)
    x = _images()
    ref = np.asarray(jm.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        out = model.apply(model.params, torch.from_numpy(x))
    assert out.dtype == torch.float32 and out.shape == (B, 10)
    np.testing.assert_allclose(out.numpy(), ref, atol=atol)


def test_mlp_loss_grads_match_jax():
    jm, params, model = _mlp_pair(jnp.float32, torch.float32)
    x = _images(1)
    y = np.array([1, 7, 3], np.int32)
    w = np.array([1.0, 1.0, 0.0], np.float32)

    def loss_j(p):
        return jax_softmax_cross_entropy(jm.apply(p, jnp.asarray(x)), jnp.asarray(y), jnp.asarray(w))

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_j))(params)
    leaves = {k: v.clone().requires_grad_(True) for k, v in model.params.items()}
    loss = softmax_cross_entropy(model.apply(leaves, torch.from_numpy(x)), torch.from_numpy(y), torch.from_numpy(w))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=1e-6)
    ref_port = flax_to_torch(ref_grads, device="cpu")
    for name, leaf in leaves.items():
        np.testing.assert_allclose(leaf.grad.numpy(), ref_port[name].numpy(), atol=1e-5, err_msg=name)


def test_mlp_model_shapes_names_and_seed():
    a = mlp.mlp_model(seed=3, device="cpu")
    b = mlp.mlp_model(seed=3, device="cpu")
    c = mlp.mlp_model(seed=4, device="cpu")
    ref = jax_mlp.mlp_model(seed=3)
    ref_flat = flax_to_torch(ref.params, device="cpu")
    assert {k: tuple(v.shape) for k, v in a.params.items()} == {k: tuple(v.shape) for k, v in ref_flat.items()}
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    assert not torch.equal(a.params["Dense_0.weight"], c.params["Dense_0.weight"])
    # flax's defaults: lecun-normal kernels (std 1/sqrt(fan_in)), zero biases.
    w = a.params["Dense_0.weight"]
    assert abs(float(w.std()) * np.sqrt(784) - 1.0) < 0.05
    assert not a.params["Dense_0.bias"].any()
    assert a.module.compute_dtype == getattr(torch, Settings.COMPUTE_DTYPE)
    out = a.apply(a.params, torch.zeros(2, 28, 28))
    assert out.dtype == torch.float32 and out.shape == (2, 10)


def _classifier_pair(embed, heads, kind, compute_jax=jnp.float32, compute_torch=torch.float32):
    jm = jax_transformer.TransformerClassifier(
        num_classes=CLASSES, vocab_size=VOCAB, num_layers=1, num_heads=heads, embed_dim=embed,
        attention_kind=kind, block_k=16, compute_dtype=compute_jax,
    )
    params = jm.init(jax.random.key(1), jnp.zeros((1, SEQ), jnp.int32))
    with torch.device("meta"):
        pm = transformer.TransformerClassifier(
            num_classes=CLASSES, vocab_size=VOCAB, num_layers=1, num_heads=heads, embed_dim=embed,
            attention_kind=kind, compute_dtype=compute_torch, block_k=16,
        )
    return jm, params, ModelHandle(flax_to_torch(params, device="cpu"), pm)


def _tokens(seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, size=(B, SEQ)).astype(np.int32)


@pytest.mark.parametrize("kind", ["dense", "blockwise", "flash"])
@pytest.mark.parametrize("embed,heads", WIDTHS, ids=["D16", "D32"])
def test_classifier_f32_logits_and_grads_match_jax(embed, heads, kind):
    jm, params, model = _classifier_pair(embed, heads, kind)
    toks = _tokens(2)
    y = np.array([0, 3, 1], np.int32)
    w = np.ones(B, np.float32)

    def loss_j(p):
        return jax_softmax_cross_entropy(jm.apply(p, jnp.asarray(toks)), jnp.asarray(y), jnp.asarray(w))

    ref_logits = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(toks)))
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_j))(params)
    leaves = {k: v.clone().requires_grad_(True) for k, v in model.params.items()}
    logits = model.apply(leaves, torch.from_numpy(toks))
    assert logits.dtype == torch.float32 and logits.shape == (B, CLASSES)
    np.testing.assert_allclose(logits.detach().numpy(), ref_logits, atol=1e-5)
    loss = softmax_cross_entropy(logits, torch.from_numpy(y), torch.from_numpy(w))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=1e-5)
    ref_port = flax_to_torch(ref_grads, device="cpu")
    for name, leaf in leaves.items():
        np.testing.assert_allclose(leaf.grad.numpy(), ref_port[name].numpy(), atol=1e-4, err_msg=name)


def test_classifier_bf16_logits_match_jax():
    jm, params, model = _classifier_pair(64, 2, "flash", jnp.bfloat16, torch.bfloat16)
    toks = _tokens(3)
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(toks)))
    with torch.no_grad():
        out = model.apply(model.params, torch.from_numpy(toks))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=6e-2)


@pytest.mark.parametrize(
    "params_fn",
    [lambda: _mlp_pair(jnp.float32, torch.float32)[1], lambda: _classifier_pair(32, 2, "blockwise")[1]],
    ids=["mlp", "classifier"],
)
def test_convert_round_trips_classification_trees(params_fn):
    params = params_fn()
    port = flax_to_torch(params, device="cpu")
    back = torch_to_flax(port)
    flat_ref = jax.tree_util.tree_leaves_with_path(params)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_ref) == len(flat_back)
    for path, leaf in flat_ref:
        np.testing.assert_array_equal(flat_back[path], np.asarray(leaf))


def test_classifier_tree_names_map_to_the_port_module():
    _, params, model = _classifier_pair(32, 2, "blockwise")
    names = set(dict(model.module.named_parameters(recurse=True)))
    assert set(flax_to_torch(params, device="cpu")) == names
    assert {"embed.weight", "ln_f.weight", "ln_f.bias", "head.weight", "head.bias"} <= names
    assert tuple(model.params["head.weight"].shape) == (CLASSES, 32)


def test_transformer_classifier_model_defaults_and_seed():
    a = transformer.transformer_classifier_model(seed=0, device="cpu")
    b = transformer.transformer_classifier_model(seed=0, device="cpu")
    ref = jax.eval_shape(jax_transformer.TransformerClassifier().init, jax.random.key(0),
                         jnp.zeros((1, 64), jnp.int32))
    shapes = jax.tree.map(lambda a: tuple(a.shape), torch_to_flax(a.params))
    assert shapes == jax.tree.map(lambda s: tuple(s.shape), ref)
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    attn = a.module.blocks[0].attn
    assert attn.attention_kind == "blockwise" and 128 // attn.num_heads == 32  # head size 32
    out = a.apply(a.params, torch.zeros(2, 64, dtype=torch.long))
    assert out.shape == (2, 10) and out.dtype == torch.float32
    with pytest.raises(ValueError, match="seq_len"):
        transformer.transformer_classifier_model(seq_len=0, device="cpu")


@pytest.mark.parametrize(
    "port_fn,ref_fn",
    [
        (mlp.mlp_model, jax_mlp.mlp_model),
        (transformer.transformer_classifier_model, jax_transformer.transformer_classifier_model),
        (transformer.transformer_lm_model, jax_transformer.transformer_lm_model),
    ],
    ids=["mlp_model", "transformer_classifier_model", "transformer_lm_model"],
)
def test_model_factory_signatures_match_jax(port_fn, ref_fn):
    port = inspect.signature(port_fn).parameters
    ref = inspect.signature(ref_fn).parameters
    assert list(port) == [*ref, "device"]
    for name, p in ref.items():
        assert port[name].default == p.default, name
    assert port["device"].default == "cuda"


@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_path_at_narrow_heads_matches_jax_flash(d, causal):
    rng = np.random.default_rng(d)
    q, k, v = (rng.standard_normal((2, 48, 2, d)).astype(np.float32) for _ in range(3))

    def loss_j(q, k, v):
        return jnp.sum(jax_flash_attention(q, k, v, causal, 16, 16) ** 2)

    qj, kj, vj = map(jnp.asarray, (q, k, v))
    out_j = jax_flash_attention(qj, kj, vj, causal, 16, 16)
    g_j = jax.grad(loss_j, argnums=(0, 1, 2))(qj, kj, vj)
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = port_attention.flash_attention(qt, kt, vt, causal, 16, 16)
    (out**2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=1e-5)
    for a, b in zip((qt.grad, kt.grad, vt.grad), g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
