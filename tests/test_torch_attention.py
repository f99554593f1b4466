"""The port's attention against the JAX package's flash attention.

Same inputs (numpy, from a seed) go through the JAX functions (Pallas in
interpret mode on the CPU, as tests/test_attention.py runs them) and the
port's. On the CPU the port runs its plain versions (the Hopper kernels
are held against them in tests/test_torch_kernels.py, on the card).
Tolerances are tests/test_attention.py's: f32 forward 1e-5, f32 gradients
1e-4, bf16 5e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2pfl_tpu.ops.attention import _flash_backward, _flash_forward
from p2pfl_tpu.ops.attention import dense_attention as jax_dense_attention
from p2pfl_tpu.ops.attention import flash_attention as jax_flash_attention
from p2pfl_tpu_torch.ops import attention as port

B, H, D = 2, 2, 16


def _qkvg(seed, s, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, s, H, D)).astype(dtype) for _ in range(4))


def _t(a, dtype=torch.float32, grad=False):
    return torch.tensor(a, dtype=dtype, requires_grad=grad)


def _block(s):
    return 16 if s % 16 == 0 else 32  # S=48 with 32 -> JAX shrinks it to 24


@pytest.mark.parametrize("s", [64, 48])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_forward_matches_jax_flash_forward(s, causal):
    q, k, v, _ = _qkvg(0, s)
    out_j, lse_j = _flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, _block(s), _block(s), True
    )
    out, lse = port.flash_forward(_t(q), _t(k), _t(v), causal, with_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[..., 0], atol=1e-5)


@pytest.mark.parametrize("s", [64, 48])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_matches_jax_flash_backward(s, causal):
    q, k, v, g = _qkvg(1, s)
    qj, kj, vj, gj = map(jnp.asarray, (q, k, v, g))
    out_j, lse_j = _flash_forward(qj, kj, vj, causal, _block(s), _block(s), True)
    dq_j, dk_j, dv_j = _flash_backward(
        qj, kj, vj, out_j, lse_j[..., :1], gj, causal, _block(s), _block(s), True
    )
    # Same out, lse and g on both sides.
    lse = _t(np.asarray(lse_j)[..., 0])
    dq, dk, dv = port.flash_backward(_t(q), _t(k), _t(v), _t(np.asarray(out_j)), lse, _t(g), causal)
    for a, b in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


def test_no_lse_forward_matches_dense():
    q, k, v, _ = _qkvg(2, 48)
    ref = jax_dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    out, lse = port.flash_forward(_t(q), _t(k), _t(v), True, with_lse=False)
    assert lse is None
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    dense = port.dense_attention(_t(q), _t(k), _t(v), causal=True)
    np.testing.assert_allclose(dense.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_autograd_function_matches_jax_grad(causal):
    q, k, v, _ = _qkvg(3, 64)

    def loss_j(q, k, v):
        return jnp.sum(jax_flash_attention(q, k, v, causal, 16, 16) ** 2)

    out_j = jax_flash_attention(*map(jnp.asarray, (q, k, v)), causal, 16, 16)
    g_j = jax.grad(loss_j, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt = _t(q, grad=True), _t(k, grad=True), _t(v, grad=True)
    out = port.flash_attention(qt, kt, vt, causal, 16, 16)
    (out**2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=1e-5)
    for a, b in zip((qt.grad, kt.grad, vt.grad), g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


def test_bf16_forward_and_grad_match_jax():
    q, k, v, _ = _qkvg(4, 48)
    qj, kj, vj = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))

    def loss_j(q, k, v):
        return jnp.sum(jax_flash_attention(q, k, v, True, 32, 32).astype(jnp.float32) ** 2)

    out_j = jax_flash_attention(qj, kj, vj, True, 32, 32)
    g_j = jax.grad(loss_j, argnums=(0, 1, 2))(qj, kj, vj)
    qt, kt, vt = (_t(a, torch.bfloat16, grad=True) for a in (q, k, v))
    out = port.flash_attention(qt, kt, vt, True, 32, 32)
    (out.float() ** 2).sum().backward()
    assert out.dtype == torch.bfloat16 and qt.grad.dtype == torch.bfloat16
    for a, b in ((out.detach(), out_j), (qt.grad, g_j[0]), (kt.grad, g_j[1]), (vt.grad, g_j[2])):
        a = a.float().numpy()
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, np.asarray(b, np.float32), atol=5e-2)
