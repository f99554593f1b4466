"""The port's plain flash versions at narrow and wide head sizes against the
JAX package's flash attention and carry fold. Narrow: the plain forward and
its lse, and the plain dq, dk and dv, at 8, 20, 40, 48 and 63, head sizes
the card's bf16 forward and backward pair run on the narrow tensor-core
kernels (8, 40, 48 at the true size, 20 zero-padded to 24) or, at 63, on
the D 64 kernels; the plain carry fold at every multiple of 8 below 64, the
narrow carry kernel's head sizes, and at 12 and 60 (zero-padded to 16 and,
for the D 64 carry kernel, to 64). Wide: 384 and 512 (the widest compiled
instances: 384 is zero-padded to 512), and 576, 640 and 1024, which the card
runs with D zero-padded to a multiple of 64: bf16 on the grouped tensor-core
kernels (groups of up to four 64-column panels of O or acc; at 576 and 640
the last group holds one and two), f32 on the chunked kernels (the score
tiles built a 64-column panel at a time); the carry also at 128 and 256,
the grouped carry's one partial and one full group.

Same inputs (numpy, from a seed) go through the JAX functions (Pallas in
interpret mode on the CPU, as tests/test_attention.py runs them) and the
port's plain versions, which the kernels are held to on the card
(tests/test_torch_kernels.py). Tolerances are tests/test_attention.py's f32
ones: forward and carry 1e-5, gradients 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2pfl_tpu.ops.attention import _flash_forward as jax_flash_forward
from p2pfl_tpu.ops.attention import flash_attention as jax_flash_attention
from p2pfl_tpu.ops.attention import flash_chunk_update as jax_flash_chunk_update
from p2pfl_tpu_torch.ops import attention as port

B, S, H = 1, 32, 1


def _qkv(seed, d, s=S):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, s, H, d)).astype(np.float32) for _ in range(3))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [8, 20, 40, 48, 63])
def test_plain_flash_forward_and_lse_match_jax_at_narrow_heads(d, causal):
    """The plain forward (``plain_flash_forward``, the version the narrow
    kernel is held to on the card) and its lse against the JAX forward
    kernel's (interpret mode), within 1e-5."""
    q, k, v = _qkv(d + 2, d)
    out_j, lse_j = jax_flash_forward(*map(jnp.asarray, (q, k, v)), causal, 16, 16, True)
    out, lse = port.plain_flash_forward(*(torch.tensor(a) for a in (q, k, v)), causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[..., 0], atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [8, 20, 40, 48, 63])
def test_plain_flash_backward_matches_jax_grad_at_narrow_heads(d, causal):
    """The plain dq and dk/dv (``plain_flash_backward_dq`` /
    ``plain_flash_backward_dkv``, the versions the narrow backward kernels
    are held to on the card), from the plain forward's lse and delta =
    rowsum(dO * O), against ``jax.vjp`` of the JAX flash attention (its
    Pallas backward pair, interpret mode) under the same random cotangent,
    within 1e-4."""
    q, k, v = _qkv(d + 3, d)
    g = np.random.default_rng(d + 4).standard_normal(q.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda q, k, v: jax_flash_attention(q, k, v, causal, 16, 16), *map(jnp.asarray, (q, k, v)))
    grads_j = vjp(jnp.asarray(g))
    qt, kt, vt, gt = (torch.tensor(a) for a in (q, k, v, g))
    out, lse = port.plain_flash_forward(qt, kt, vt, causal)
    delta = (gt * out).sum(-1).transpose(1, 2).contiguous()
    dq = port.plain_flash_backward_dq(qt, kt, vt, gt, lse, delta, causal)
    dk, dv = port.plain_flash_backward_dkv(qt, kt, vt, gt, lse, delta, causal)
    for got, ref, name in zip((dq, dk, dv), grads_j, ("dq", "dk", "dv")):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [384, 512, 576, 640, 1024])
def test_plain_flash_forward_and_grads_match_jax_at_wide_heads(d, causal):
    q, k, v = _qkv(d, d)

    def loss_j(q, k, v):
        return jnp.sum(jax_flash_attention(q, k, v, causal, 16, 16) ** 2)

    qj, kj, vj = map(jnp.asarray, (q, k, v))
    out_j = jax_flash_attention(qj, kj, vj, causal, 16, 16)
    g_j = jax.grad(loss_j, argnums=(0, 1, 2))(qj, kj, vj)
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = port.flash_attention(qt, kt, vt, causal, 16, 16)
    (out**2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=1e-5)
    for a, b in zip((qt.grad, kt.grad, vt.grad), g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


@pytest.mark.parametrize("d", [128, 256, 384, 512, 576, 640, 1024])
def test_plain_chunk_update_matches_jax_at_wide_heads(d):
    """Chunk 1 of 2 (16 positions each) folds its own chunk (the diagonal),
    then the past chunk 0, into a fresh carry; the carry after each fold
    within 1e-5 of the JAX kernel's. From 128 up the card's bf16 fold runs
    the grouped tensor-core carry, held to this plain version."""
    _assert_chunk_updates_match_jax(d)


@pytest.mark.parametrize("d", [8, 12, 16, 24, 32, 40, 48, 56, 60])
def test_plain_chunk_update_matches_jax_at_narrow_heads(d):
    """The narrow twin of the wide test above: the diagonal fold, then the
    past fold, within 1e-5 of the JAX kernel's carry. Below 57 the card's
    bf16 fold runs the narrow tensor-core carry at D rounded up to a
    multiple of 8 (12 to 16), from 57 the D 64 one (60 padded to 64), both
    held to this plain version."""
    _assert_chunk_updates_match_jax(d)


def _assert_chunk_updates_match_jax(d):
    q, k, v = _qkv(d + 1, d)
    s = S // 2
    qc = q[:, s:]
    carry_p = port.init_carry(qc.shape, "cpu")
    carry_j = (jnp.full((B, H, s, 128), -jnp.inf, jnp.float32), jnp.zeros((B, H, s, 128), jnp.float32),
               jnp.zeros((B, H, s, d), jnp.float32))
    for j in (1, 0):
        kc, vc = k[:, j * s:(j + 1) * s], v[:, j * s:(j + 1) * s]
        carry_j = jax_flash_chunk_update(
            carry_j, *(jnp.moveaxis(jnp.asarray(a), 2, 1) for a in (qc, kc, vc)), s, j * s,
            causal=True, block_q=16, block_k=16,
        )
        carry_p = port.flash_chunk_update(carry_p, *(torch.tensor(a) for a in (qc, kc, vc)), s, j * s, True, 16, 16)
        m_j, l_j, acc_j = (np.asarray(x) for x in carry_j)
        for got, ref in zip(carry_p, (m_j[..., 0], l_j[..., 0], np.swapaxes(acc_j, 1, 2))):
            np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, err_msg=f"chunk {j}")
