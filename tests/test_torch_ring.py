"""The port's online-softmax carry, blockwise fold and ring attention against
the JAX package's.

Same inputs (numpy, from a seed) go through the JAX functions (Pallas in
interpret mode on the CPU, the ring under ``shard_map`` on the 8-device
virtual CPU mesh, as tests/test_attention.py runs them) and the port's (plain
versions on the CPU; one card, the ring as a loop of chunk folds).
Tolerances: the carry fold 1e-5 (f32); its bf16 kernel's arithmetic (P split
into two bf16 halves) the carry bar of tests/test_torch_kernels.py; blockwise
and remat flash 1e-5 forward, 1e-4 gradients; the ring at
tests/test_attention.py's bars against dense (blockwise 1e-5 forward and 1e-4
gradients, flash 2e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from p2pfl_tpu.ops.attention import blockwise_attention as jax_blockwise_attention
from p2pfl_tpu.ops.attention import dense_attention as jax_dense_attention
from p2pfl_tpu.ops.attention import flash_attention as jax_flash_attention
from p2pfl_tpu.ops.attention import flash_chunk_update as jax_flash_chunk_update
from p2pfl_tpu.ops.ring_attention import ring_attention as jax_ring_attention
from p2pfl_tpu.utils.compat import shard_map
from p2pfl_tpu_torch.models.transformer import SelfAttention
from p2pfl_tpu_torch.ops import attention as port
from p2pfl_tpu_torch.ops.ring_attention import ring_attention
from p2pfl_tpu_torch.parallel.mesh import Mesh, axis_size
from test_torch_kernels import _carry_close, _emulated_chunk_update

B, S, H, D = 2, 64, 2, 16


def _qkvg(seed, s=S):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, s, H, D)).astype(np.float32) for _ in range(4))


def _t(a, grad=False):
    return torch.tensor(a, dtype=torch.float32, requires_grad=grad)


def _port_carry_of(jax_carry):
    """JAX kernel-layout carry (m/l lane-broadcast [B,H,Sq,128], acc [B,H,Sq,D])
    -> the port's (m/l [B,H,Sq], acc [B,Sq,H,D]), as numpy."""
    m, l, acc = (np.asarray(x) for x in jax_carry)
    return m[..., 0], l[..., 0], np.swapaxes(acc, 1, 2)


def _ring_fold_order(causal):
    """Shard 2 of 4 (32 positions each): its chunks in ring order, self
    first; under causal the future chunk 3 among them (skipped by the JAX
    kernel block by block, a no-op for the port)."""
    return [2, 0, 3, 1] if causal else [2, 3, 0, 1]


def _jax_carry0(s):
    m0 = jnp.full((B, H, s, 128), -jnp.inf, jnp.float32)
    return m0, jnp.zeros((B, H, s, 128), jnp.float32), jnp.zeros((B, H, s, D), jnp.float32)


def _to_bhsd(a):
    return jnp.moveaxis(jnp.asarray(a), 2, 1)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_chunk_update_matches_jax_flash_chunk_update(causal):
    """Shard 2 of 4 (32 positions each) folds its chunks in ring order: self
    (diagonal), then under causal the past chunks 0 and 1 and the future
    chunk 3, which the JAX kernel skips block by block and which must leave
    the port's carry bit-unchanged; without causal, chunks 3, 0, 1."""
    q, k, v, _ = _qkvg(0, 128)
    s, i = 32, 2
    qc = q[:, i * s:(i + 1) * s]
    carry_p = port.init_carry(qc.shape, "cpu")
    carry_j = _jax_carry0(s)
    for j in _ring_fold_order(causal):
        kc, vc = k[:, j * s:(j + 1) * s], v[:, j * s:(j + 1) * s]
        carry_j = jax_flash_chunk_update(
            carry_j, _to_bhsd(qc), _to_bhsd(kc), _to_bhsd(vc), i * s, j * s,
            causal=causal, block_q=16, block_k=16,
        )
        before = tuple(t.clone() for t in carry_p)
        carry_p = port.flash_chunk_update(carry_p, _t(qc), _t(kc), _t(vc), i * s, j * s, causal, 16, 16)
        for got, ref in zip(carry_p, _port_carry_of(carry_j)):
            np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, err_msg=f"chunk {j}")
        if causal and j > i:
            for a, b in zip(carry_p, before):
                assert torch.equal(a, b), "a future chunk changed the carry"
    out = port.finalize_carry(carry_p, torch.float32)
    ref = jax_dense_attention(*map(jnp.asarray, (q, k, v)), causal=causal)[:, i * s:(i + 1) * s]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_split_chunk_update_holds_the_carry_bar_against_jax_flash_chunk_update(causal):
    """The bf16 carry kernel's arithmetic (P split into two bf16 halves,
    emulated on the CPU) over the same fold sequence, on bf16-valued inputs,
    against JAX ``flash_chunk_update`` (interpret mode) after every fold,
    within the carry bar. The split's mass accumulates over the folds: it is
    the acc of the same plain fold sequence run on |V|."""
    q, k, v, _ = (torch.tensor(a).bfloat16().float().numpy() for a in _qkvg(0, 128))
    s, i = 32, 2
    qc = q[:, i * s:(i + 1) * s]
    carry_e = mass_carry = port.init_carry(qc.shape, "cpu")
    carry_j = _jax_carry0(s)
    for j in _ring_fold_order(causal):
        kc, vc = k[:, j * s:(j + 1) * s], v[:, j * s:(j + 1) * s]
        carry_j = jax_flash_chunk_update(
            carry_j, _to_bhsd(qc), _to_bhsd(kc), _to_bhsd(vc), i * s, j * s,
            causal=causal, block_q=16, block_k=16,
        )
        carry_e = _emulated_chunk_update(carry_e, _t(qc), _t(kc), _t(vc), i * s, j * s, causal, split=True)
        mass_carry = port.flash_chunk_update(mass_carry, _t(qc), _t(kc), _t(np.abs(vc)), i * s, j * s, causal)
        _carry_close(carry_e, tuple(map(torch.tensor, _port_carry_of(carry_j))), mass_carry[2])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,block_k,q_offset,kv_offset", [(64, 16, 0, 0), (48, 32, 48, 0), (48, 32, 40, 24)])
def test_blockwise_attention_matches_jax(causal, s, block_k, q_offset, kv_offset):
    """Forward 1e-5 and gradients 1e-4, with a ragged tail block (48 / 32)
    and global offsets."""
    q, k, v, _ = _qkvg(1, s)

    def loss_j(q, k, v):
        return jnp.sum(jax_blockwise_attention(q, k, v, causal, block_k, q_offset, kv_offset) ** 2)

    qj, kj, vj = map(jnp.asarray, (q, k, v))
    out_j = jax_blockwise_attention(qj, kj, vj, causal, block_k, q_offset, kv_offset)
    g_j = jax.grad(loss_j, argnums=(0, 1, 2))(qj, kj, vj)
    qt, kt, vt = _t(q, True), _t(k, True), _t(v, True)
    out = port.blockwise_attention(qt, kt, vt, causal, block_k, q_offset, kv_offset)
    (out**2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=1e-5)
    for a, b in zip((qt.grad, kt.grad, vt.grad), g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_remat_flash_attention_matches_jax(causal):
    """``bwd_kernel="remat"`` on both sides (JAX: Pallas forward in interpret
    mode, gradient through its blockwise scan), and against the port's
    kernel backward (tests/test_attention.py:144's check)."""
    q, k, v, _ = _qkvg(2, 48)

    def loss_j(q, k, v):
        return jnp.sum(jax_flash_attention(q, k, v, causal, 16, 16, None, "remat") ** 2)

    qj, kj, vj = map(jnp.asarray, (q, k, v))
    out_j = jax_flash_attention(qj, kj, vj, causal, 16, 16, None, "remat")
    g_j = jax.grad(loss_j, argnums=(0, 1, 2))(qj, kj, vj)
    grads = {}
    for kind in ("remat", "pallas"):
        qt, kt, vt = _t(q, True), _t(k, True), _t(v, True)
        out = port.flash_attention(qt, kt, vt, causal, 16, 16, bwd_kernel=kind)
        (out**2).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=1e-5)
        grads[kind] = (qt.grad, kt.grad, vt.grad)
    for a, b, c in zip(grads["remat"], g_j, grads["pallas"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
        np.testing.assert_allclose(a.numpy(), c.numpy(), atol=1e-4)
    with pytest.raises(ValueError, match="bwd_kernel"):
        port.flash_attention(_t(q), _t(k), _t(v), causal, bwd_kernel="dense")


def _jax_ring(n, causal, impl):
    mesh = JaxMesh(np.array(jax.devices()[:n]), ("seq",))
    spec = P(None, "seq", None, None)
    return jax.jit(shard_map(
        lambda q, k, v: jax_ring_attention(q, k, v, "seq", causal=causal, block_k=8, impl=impl),
        mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec, check_vma=False,
    ))


def _port_ring(n, causal, impl):
    mesh = Mesh({"seq": n}, device="cpu")

    def ring(q, k, v):
        with mesh.bind():
            return ring_attention(q, k, v, "seq", causal=causal, block_k=8, impl=impl)

    return ring


@pytest.mark.parametrize("impl,tol", [("blockwise", 1e-5), ("flash", 2e-3)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n", [4, 8])
def test_ring_attention_matches_jax(impl, tol, causal, n):
    q, k, v, _ = _qkvg(3)
    ref = _jax_ring(n, causal, impl)(*map(jnp.asarray, (q, k, v)))
    out = _port_ring(n, causal, impl)(_t(q), _t(k), _t(v))
    assert out.shape == (B, S, H, D)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=tol)


@pytest.mark.parametrize("impl,tol", [("blockwise", 1e-4), ("flash", 2e-3)])
def test_ring_attention_grads_match_jax(impl, tol):
    q, k, v, _ = _qkvg(4)
    ring_j = _jax_ring(4, True, impl)
    g_j = jax.grad(lambda *a: jnp.sum(ring_j(*a) ** 2), (0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt = _t(q, True), _t(k, True), _t(v, True)
    (_port_ring(4, True, impl)(qt, kt, vt) ** 2).sum().backward()
    for a, b in zip((qt.grad, kt.grad, vt.grad), g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("q_offset,kv_offset", [(0, 0), (32, 0), (16, 40)])
def test_dense_attention_offsets_match_jax(causal, q_offset, kv_offset):
    q, k, v, _ = _qkvg(5, 32)
    ref = jax_dense_attention(*map(jnp.asarray, (q, k, v)), causal, q_offset, kv_offset)
    out = port.dense_attention(_t(q), _t(k), _t(v), causal, q_offset, kv_offset)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_axis_name_is_validated():
    with pytest.raises(ValueError, match="requires attention_kind='ring' or 'ring_flash'"):
        SelfAttention(32, 2, "flash", axis_name="seq")
    for kind in ("ring", "ring_flash"):
        with pytest.raises(ValueError, match="requires axis_name"):
            SelfAttention(32, 2, kind)
    q, k, v, _ = _qkvg(6)
    with pytest.raises(NameError, match="unbound axis name"):
        ring_attention(_t(q), _t(k), _t(v), "seq")
    mesh = Mesh({"seq": 4, "data": 2}, device="cpu")
    with mesh.bind():
        assert axis_size("seq") == 4 and axis_size("data") == 2
        with pytest.raises(NameError, match="unbound axis name"):
            ring_attention(_t(q), _t(k), _t(v), "model")
        with pytest.raises(ValueError, match="impl"):
            ring_attention(_t(q), _t(k), _t(v), "seq", impl="dense")
    with Mesh({"seq": 3}, device="cpu").bind(), pytest.raises(ValueError, match="divisible"):
        ring_attention(_t(q), _t(k), _t(v), "seq")
    with pytest.raises(NameError):
        axis_size("seq")  # the binding ended with its block
    for bad in ({}, {"seq": 0}, {"": 2}):
        with pytest.raises(ValueError):
            Mesh(bad, device="cpu")
