"""The Hopper flash-attention kernels (the carry fold of ring attention
among them), their wrappers and device routing.

This file imports no JAX, so its ``cuda``-marked tests run on a machine
with a card and no JAX (see README, "PyTorch/CUDA port"):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py

Elsewhere those tests skip with a reason; the rest run on the CPU.
"""

import numpy as np
import pytest
import torch

from p2pfl_tpu_torch.device import resolve_device
from p2pfl_tpu_torch.ops import _kernels
from p2pfl_tpu_torch.ops import attention as port
from p2pfl_tpu_torch.ops.ring_attention import ring_attention
from p2pfl_tpu_torch.parallel.mesh import Mesh


def _qkv(seed, shape=(2, 64, 2, 16), dtype=torch.float32, device="cpu", grad=False):
    gen = torch.Generator().manual_seed(seed)
    return tuple(
        torch.randn(shape, generator=gen).to(device, dtype).requires_grad_(grad) for _ in range(4)
    )


def test_cpu_tensors_take_plain_versions_and_launch_nothing():
    q, k, v, _ = _qkv(5, grad=True)
    before = dict(_kernels.LAUNCHES)
    port.flash_attention(q, k, v).sum().backward()
    with torch.no_grad():
        port.flash_attention(q, k, v)
    assert _kernels.LAUNCHES == before


def test_kernel_wrappers_refuse_cpu_tensors():
    q, k, v, g = _qkv(6)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.flash_fwd(q, k, v, True, True)
    lse = torch.zeros(2, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.flash_bwd_dq(q, k, v, g, lse, lse, True)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.flash_bwd_dkv(q, k, v, g, lse, lse, True)


def test_ring_flash_on_cpu_tensors_launches_nothing():
    q, k, v, _ = _qkv(8, grad=True)
    before = dict(_kernels.LAUNCHES)
    with Mesh({"seq": 4}, device="cpu").bind():
        ring_attention(q, k, v, "seq", impl="flash").sum().backward()
    assert _kernels.LAUNCHES == before


def test_carry_wrapper_refuses_cpu_tensors_and_other_head_sizes():
    for d in (257, 512):  # above the largest instance (256)
        q, k, v, _ = _qkv(9, (1, 64, 2, d))
        carry = port.init_carry(q.shape, "cpu")
        with pytest.raises(ValueError, match="head_dim"):
            _kernels.flash_carry(carry, q, k, v, 0, 0, True)
    for d in (8, 16, 32, 48, 64, 100, 128, 160, 256):  # the head sizes the kernels take (padded); still card only
        q, k, v, _ = _qkv(9, (1, 64, 2, d))
        with pytest.raises(ValueError, match="CUDA"):
            _kernels.flash_carry(port.init_carry(q.shape, "cpu"), q, k, v, 0, 0, True)


def test_flash_attention_rejects_bad_block_sizes():
    q, k, v, _ = _qkv(7)
    with pytest.raises(ValueError, match="block"):
        port.flash_attention(q, k, v, True, 0, 16)


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_library_path_follows_the_source(tmp_path, monkeypatch):
    path = _kernels.library_path()
    assert path.parent == _kernels.BUILD_DIR and path.suffix == ".so"
    assert [src.name for src in _kernels.SOURCES] == ["flash_attn.cu", "flash_fwd_sm90.cu", "flash_bwd_sm90.cu"]
    assert [hdr.name for hdr in _kernels.HEADERS] == ["sm90_common.cuh"]
    assert all(src.is_file() for src in (*_kernels.SOURCES, *_kernels.HEADERS))
    for src in _kernels.SOURCES[1:]:  # the tensor-core sources include the header
        assert '#include "sm90_common.cuh"' in src.read_text()
    assert "arch=compute_90a,code=sm_90a" in _kernels.NVCC_FLAGS
    # The library's name follows the content of every source and header.
    copies = {}
    for group in ("SOURCES", "HEADERS"):
        copies[group] = tuple(tmp_path / src.name for src in getattr(_kernels, group))
        for src, copy in zip(getattr(_kernels, group), copies[group]):
            copy.write_bytes(src.read_bytes())
        monkeypatch.setattr(_kernels, group, copies[group])
    assert _kernels.library_path() == path
    for copy in (*copies["SOURCES"], *copies["HEADERS"]):
        copy.write_bytes(copy.read_bytes() + b"// edited\n")
        edited = _kernels.library_path()
        assert edited != path
        path = edited


# --- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100, see README 'PyTorch/CUDA port')")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "s,causal,dtype",
    [
        (1024, True, torch.bfloat16),
        (1000, True, torch.bfloat16),
        (1024, False, torch.bfloat16),
        (1, True, torch.bfloat16),
        (129, True, torch.bfloat16),
        (200, True, torch.float32),
    ],
)
def test_kernels_match_plain_versions_on_card(cuda_device, s, causal, dtype):
    q, k, v, g = _qkv(0, (8, s, 8, 64), dtype, cuda_device)
    # The kernels and the plain versions compute in f32 and differ only in
    # the order of their sums, so a bf16 output may differ by the one ulp
    # that rounding two nearly equal f32 values can put between them. The
    # bf16 kernels also split the f32 operand of their second product into
    # two bf16 halves for the tensor cores (P in the forward; dS, dS^T and
    # P^T in the backward): their bar adds 2^-15 of each output element's
    # weighted mass (_within_split_bar).
    if dtype == torch.bfloat16:
        mass = port.plain_flash_row_mass(q, k, v, causal)
        close = lambda a, b: _within_split_bar(a, b, mass)  # noqa: E731
        close_grad = _within_split_bar
    else:
        close = lambda a, b: torch.testing.assert_close(a, b, atol=1e-5, rtol=0)  # noqa: E731
        close_grad = lambda a, b, _: torch.testing.assert_close(a, b, atol=1e-4, rtol=0)  # noqa: E731
    out, lse = _kernels.flash_fwd(q, k, v, causal, True)
    out_p, lse_p = port.plain_flash_forward(q, k, v, causal)
    close(out, out_p)
    torch.testing.assert_close(lse, lse_p, atol=1e-5, rtol=0)
    out_n, none = _kernels.flash_fwd(q, k, v, causal, False)
    assert none is None
    torch.testing.assert_close(out_n, out, atol=0, rtol=0)
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = _kernels.flash_bwd_dq(q, k, v, g, lse, delta, causal)
    dk, dv = _kernels.flash_bwd_dkv(q, k, v, g, lse, delta, causal)
    dq_p = port.plain_flash_backward_dq(q, k, v, g, lse, delta, causal)
    dk_p, dv_p = port.plain_flash_backward_dkv(q, k, v, g, lse, delta, causal)
    masses = port.plain_flash_grad_mass(q, k, v, g, lse, delta, causal)
    for a, b, m in zip((dq, dk, dv), (dq_p, dk_p, dv_p), masses):
        assert torch.isfinite(a.float()).all()
        close_grad(a, b, m)


def _bf16_ulp(ref):
    _, exp = torch.frexp(ref)  # ref = m * 2**exp with 0.5 <= |m| < 1
    return torch.where(ref == 0, torch.zeros_like(ref), torch.ldexp(torch.ones_like(ref), exp - 8))


def _within_one_bf16_ulp(got, ref):
    """Every element of ``got`` within one bf16 ulp of ``ref`` (plus 1e-6,
    for values so near zero that the f32 sums' own rounding shows)."""
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    bad = diff > 1e-6 + _bf16_ulp(ref)
    assert not bad.any(), f"{int(bad.sum())} elements over one bf16 ulp, max diff {float(diff.max()):.3e}"


def _within_split_bar(got, ref, mass):
    """The bf16 tensor-core kernels' bar: |got - ref| <= 1e-6 + 1 bf16
    ulp(ref) + 2^-15 * mass, with the weighted mass from the plain side:
    ``(P / l) @ |V|`` for the forward's output, ``plain_flash_grad_mass``
    for the gradients. The kernels' X_hi + X_lo is within 2^-17 X of the f32
    operand X, so 2^-15 leaves 4x room for f32 sum-order noise; a single
    bf16 X (2^-9 X) does not fit."""
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    bad = diff > 1e-6 + _bf16_ulp(ref) + 2.0**-15 * mass
    assert not bad.any(), f"{int(bad.sum())} elements over the split bar, max diff {float(diff.max()):.3e}"


def _bf16_parts(x, split):
    """``x`` (f32) as the tensor cores take it: two bf16 halves ``x_hi`` and
    ``bf16(x - x_hi)`` (the kernels' choice), or one bf16 ``x``; as f32."""
    hi = x.to(torch.bfloat16).float()
    return [hi, (x - hi).to(torch.bfloat16).float()] if split else [hi]


def _emulated_forward(q, k, v, causal, split):
    """The bf16 forward's arithmetic on the CPU: f32 scores and softmax as
    the plain version computes them, then P . V with P either split into
    two bf16 halves (``P_hi . V + P_lo . V``, the kernel's choice) or
    rounded once to bf16, both products exact and summed in f32."""
    s = port._scores(q, k, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    pv = sum(torch.einsum("bhqk,bkhd->bqhd", part, v.float()) for part in _bf16_parts(p, split))
    return (pv / l.squeeze(-1).transpose(1, 2)[..., None]).to(q.dtype)


@pytest.mark.parametrize("shape,causal", [((2, 64, 2, 64), True), ((2, 129, 2, 64), True),
                                          ((2, 100, 2, 64), False)])
def test_split_p_bar_holds_the_split_at_small_shapes(shape, causal):
    q, k, v, _ = _qkv(11, shape, torch.bfloat16)
    out_p, _ = port.plain_flash_forward(q, k, v, causal)
    mass = port.plain_flash_row_mass(q, k, v, causal)
    assert mass.shape == q.shape and bool((mass > 0).all())
    _within_split_bar(_emulated_forward(q, k, v, causal, split=True), out_p, mass)


def _cancelling_case():
    """One query, two keys: scores 0.405 and 0, so p is ~0.6 / 0.4 (neither
    a bf16 value; unnormalized 1 and ~0.667), and values 1 and -1.5 nearly
    cancel in column 0."""
    q = torch.zeros(1, 1, 1, 64)
    k = torch.zeros(1, 2, 1, 64)
    v = torch.zeros(1, 2, 1, 64)
    q[0, 0, 0, 0], k[0, 0, 0, 0] = 1.0, 8 * 0.405
    v[0, :, 0, 0] = torch.tensor([1.0, -1.5])
    v[0, :, 0, 1] = torch.tensor([0.25, 0.5])
    return tuple(t.to(torch.bfloat16) for t in (q, k, v))


def test_split_p_bar_refuses_a_single_bf16_p_where_values_cancel():
    # Column 0 nearly cancels (out ~7e-4, bar ~4e-5). One bf16 P is off by
    # ~5e-4 there; the split is not.
    q, k, v = _cancelling_case()
    out_p, _ = port.plain_flash_forward(q, k, v, False)
    mass = port.plain_flash_row_mass(q, k, v, False)
    assert 0 < abs(float(out_p[0, 0, 0, 0])) < 1e-2  # the cancelling column
    _within_split_bar(_emulated_forward(q, k, v, False, split=True), out_p, mass)
    with pytest.raises(AssertionError, match="over the split bar"):
        _within_split_bar(_emulated_forward(q, k, v, False, split=False), out_p, mass)


def _emulated_backward(q, k, v, do, lse, delta, causal, split):
    """The bf16 backward's arithmetic on the CPU: f32 P and dS as the plain
    versions compute them, then dq = scale dS . K, dk = scale dS^T . Q and
    dv = P^T . dO with dS and P either split into two bf16 halves (the
    kernels' choice) or rounded once to bf16, the products exact and summed
    in f32."""
    p, ds = port._probs_and_dscores(q, k, v, do, lse, delta, causal)
    scale = 1.0 / q.shape[-1] ** 0.5

    dq = scale * sum(torch.einsum("bhqk,bkhd->bqhd", t, k.float()) for t in _bf16_parts(ds, split))
    dk = scale * sum(torch.einsum("bhqk,bqhd->bkhd", t, q.float()) for t in _bf16_parts(ds, split))
    dv = sum(torch.einsum("bhqk,bqhd->bkhd", t, do.float()) for t in _bf16_parts(p, split))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@pytest.mark.parametrize("shape,causal", [((2, 64, 2, 64), True), ((2, 129, 2, 64), True),
                                          ((2, 100, 2, 64), False)])
def test_split_grad_bar_holds_the_split_at_small_shapes(shape, causal):
    q, k, v, g = _qkv(12, shape, torch.bfloat16)
    out, lse = port.plain_flash_forward(q, k, v, causal)
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    refs = (port.plain_flash_backward_dq(q, k, v, g, lse, delta, causal),
            *port.plain_flash_backward_dkv(q, k, v, g, lse, delta, causal))
    masses = port.plain_flash_grad_mass(q, k, v, g, lse, delta, causal)
    for mass, like in zip(masses, (q, k, v)):
        assert mass.shape == like.shape and mass.dtype == torch.float32 and bool((mass >= 0).all())
    for got, ref, mass in zip(_emulated_backward(q, k, v, g, lse, delta, causal, split=True), refs, masses):
        _within_split_bar(got, ref, mass)


@pytest.mark.parametrize("shape,causal", [((2, 64, 2, 64), True), ((2, 129, 2, 64), True),
                                          ((2, 100, 2, 64), False)])
def test_split_grad_bar_refuses_a_single_bf16_operand_at_small_shapes(shape, causal):
    # The same inputs as above: rounding dS and P once to bf16 puts
    # thousands of elements of each gradient past the bar (25-50x of it).
    q, k, v, g = _qkv(12, shape, torch.bfloat16)
    out, lse = port.plain_flash_forward(q, k, v, causal)
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    refs = (port.plain_flash_backward_dq(q, k, v, g, lse, delta, causal),
            *port.plain_flash_backward_dkv(q, k, v, g, lse, delta, causal))
    masses = port.plain_flash_grad_mass(q, k, v, g, lse, delta, causal)
    for got, ref, mass in zip(_emulated_backward(q, k, v, g, lse, delta, causal, split=False), refs, masses):
        with pytest.raises(AssertionError, match="over the split bar"):
            _within_split_bar(got, ref, mass)


def _cancelling_backward_case():
    """Two queries, two keys, non-causal, delta = 0 (the bar holds for any
    delta). Query 0 scores the keys 0.404 and 0 (P ~0.600 / 0.400, neither
    a bf16 value), query 1 scores both 0 (P = 0.5). Chosen columns of K, Q
    and dO make one element of each gradient a near-cancelling difference:
    dq[0, 2] = scale (dS00 - dS01), dk[0, 5] = scale (dS00 - 1.59375 dS10)
    and dv[0, 1] = P00 - 1.25 P10."""
    q, k, v, do = (torch.zeros(1, 2, 1, 64) for _ in range(4))
    q[0, 0, 0, 0], k[0, 0, 0, 0] = 1.0, 8 * 0.405
    v[0, :, 0, 3] = torch.tensor([1.0, 1.5])  # dP[q, k] = dO[q, 3] v[k, 3]
    do[0, :, 0, 3] = torch.tensor([1.0, 0.75])
    k[0, :, 0, 2] = torch.tensor([1.0, -1.0])
    q[0, :, 0, 5] = torch.tensor([1.0, -1.59375])
    do[0, :, 0, 1] = torch.tensor([1.0, -1.25])
    q, k, v, do = (t.to(torch.bfloat16) for t in (q, k, v, do))
    _, lse = port.plain_flash_forward(q, k, v, False)
    return q, k, v, do, lse, torch.zeros(1, 1, 2)


@pytest.mark.parametrize("which", [0, 1, 2], ids=["dq", "dk", "dv"])
def test_split_grad_bar_refuses_a_single_bf16_operand_where_values_cancel(which):
    q, k, v, do, lse, delta = _cancelling_backward_case()
    ref = (port.plain_flash_backward_dq(q, k, v, do, lse, delta, False),
           *port.plain_flash_backward_dkv(q, k, v, do, lse, delta, False))[which]
    mass = port.plain_flash_grad_mass(q, k, v, do, lse, delta, False)[which]
    at = (0, 0, 0, (2, 5, 1)[which])  # the near-cancelling element
    assert 0 < abs(float(ref[at])) < 0.05 * float(mass[at])
    _within_split_bar(_emulated_backward(q, k, v, do, lse, delta, False, split=True)[which], ref, mass)
    with pytest.raises(AssertionError, match="over the split bar"):
        _within_split_bar(_emulated_backward(q, k, v, do, lse, delta, False, split=False)[which], ref, mass)


def test_one_bf16_ulp_check_holds_one_ulp_and_refuses_two():
    # Runs on the CPU: it checks the tolerance the card's tests use.
    ref = torch.tensor([0.3, -1.5, 2.0**-20, 7.0, 0.05]).to(torch.bfloat16)
    bits = ref.view(torch.int16)
    _within_one_bf16_ulp(ref, ref)
    _within_one_bf16_ulp((bits + 1).view(torch.bfloat16), ref)  # each value's bf16 neighbour
    _within_one_bf16_ulp((bits - 1).view(torch.bfloat16), ref)
    for i in (0, 1, 3, 4):  # two ulps off fails wherever it is more than 1e-6
        two = ref.clone()
        two[i] = (bits[i] + 2).view(torch.bfloat16)
        with pytest.raises(AssertionError, match="over one bf16 ulp"):
            _within_one_bf16_ulp(two, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64])
def test_kernel_autograd_matches_dense_on_card(cuda_device, d):
    """f32, small: flash_attention through the kernels (forward with lse,
    dq, dk/dv) against autograd through dense attention, at the JAX
    package's f32 tolerances (forward 1e-5, gradients 1e-4)."""
    q, k, v, _ = _qkv(1, (2, 96, 2, d), torch.float32, cuda_device, grad=True)
    _kernels.reset_launches()
    out = port.flash_attention(q, k, v)
    grads = torch.autograd.grad((out**2).sum(), (q, k, v))
    assert _kernels.LAUNCHES == {"flash_fwd": 1, "flash_fwd_no_lse": 0, "flash_bwd_dq": 1, "flash_bwd_dkv": 1,
                                 "flash_carry": 0}
    ref = port.dense_attention(q, k, v)
    ref_grads = torch.autograd.grad((ref**2).sum(), (q, k, v))
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    for a, b in zip(grads, ref_grads):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
    with torch.no_grad():
        port.flash_attention(q, k, v)
    assert _kernels.LAUNCHES["flash_fwd_no_lse"] == 1


@pytest.mark.cuda
def test_kernel_autograd_matches_dense_on_card_bf16(cuda_device):
    """bf16 [2, 256, 2, 64] causal: flash_attention through the tensor-core
    forward and backward pair against autograd through dense attention in
    f32 on the same (bf16-valued) inputs, at the bf16 tolerance of 5e-2."""
    q, k, v, _ = _qkv(1, (2, 256, 2, 64), torch.bfloat16, cuda_device, grad=True)
    _kernels.reset_launches()
    out = port.flash_attention(q, k, v)
    grads = torch.autograd.grad((out.float() ** 2).sum(), (q, k, v))
    assert _kernels.LAUNCHES == {"flash_fwd": 1, "flash_fwd_no_lse": 0, "flash_bwd_dq": 1, "flash_bwd_dkv": 1,
                                 "flash_carry": 0}
    qf, kf, vf = (t.detach().float().requires_grad_(True) for t in (q, k, v))
    ref = port.dense_attention(qf, kf, vf)
    ref_grads = torch.autograd.grad((ref**2).sum(), (qf, kf, vf))
    torch.testing.assert_close(out.float(), ref, atol=5e-2, rtol=0)
    for a, b in zip(grads, ref_grads):
        assert a.dtype == torch.bfloat16 and torch.isfinite(a.float()).all()
        torch.testing.assert_close(a.float(), b, atol=5e-2, rtol=0)


@pytest.mark.cuda
def test_kernel_wrappers_reject_what_the_kernel_does_not_take(cuda_device):
    q, k, v, _ = _qkv(2, (1, 64, 2, 257), torch.float32, cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        _kernels.flash_fwd(q, k, v, True, True)
    q, k, v, _ = _qkv(2, (1, 64, 2, 64), torch.float16, cuda_device)
    with pytest.raises(ValueError, match="dtype"):
        _kernels.flash_fwd(q, k, v, True, True)
    q, k, v, _ = _qkv(2, (1, 64, 2, 64), torch.float32, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        _kernels.flash_fwd(q.transpose(1, 2), k, v, True, True)
    assert np.isfinite(_kernels.flash_fwd(q, k, v, True, True)[0].cpu().numpy()).all()
    # bf16 goes to the tensor-core kernels, whose TMA loads need 16-byte
    # alignment: a dO that starts one element into its buffer is refused.
    q, k, v, g = _qkv(2, (1, 64, 2, 64), torch.bfloat16, cuda_device)
    out, lse = _kernels.flash_fwd(q, k, v, True, True)
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    shifted = torch.empty(g.numel() + 1, dtype=torch.bfloat16, device=cuda_device)[1:].view(g.shape)
    shifted.copy_(g)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        _kernels.flash_bwd_dq(q, k, v, shifted, lse, delta, True)
    with pytest.raises(ValueError, match="aligned"):
        _kernels.flash_bwd_dkv(q, k, v, shifted, lse, delta, True)
    with pytest.raises(ValueError, match="aligned"):  # the carry fold's bf16 kernel loads q by TMA too
        _kernels.flash_carry(port.init_carry(q.shape, cuda_device), shifted, k, v, 0, 0, True)


def _carry_close(got, ref, mass=None):
    """The carry kernel against its plain version. f32 (``mass`` None): m to
    1e-6 (both take the max of the same f32 scores); l to 1e-5 + 1e-5 |ref|;
    acc to 1e-5 + 1e-5 |ref| + 1e-6 l. Both are f32 sums of ~1000 weighted
    terms, folded one key tile at a time by the kernel and in one step by
    the plain version; an acc element near 0 is the sum of terms of size up
    to ~l, so its rounding scales with l (1e-6 l is 1e-6 in the normalized
    output). bf16: m to 1e-5 (wgmma sums the scores in its own order, as
    the forward's lse is held), and acc gets 2^-15 of the fold's ``mass``
    (``plain_flash_chunk_mass``, exp(S - m_new) @ |V|) beyond that, since
    the kernel multiplies P split into two bf16 halves (within 2^-17 P)."""
    m, l, acc = got
    m_r, l_r, acc_r = ref
    torch.testing.assert_close(m, m_r, atol=1e-6 if mass is None else 1e-5, rtol=0)
    torch.testing.assert_close(l, l_r, atol=1e-5, rtol=1e-5)
    tol = 1e-5 + 1e-5 * acc_r.abs() + 1e-6 * l_r.transpose(1, 2)[..., None]
    if mass is not None:
        tol = tol + 2.0**-15 * mass
    diff = (acc - acc_r).abs()
    assert bool((diff <= tol).all()), (
        f"acc: {int((diff > tol).sum())} elements over the carry bar, max diff {float(diff.max()):.3e}")


def _emulated_chunk_update(carry, q, k, v, q_offset, kv_offset, causal, split):
    """The bf16 carry kernel's arithmetic on the CPU: f32 scores, m, l and P
    as the plain version computes them, then P . V with P either split into
    two bf16 halves (the kernel's choice) or rounded once to bf16, the
    products exact and summed in f32, added to the rescaled incoming acc."""
    m, l, acc = carry
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * (1.0 / q.shape[-1] ** 0.5), k.float())
    if causal:
        s = port._causal_mask(s, q_offset, kv_offset)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    pv = sum(torch.einsum("bhqk,bkhd->bqhd", part, v.float()) for part in _bf16_parts(p, split))
    return m_new, corr * l + p.sum(dim=-1), corr.transpose(1, 2)[..., None] * acc + pv


@pytest.mark.parametrize("causal", [True, False])
def test_chunk_mass_is_the_row_mass_times_l_on_a_fresh_carry(causal):
    q, k, v, _ = _qkv(13, (2, 100, 2, 64), torch.bfloat16)
    fresh = port.init_carry(q.shape, "cpu")
    mass = port.plain_flash_chunk_mass(fresh, q, k, v, 0, 0, causal)
    assert mass.shape == q.shape and mass.dtype == torch.float32 and bool((mass >= 0).all())
    _, l, _ = port.plain_flash_chunk_update(fresh, q, k, v, 0, 0, causal)
    row_mass = port.plain_flash_row_mass(q, k, v, causal) * l.transpose(1, 2)[..., None]
    torch.testing.assert_close(mass, row_mass, atol=1e-6, rtol=1e-5)


_CARRY_FOLD_LENGTHS = {"diagonal": 64, "past": 64, "ragged non-causal": 100, "diagonal S=129": 129}


def _carry_fold_case(fold):
    """(carry, q, k, v, q_offset, kv_offset, causal) of one of the ring's
    folds at a small shape: shard 3's diagonal chunk into a fresh carry (of
    64 or 129 positions), a past chunk into that carry, and a ragged
    non-causal chunk."""
    shape = (2, _CARRY_FOLD_LENGTHS[fold], 2, 64)
    q, k, v, kp = _qkv(14, shape, torch.bfloat16)
    vp = _qkv(15, shape, torch.bfloat16)[0]
    off = 3 * shape[1]
    fresh = port.init_carry(q.shape, "cpu")
    if fold == "past":
        return port.plain_flash_chunk_update(fresh, q, k, v, off, off, True), q, kp, vp, off, 0, True
    if fold == "ragged non-causal":
        return fresh, q, k, v, 0, 0, False
    return fresh, q, k, v, off, off, True


@pytest.mark.parametrize("fold", list(_CARRY_FOLD_LENGTHS))
def test_split_carry_bar_holds_the_split_at_small_shapes(fold):
    case = _carry_fold_case(fold)
    mass = port.plain_flash_chunk_mass(*case)
    assert mass.shape == case[1].shape and bool((mass >= 0).all())
    _carry_close(_emulated_chunk_update(*case, split=True), port.plain_flash_chunk_update(*case), mass)


def test_split_carry_bar_refuses_a_single_bf16_p_where_values_cancel():
    # The forward's cancelling case folded into a fresh carry: unnormalized,
    # column 0 of acc is 1 - 1.5 * 0.667 ~ -1e-3 against a bar of ~7e-5;
    # one bf16 P is off by ~8e-4 there, the split is not.
    q, k, v = _cancelling_case()
    fresh = port.init_carry(q.shape, "cpu")
    ref = port.plain_flash_chunk_update(fresh, q, k, v, 0, 0, False)
    mass = port.plain_flash_chunk_mass(fresh, q, k, v, 0, 0, False)
    assert 0 < abs(float(ref[2][0, 0, 0, 0])) < 1e-2
    _carry_close(_emulated_chunk_update(fresh, q, k, v, 0, 0, False, split=True), ref, mass)
    with pytest.raises(AssertionError, match="over the carry bar"):
        _carry_close(_emulated_chunk_update(fresh, q, k, v, 0, 0, False, split=False), ref, mass)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_carry_kernel_matches_plain_version_on_card(cuda_device, dtype):
    """The ring's folds of shard 7 of 8 at [2, 1024, 8, 64]: the diagonal
    chunk into a fresh carry, a past chunk into that carry, and a chunk
    wholly in the future, which must leave the carry bit-unchanged; then
    the finalized output within one bf16 ulp of the plain version's (plus,
    for bf16, 2^-15 of the past fold's mass / l: the kernel splits P)."""
    q, k, v, _ = _qkv(3, (2, 1024, 8, 64), dtype, cuda_device)
    kp, vp, _, _ = _qkv(4, (2, 1024, 8, 64), dtype, cuda_device)
    off = 7 * 1024
    bf16 = dtype == torch.bfloat16
    fresh = port.init_carry(q.shape, cuda_device)
    _kernels.reset_launches()
    diag = _kernels.flash_carry(fresh, q, k, v, off, off, True)
    _carry_close(diag, port.plain_flash_chunk_update(fresh, q, k, v, off, off, True),
                 port.plain_flash_chunk_mass(fresh, q, k, v, off, off, True) if bf16 else None)
    past = _kernels.flash_carry(diag, q, kp, vp, off, 0, True)
    past_p = port.plain_flash_chunk_update(diag, q, kp, vp, off, 0, True)
    mass = port.plain_flash_chunk_mass(diag, q, kp, vp, off, 0, True)
    _carry_close(past, past_p, mass if bf16 else None)
    future = _kernels.flash_carry(past, q, kp, vp, off, off + 1024, True)
    for a, b in zip(future, past):
        assert torch.equal(a, b)
    assert _kernels.LAUNCHES["flash_carry"] == 3
    out, out_p = port.finalize_carry(past, torch.bfloat16), port.finalize_carry(past_p, torch.bfloat16)
    if bf16:
        _within_split_bar(out, out_p, mass / past_p[1].transpose(1, 2)[..., None])
    else:
        _within_one_bf16_ulp(out, out_p)


@pytest.mark.cuda
def test_carry_kernel_ragged_non_causal_on_card(cuda_device):
    q, k, v, _ = _qkv(5, (2, 1000, 8, 64), torch.bfloat16, cuda_device)
    fresh = port.init_carry(q.shape, cuda_device)
    _carry_close(_kernels.flash_carry(fresh, q, k, v, 0, 0, False),
                 port.plain_flash_chunk_update(fresh, q, k, v, 0, 0, False),
                 port.plain_flash_chunk_mass(fresh, q, k, v, 0, 0, False))


@pytest.mark.cuda
@pytest.mark.parametrize("s,kv_back", [(1024, 100), (129, 0), (1, 0)], ids=["mid-tile diagonal", "S=129", "S=1"])
def test_carry_kernel_edge_folds_on_card(cuda_device, s, kv_back):
    """bf16 folds at the tensor-core kernel's edges: a chunk whose causal
    diagonal crosses a key tile (kv_offset = q_offset - 100, into a fresh
    carry: every row sees key 0 in its first tile), and chunks of 129 (one
    full q tile and a row) and 1, each the diagonal fold into a fresh carry
    and then a past fold into it."""
    q, k, v, kp = _qkv(7, (2, s, 8, 64), torch.bfloat16, cuda_device)
    vp = _qkv(8, (2, s, 8, 64), torch.bfloat16, cuda_device)[0]
    off = 7 * s
    carry = port.init_carry(q.shape, cuda_device)
    folds = [(k, v, off - kv_back)] + ([(kp, vp, 0)] if kv_back == 0 else [])
    for kc, vc, kv_off in folds:
        got = _kernels.flash_carry(carry, q, kc, vc, off, kv_off, True)
        ref = port.plain_flash_chunk_update(carry, q, kc, vc, off, kv_off, True)
        _carry_close(got, ref, port.plain_flash_chunk_mass(carry, q, kc, vc, off, kv_off, True))
        carry = got


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_ring_flash_autograd_matches_dense_on_card(cuda_device, causal):
    """f32, 4 shards of 64: the ring forward through the carry kernel (one
    launch per folded chunk) and its remat backward against autograd
    through dense attention, at the f32 bars (1e-5, 1e-4)."""
    q, k, v, _ = _qkv(6, (2, 256, 2, 64), torch.float32, cuda_device, grad=True)
    _kernels.reset_launches()
    with Mesh({"seq": 4}, device=cuda_device).bind():
        out = ring_attention(q, k, v, "seq", causal=causal, impl="flash")
    grads = torch.autograd.grad((out**2).sum(), (q, k, v))
    assert _kernels.LAUNCHES["flash_carry"] == (10 if causal else 16)
    ref = port.dense_attention(q, k, v, causal)
    ref_grads = torch.autograd.grad((ref**2).sum(), (q, k, v))
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    for a, b in zip(grads, ref_grads):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_ring_flash_autograd_matches_dense_on_card_bf16(cuda_device):
    """bf16, 4 shards of 256: the ring forward through the tensor-core carry
    kernel (one launch per folded chunk) and its remat backward against
    autograd through dense attention in f32 on the same (bf16-valued)
    inputs, at the bf16 tolerance of 5e-2. The cotangent is random: with
    ``out**2`` the first keys' gradients grow so large that their own bf16
    rounding nears 5e-2, and the bar would hold that rounding rather than
    the kernel; a random cotangent keeps them of order one."""
    q, k, v, g = _qkv(6, (2, 1024, 2, 64), torch.bfloat16, cuda_device, grad=True)
    _kernels.reset_launches()
    with Mesh({"seq": 4}, device=cuda_device).bind():
        out = ring_attention(q, k, v, "seq", causal=True, impl="flash")
    grads = torch.autograd.grad(out, (q, k, v), g.detach())
    assert _kernels.LAUNCHES["flash_carry"] == 10
    qf, kf, vf = (t.detach().float().requires_grad_(True) for t in (q, k, v))
    ref = port.dense_attention(qf, kf, vf)
    ref_grads = torch.autograd.grad(ref, (qf, kf, vf), g.detach().float())
    torch.testing.assert_close(out.float(), ref, atol=5e-2, rtol=0)
    for a, b in zip(grads, ref_grads):
        assert a.dtype == torch.bfloat16 and torch.isfinite(a.float()).all()
        torch.testing.assert_close(a.float(), b, atol=5e-2, rtol=0)


# --- head sizes 16, 32, 48, 128, 160 and 256 ---------------------------------------
# f32 runs instances of the CUDA-core kernels at 16, 32, 128 and 256 (48 is
# zero-padded to 64, 160 to 256); bf16 zero-pads q, k, v, dO (and the carry's
# acc) to 64 for the tensor-core kernels (16, 32, 48) and runs the CUDA-core
# instances at 128 and 256 (160 padded to 256), slicing the outputs back. All
# are held to the D = 64 bars above.


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("s", [1024, 129])
@pytest.mark.parametrize("d", [16, 32, 48, 128, 160, 256])
def test_narrow_head_kernels_match_plain_versions_on_card(cuda_device, d, s, dtype):
    q, k, v, g = _qkv(20 + d, (4, s, 4, d), dtype, cuda_device)
    bf16 = dtype == torch.bfloat16
    _kernels.reset_launches()
    out, lse = _kernels.flash_fwd(q, k, v, True, True)
    assert out.shape == q.shape and out.dtype == dtype and out.is_contiguous()
    out_p, lse_p = port.plain_flash_forward(q, k, v, True)
    if bf16:
        _within_split_bar(out, out_p, port.plain_flash_row_mass(q, k, v, True))
    else:
        torch.testing.assert_close(out, out_p, atol=1e-5, rtol=0)
    torch.testing.assert_close(lse, lse_p, atol=1e-5, rtol=0)
    torch.testing.assert_close(_kernels.flash_fwd(q, k, v, True, False)[0], out, atol=0, rtol=0)
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    got = (_kernels.flash_bwd_dq(q, k, v, g, lse, delta, True), *_kernels.flash_bwd_dkv(q, k, v, g, lse, delta, True))
    ref = (port.plain_flash_backward_dq(q, k, v, g, lse, delta, True),
           *port.plain_flash_backward_dkv(q, k, v, g, lse, delta, True))
    masses = port.plain_flash_grad_mass(q, k, v, g, lse, delta, True)
    for a, b, m in zip(got, ref, masses):
        assert a.shape == q.shape and torch.isfinite(a.float()).all()
        if bf16:
            _within_split_bar(a, b, m)
        else:
            torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
    assert _kernels.LAUNCHES == {"flash_fwd": 1, "flash_fwd_no_lse": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1,
                                 "flash_carry": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("d", [16, 32, 48, 128, 160, 256])
def test_narrow_head_autograd_matches_dense_on_card(cuda_device, d, dtype):
    """flash_attention through the kernels against autograd through dense
    attention in f32: f32 at 1e-5 / 1e-4, bf16 at 5e-2 (a random
    cotangent, as in the ring's bf16 test)."""
    q, k, v, g = _qkv(30 + d, (2, 256, 2, d), dtype, cuda_device, grad=True)
    _kernels.reset_launches()
    out = port.flash_attention(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), g.detach())
    assert _kernels.LAUNCHES["flash_fwd"] == _kernels.LAUNCHES["flash_bwd_dq"] == 1
    qf, kf, vf = (t.detach().float().requires_grad_(True) for t in (q, k, v))
    ref = port.dense_attention(qf, kf, vf)
    ref_grads = torch.autograd.grad(ref, (qf, kf, vf), g.detach().float())
    atol = (5e-2, 5e-2) if dtype == torch.bfloat16 else (1e-5, 1e-4)
    torch.testing.assert_close(out.float(), ref, atol=atol[0], rtol=0)
    for a, b in zip(grads, ref_grads):
        assert a.dtype == dtype and a.shape == q.shape
        torch.testing.assert_close(a.float(), b, atol=atol[1], rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("s", [1024, 129])
@pytest.mark.parametrize("d", [16, 32, 48, 128, 160, 256])
def test_narrow_head_carry_matches_plain_version_on_card(cuda_device, d, s, dtype):
    """The diagonal fold of shard 7 into a fresh carry, a past fold into it
    and a future fold (the carry back bit-identical), at [2, S, 4, D]."""
    q, k, v, kp = _qkv(40 + d, (2, s, 4, d), dtype, cuda_device)
    vp = _qkv(41 + d, (2, s, 4, d), dtype, cuda_device)[0]
    bf16 = dtype == torch.bfloat16
    off = 7 * s
    carry = port.init_carry(q.shape, cuda_device)
    _kernels.reset_launches()
    for kc, vc, kv_off in ((k, v, off), (kp, vp, 0)):
        got = _kernels.flash_carry(carry, q, kc, vc, off, kv_off, True)
        assert got[2].shape == q.shape and got[2].is_contiguous()
        ref = port.plain_flash_chunk_update(carry, q, kc, vc, off, kv_off, True)
        _carry_close(got, ref, port.plain_flash_chunk_mass(carry, q, kc, vc, off, kv_off, True) if bf16 else None)
        carry = got
    future = _kernels.flash_carry(carry, q, kp, vp, off, off + s, True)
    assert all(torch.equal(a, b) for a, b in zip(future, carry))
    assert _kernels.LAUNCHES["flash_carry"] == 3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("d", [257, 512])
def test_other_head_sizes_are_refused_on_card(cuda_device, d, dtype):
    q, k, v, g = _qkv(2, (1, 64, 2, d), dtype, cuda_device)
    rows = torch.zeros(1, 2, 64, device=cuda_device)
    calls = (lambda: _kernels.flash_fwd(q, k, v, True, True),
             lambda: _kernels.flash_bwd_dq(q, k, v, g, rows, rows, True),
             lambda: _kernels.flash_bwd_dkv(q, k, v, g, rows, rows, True),
             lambda: _kernels.flash_carry(port.init_carry(q.shape, cuda_device), q, k, v, 0, 0, True))
    _kernels.reset_launches()
    for call in calls:
        with pytest.raises(ValueError, match="head_dim"):
            call()
    assert not any(_kernels.LAUNCHES.values())


# --- the wire codec's top-k encoders on the card -----------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("values", ["bf16", "float32", "int8", "int4"])
def test_topk_encoders_conserve_error_feedback_on_card(cuda_device, values):
    """The error-feedback encoders on the card: indices ascending, the
    residual absorbing every transmitted value's error element for element
    (``residual.index_add(idx, dequant) == acc`` bit for bit), and the same
    selection, values and residual as on the CPU."""
    from p2pfl_tpu_torch.ops import compression as comp

    gen = torch.Generator().manual_seed(60)
    delta, residual = torch.randn(1 << 20, generator=gen), 0.01 * torch.randn(1 << 20, generator=gen)
    k = comp.topk_count(delta.numel(), 0.1)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        d, r = delta.to(dev), residual.to(dev)
        if values in ("bf16", "float32"):
            idx, wire, res = comp.ef_topk_encode(d, r, k, values)
            deq = wire.float()
        else:
            idx, q, scale, res = comp.ef_topk_quant_encode(d, r, k, 8 if values == "int8" else 4)
            wire, deq = q, q.float() * torch.tensor(scale, dtype=torch.float32, device=dev)
        acc = d + r
        assert idx.device.type == dev.type and bool((idx[1:] > idx[:-1]).all())
        assert torch.equal(res.index_add(0, idx, deq), acc)
        assert torch.equal(res[idx], acc[idx] - deq)
        out[dev.type] = [t.cpu() for t in (idx, wire, res)]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["grid", "zeros"])
@pytest.mark.parametrize("values", ["select", "bf16", "int8", "int4"])
def test_topk_encoders_break_ties_alike_on_card(cuda_device, values, case):
    """Magnitudes tied at the k-th place (a {-2, -1, 1, 2} grid; or 300
    nonzeros among 4096, so zeros cross the k-th place): the card keeps the
    same lowest-index members as the CPU, with the same values, scales and
    residuals."""
    from p2pfl_tpu_torch.ops import compression as comp

    rng = np.random.default_rng(8)
    delta = rng.choice(np.array([-2.0, -1.0, 1.0, 2.0], np.float32), 4096)
    residual = (0.25 * rng.choice(np.array([-1.0, 0.0, 1.0], np.float32), 4096)).astype(np.float32)
    if case == "zeros":
        delta[rng.permutation(4096)[300:]] = 0.0
        residual[:] = 0.0
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        d, r = torch.from_numpy(delta).to(dev), torch.from_numpy(residual).to(dev)
        if values == "select":
            got = comp.topk_select(d + r, 409)
        elif values == "bf16":
            got = comp.ef_topk_encode(d, r, 409, values)
        else:
            idx, q, scale, res = comp.ef_topk_quant_encode(d, r, 409, 8 if values == "int8" else 4)
            got = (idx, q, torch.tensor(scale), res)
        out[dev.type] = [t.cpu() for t in got]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_delta_codec_frames_on_card_decode_alike_on_the_cpu(cuda_device):
    """A coalesced int8 frame encoded by a codec on the card decodes to the
    same leaves on a card codec and a CPU codec holding the same anchor."""
    from p2pfl_tpu_torch.comm.delta import DeltaWireCodec
    from p2pfl_tpu_torch.config import Settings
    from p2pfl_tpu_torch.models.mlp import mlp_model

    model = mlp_model(seed=0, device=cuda_device)
    anchor = model.get_parameters()
    gen = torch.Generator().manual_seed(61)
    model.set_parameters([a + 0.01 * torch.randn(a.shape, generator=gen).to(cuda_device) for a in anchor])
    model.set_contribution(["s"], 1)
    sender = DeltaWireCodec("s", device=cuda_device)
    sender.set_anchor(anchor, 0)
    with Settings.overridden(WIRE_COMPRESSION="topk", WIRE_TOPK_VALUES="int8", COALESCE_ENABLED=True):
        blob, label = sender.encode_tagged(model, 0)
    assert label == "topk-int8"
    decoded = []
    for dev in (cuda_device, torch.device("cpu")):
        rx = DeltaWireCodec("r", device=dev)
        rx.set_anchor([a.to(dev) for a in anchor], 0)
        decoded.append(rx.decode_frame(blob)[0])
    for a, b in zip(*decoded):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b)


def abs32_out_of_range(blob):
    """``blob`` with its first uncoalesced top-k leaf's indices rewritten as
    ``abs32`` in descending order, the middle one past the leaf's end: the
    first and last indices stay in bounds, so only a check of every index
    finds it."""
    from p2pfl_tpu_torch.ops import compression as comp
    from p2pfl_tpu_torch.ops import serialization as ser

    arrays, meta = ser.deserialize_arrays(blob)
    pos = 0
    for s in meta[comp.CODEC_META_KEY]:
        if s.get("codec") == "topk":
            idx = ser.decode_sparse_indices(np.asarray(arrays[pos]), s["index_codec"])[::-1].copy()
            assert idx.size >= 3
            idx[idx.size // 2] = int(np.prod(s["shape"])) + 5
            arrays[pos] = idx.astype(np.uint32)
            s["index_codec"] = "abs32"
            return ser.serialize_arrays(arrays, meta)
        pos += int(s.get("parts", 1))
    raise AssertionError("the frame holds no uncoalesced top-k leaf")


def hostile_abs32_frame(kind, device):
    """(codec holding the frame's anchor, honest frame, hostile frame): a
    sparse delta frame (``kind="delta"``) or a dense top-k frame
    (``"dense"``) from an MLP on ``device``, and its abs32 rewrite."""
    from p2pfl_tpu_torch.comm.delta import DeltaWireCodec
    from p2pfl_tpu_torch.config import Settings
    from p2pfl_tpu_torch.models.mlp import mlp_model
    from p2pfl_tpu_torch.ops import compression as comp
    from p2pfl_tpu_torch.ops import serialization as ser

    model = mlp_model(seed=0, device=device)
    anchor = model.get_parameters()
    gen = torch.Generator().manual_seed(62)
    model.set_parameters([a + 0.01 * torch.randn(a.shape, generator=gen).to(device) for a in anchor])
    model.set_contribution(["s"], 1)
    if kind == "delta":
        sender = DeltaWireCodec("s", device=device)
        sender.set_anchor(anchor, 0)
        with Settings.overridden(WIRE_COMPRESSION="topk", WIRE_TOPK_VALUES="int8", COALESCE_ENABLED=False):
            blob = sender.encode_tagged(model, 0)[0]
    else:  # a frame of compress_arrays' "topk" scheme: decode_frame densifies it
        arrays, spec = comp.compress_arrays(model.get_parameters(), "topk", ratio=0.1)
        blob = ser.serialize_arrays(arrays, {comp.CODEC_META_KEY: spec, "contributors": ["s"], "num_samples": 1})
    rx = DeltaWireCodec("r", device=device)
    rx.set_anchor(anchor, 0)
    return rx, bytes(blob), abs32_out_of_range(bytes(blob))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["delta", "dense"])
def test_unsorted_abs32_index_out_of_range_is_refused_before_the_card(cuda_device, kind):
    """An abs32 frame whose out-of-range index sits mid-array is refused with
    ``DecodingParamsError`` before any index reaches the card: the CUDA
    context stays usable and the anchor untouched."""
    from p2pfl_tpu_torch.exceptions import DecodingParamsError

    rx, honest, hostile = hostile_abs32_frame(kind, cuda_device)
    before = rx.export_state()
    with pytest.raises(DecodingParamsError, match="out of tensor bounds"):
        rx.decode_frame(hostile)
    torch.cuda.synchronize()  # a device-side assert would surface here
    after = rx.export_state()
    for a, b in zip(before["anchor"], after["anchor"]):
        np.testing.assert_array_equal(a, b)
    assert all(bool(torch.isfinite(t).all()) for t in rx.decode_frame(honest)[0])
