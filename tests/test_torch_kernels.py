"""The Hopper flash-attention kernels, their wrappers and device routing.

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


def test_library_path_follows_the_source():
    path = _kernels.library_path()
    assert path.parent == _kernels.BUILD_DIR and path.suffix == ".so"
    assert _kernels.SOURCE.is_file()
    assert "arch=compute_90a,code=sm_90a" in _kernels.NVCC_FLAGS


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
        (200, True, torch.float32),
    ],
)
def test_kernels_match_plain_versions_on_card(cuda_device, s, causal, dtype):
    q, k, v, g = _qkv(0, (8, s, 8, 64), dtype, cuda_device)
    # Kernel and plain version both compute in f32 and differ only in the
    # order of their sums, so a bf16 output may differ by the one ulp that
    # rounding two nearly equal f32 values can put between them, and no more.
    if dtype == torch.bfloat16:
        close, close_grad = _within_one_bf16_ulp, _within_one_bf16_ulp
    else:
        close = lambda a, b: torch.testing.assert_close(a, b, atol=1e-5, rtol=0)  # noqa: E731
        close_grad = lambda a, b: torch.testing.assert_close(a, b, atol=1e-4, rtol=0)  # noqa: E731
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
    for a, b in ((dq, dq_p), (dk, dk_p), (dv, dv_p)):
        assert torch.isfinite(a.float()).all()
        close_grad(a, b)


def _within_one_bf16_ulp(got, ref):
    """Every element of ``got`` within one bf16 ulp of ``ref`` (plus 1e-6,
    for values so near zero that the f32 sums' own rounding shows)."""
    got, ref = got.float(), ref.float()
    _, exp = torch.frexp(ref)  # ref = m * 2**exp with 0.5 <= |m| < 1
    ulp = torch.where(ref == 0, torch.zeros_like(ref), torch.ldexp(torch.ones_like(ref), exp - 8))
    diff = (got - ref).abs()
    bad = diff > 1e-6 + ulp
    assert not bad.any(), f"{int(bad.sum())} elements over one bf16 ulp, max diff {float(diff.max()):.3e}"


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
    assert _kernels.LAUNCHES == {"flash_fwd": 1, "flash_fwd_no_lse": 0, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    ref = port.dense_attention(q, k, v)
    ref_grads = torch.autograd.grad((ref**2).sum(), (q, k, v))
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    for a, b in zip(grads, ref_grads):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
    with torch.no_grad():
        port.flash_attention(q, k, v)
    assert _kernels.LAUNCHES["flash_fwd_no_lse"] == 1


@pytest.mark.cuda
def test_kernel_wrappers_reject_what_the_kernel_does_not_take(cuda_device):
    q, k, v, _ = _qkv(2, (1, 64, 2, 48), torch.float32, cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        _kernels.flash_fwd(q, k, v, True, True)
    q, k, v, _ = _qkv(2, (1, 64, 2, 64), torch.float16, cuda_device)
    with pytest.raises(ValueError, match="dtype"):
        _kernels.flash_fwd(q, k, v, True, True)
    q, k, v, _ = _qkv(2, (1, 64, 2, 64), torch.float32, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        _kernels.flash_fwd(q.transpose(1, 2), k, v, True, True)
    assert np.isfinite(_kernels.flash_fwd(q, k, v, True, True)[0].cpu().numpy()).all()
