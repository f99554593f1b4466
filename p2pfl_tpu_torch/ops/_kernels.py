"""Build, bind and launch the hand-written Hopper kernels of ``csrc/``.

The CUDA sources are compiled at first use with ``nvcc`` for ``sm_90a``, one
``nvcc`` per source, all started together, and linked into one shared
library with a plain C interface under ``<repo>/build/`` (named by a hash of
the sources, the headers they include and the flags, so an edited file is
rebuilt), then loaded with :mod:`ctypes`. Nothing is built when this module
is imported.

Each wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates its outputs with ``torch.empty``, launches on the
current stream, raises if the launch reports an error, and adds one to its
entry in :data:`LAUNCHES`.

Head sizes: any D >= 1. Up to 512 the f32 kernels have instances at 16, 32,
64, 128, 256 and 512, all on the CUDA cores; above 512 f32 runs the
CUDA-core kernels of ``csrc/flash_chunked.cu``, which take the head size at
run time and build each score tile a 64-column panel of D at a time. bf16
runs the tensor cores at every D (:func:`kernel_route`): the forward of
``csrc/flash_fwd_narrow_sm90.cu``, the backward pair of
``csrc/flash_bwd_narrow_sm90.cu`` and the carry fold of
``csrc/flash_carry_narrow_sm90.cu`` below 64 (box widths 16, 32 and 64; the
head size at run time, read by TMA at its true size), the kernels at 64
(forward, backward pair, carry fold), the forward and backward pair at 128
and 256, the forward and backward pair of ``csrc/flash_fwd_grouped_sm90.cu``
and ``csrc/flash_bwd_grouped_sm90.cu`` above 256, and the carry fold of
``csrc/flash_carry_grouped_sm90.cu`` above 64 (the head size at run time).

A call at a D the kernel does not take copies q, k, v (dO; the carry's
acc) into zeroed ``[B, S, H, D']`` buffers, D' = :func:`host_head_dim`:
for every bf16 kernel below 64 the next multiple of 8 (TMA strides in
multiples of 16 bytes; 57-63 round to 64, the D 64 kernels), and no copy at
a multiple of 8; elsewhere the next instance (bf16: the next of 128, 256
and 512 above 64; above 512 the next multiple of 64).
The call launches with the true scale ``1/sqrt(D)`` and slices the outputs
back to D. That is exact: zero columns add exact zeros to ``Q.K^T`` and
``dO.V^T``, leave ``delta`` (computed by the caller at D) as it is, and
come out as exact zeros in O, acc, dQ, dK and dV. It is the kernel all the
same, never the plain version, and it counts in :data:`LAUNCHES`. The
choice is made here, before the launch, never as a retry after a failed
one. The plain versions and the choice between them and these kernels
live in :mod:`p2pfl_tpu_torch.ops.attention`.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

_PKG = Path(__file__).resolve().parents[1]
SOURCES = (
    _PKG / "csrc" / "flash_attn.cu",  # f32 forward, backward pair and carry fold; the C entry points
    _PKG / "csrc" / "flash_fwd_sm90.cu",  # bf16 forward and carry fold on the tensor cores
    _PKG / "csrc" / "flash_carry_grouped_sm90.cu",  # bf16 carry fold above D = 64 on the tensor cores
    _PKG / "csrc" / "flash_carry_narrow_sm90.cu",  # bf16 carry fold below D = 64 on the tensor cores, at the true D
    _PKG / "csrc" / "flash_fwd_wide_sm90.cu",  # bf16 forward at D = 128 and 256 on the tensor cores
    _PKG / "csrc" / "flash_fwd_grouped_sm90.cu",  # bf16 forward above D = 256 on the tensor cores
    _PKG / "csrc" / "flash_fwd_narrow_sm90.cu",  # bf16 forward below D = 64 on the tensor cores, at the true D
    _PKG / "csrc" / "flash_bwd_sm90.cu",  # bf16 backward pair (dq; dk/dv) on the tensor cores
    _PKG / "csrc" / "flash_bwd_wide_sm90.cu",  # bf16 backward pair at D = 128 and 256 on the tensor cores
    _PKG / "csrc" / "flash_bwd_grouped_sm90.cu",  # bf16 backward pair above D = 256 on the tensor cores
    _PKG / "csrc" / "flash_bwd_narrow_sm90.cu",  # bf16 backward pair below D = 64 on the tensor cores, at the true D
    _PKG / "csrc" / "flash_chunked.cu",  # f32 above D = 512, the head size a run-time argument
)
HEADERS = (_PKG / "csrc" / "sm90_common.cuh",)  # included by the *_sm90.cu sources
BUILD_DIR = _PKG.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
HEAD_DIMS = (16, 32, 64, 128, 256, 512)  # the f32 instances of csrc/flash_attn.cu; other D <= 512 pad to the next
BF16_HEAD_DIMS = (64, 128, 256, 512)  # the head sizes bf16 pads to up to 512 (every one on the tensor cores)
SM90_HEAD_DIM = 64  # the bf16 tensor-core forward, backward pair and carry fold of the D = 64 sources
MAX_HEAD_DIM = HEAD_DIMS[-1]  # the largest compiled f32 instance; above it the chunked kernels
# bf16 forwards and backward pairs above this run the tensor-core kernels of
# csrc/flash_fwd_grouped_sm90.cu and csrc/flash_bwd_grouped_sm90.cu (at 128
# and 256 the wide ones); the bf16 carry fold above SM90_HEAD_DIM runs
# csrc/flash_carry_grouped_sm90.cu.
SM90_GROUPED_ABOVE = 256
FORWARDS = ("flash_fwd", "flash_fwd_no_lse")
# The kernels whose bf16 calls below SM90_HEAD_DIM take the narrow route: the
# forward (csrc/flash_fwd_narrow_sm90.cu), the backward pair
# (csrc/flash_bwd_narrow_sm90.cu) and the carry fold
# (csrc/flash_carry_narrow_sm90.cu), in box widths NARROW_WIDTHS, which read
# a head size that is a multiple of NARROW_STEP at its true size (TMA strides
# in multiples of 16 bytes).
NARROW_KERNELS = (*FORWARDS, "flash_bwd_dq", "flash_bwd_dkv", "flash_carry")
NARROW_WIDTHS = (16, 32, 64)
NARROW_STEP = 8
CHUNK = 64  # the panel of D of the chunked kernels: above MAX_HEAD_DIM, D pads to a multiple of it
TENSOR_CORES, CUDA_CORES = "tensor cores", "CUDA cores"
NARROW = "tensor cores at the true head size"  # csrc/flash_{fwd,bwd,carry}_narrow_sm90.cu
CHUNKED = "CUDA cores, D in 64-column panels"  # csrc/flash_chunked.cu
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: Launches per kernel since the last :func:`reset_launches`. Incremented only
#: where a kernel is launched, never by the plain versions.
LAUNCHES: Dict[str, int] = {
    "flash_fwd": 0,
    "flash_fwd_no_lse": 0,
    "flash_bwd_dq": 0,
    "flash_bwd_dkv": 0,
    "flash_carry": 0,
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    """Where the library for the current sources, headers and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*SOURCES, *HEADERS):
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    digest = h.hexdigest()
    return BUILD_DIR / f"flash_attn_{digest[:16]}.so"


def build() -> Tuple[Path, str]:
    """Compile the CUDA sources if their library is not built yet.

    Returns the library path and the compiler's log (``-Xptxas -v``: each
    kernel's registers, shared memory and spills); the log is kept beside
    the library. Raises ``RuntimeError`` with the compiler output on failure.
    """
    out = library_path()
    log = out.with_suffix(".log")
    if out.exists():
        return out, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _find_nvcc(), f"{out.stem}.{os.getpid()}"
    objs = [out.with_name(f"{tag}.{src.stem}.o") for src in SOURCES]
    tmp = out.with_name(f"{tag}.tmp.so")
    try:
        compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)] for src, obj in zip(SOURCES, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for cmd in compiles]
        text = "".join(proc.communicate()[0] for proc in procs)
        for cmd, proc in zip(compiles, procs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{text}")
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        text += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): {' '.join(link)}\n{text}")
        log.write_text(text)
        os.replace(tmp, out)  # atomic: a process building at the same time never loads half a file
    finally:
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)
    return out, text


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.p2pfl_flash_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, f, i, p]
            lib.p2pfl_flash_bwd_dq.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, f, i, p]
            lib.p2pfl_flash_bwd_dkv.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, f, i, p]
            lib.p2pfl_flash_carry.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, f, i, i, i, p]
            for fn in (lib.p2pfl_flash_fwd, lib.p2pfl_flash_bwd_dq, lib.p2pfl_flash_bwd_dkv,
                       lib.p2pfl_flash_carry):
                fn.restype = ctypes.c_int
            lib.p2pfl_cuda_error_string.argtypes = [ctypes.c_int]
            lib.p2pfl_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _check(name: str, code: int) -> None:
    if code != 0:
        msg = _load().p2pfl_cuda_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {code} ({msg})")


def _check_bshd(name: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: tensors must be on a CUDA device, got {t.device}")
        if t.dim() != 4:
            raise ValueError(f"{name}: expected [B, S, H, D] tensors, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.dtype != ts[0].dtype or t.device != ts[0].device:
            raise ValueError(f"{name}: tensors must share dtype and device")
    if ts[0].dtype not in _DTYPES:
        raise ValueError(f"{name}: dtype {ts[0].dtype} not supported (float32, bfloat16)")


def kernel_head_dim(dtype: torch.dtype, d: int) -> int:
    """The instance a call at head size ``d`` runs: the smallest of
    :data:`HEAD_DIMS` (f32) or :data:`BF16_HEAD_DIMS` (bf16) not below ``d``;
    above :data:`MAX_HEAD_DIM`, ``d`` rounded up to a multiple of
    :data:`CHUNK`."""
    if d > MAX_HEAD_DIM:
        return -(-d // CHUNK) * CHUNK
    return next(x for x in (BF16_HEAD_DIMS if dtype == torch.bfloat16 else HEAD_DIMS) if x >= d)


def host_head_dim(kernel: str, dtype: torch.dtype, d: int) -> int:
    """The head size the wrapper of ``kernel`` hands its kernel at head size
    ``d``: ``d`` itself where no copy is made, else the size q, k, v (dO;
    acc) are zero-padded to on the host. The bf16 calls of
    :data:`NARROW_KERNELS` (every kernel) below :data:`SM90_HEAD_DIM` round
    ``d`` up to a multiple of :data:`NARROW_STEP` (so 57-63 become 64);
    every other call pads to :func:`kernel_head_dim`."""
    if dtype == torch.bfloat16 and kernel in NARROW_KERNELS and d < SM90_HEAD_DIM:
        return -(-d // NARROW_STEP) * NARROW_STEP
    return kernel_head_dim(dtype, d)


def kernel_route(kernel: str, dtype: torch.dtype, d: int) -> Tuple[int, str]:
    """``(instance head size, NARROW, TENSOR_CORES, CUDA_CORES or CHUNKED)``
    that a call of ``kernel`` (a :data:`LAUNCHES` name) at head size ``d``
    runs, as the C entry points of ``csrc/flash_attn.cu`` dispatch it: the
    bf16 calls of :data:`NARROW_KERNELS` take the narrow kernels
    (``NARROW``, their instance the box width, one of
    :data:`NARROW_WIDTHS`) wherever :func:`host_head_dim` stays below
    :data:`SM90_HEAD_DIM`; every other bf16 call takes the tensor cores
    (the carry fold above :data:`SM90_HEAD_DIM` the grouped carry kernel);
    f32 takes the CUDA-core instances, above :data:`MAX_HEAD_DIM` the
    chunked kernels."""
    hd = host_head_dim(kernel, dtype, d)
    if dtype == torch.bfloat16 and kernel in NARROW_KERNELS and hd < SM90_HEAD_DIM:
        return next(w for w in NARROW_WIDTHS if w >= hd), NARROW
    kd = kernel_head_dim(dtype, d)
    if dtype == torch.bfloat16:
        return kd, TENSOR_CORES
    return kd, CHUNKED if kd > MAX_HEAD_DIM else CUDA_CORES


def _check_qkv(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() == 4 and q.shape[-1] < 1:
        raise ValueError(f"{name}: head_dim {q.shape[-1]} not supported (at least 1)")
    _check_bshd(name, q, k, v)
    b, _, h, d = q.shape
    if k.shape != v.shape or (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError(
            f"{name}: incompatible shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}"
        )


def _check_rows(name: str, q: torch.Tensor, *rows: torch.Tensor) -> None:
    b, s, h, _ = q.shape
    for r in rows:
        if r.shape != (b, h, s) or r.dtype != torch.float32 or not r.is_contiguous():
            raise ValueError(f"{name}: row statistics must be contiguous float32 [B, H, S]")
        if r.device != q.device:
            raise ValueError(f"{name}: row statistics must be on {q.device}")


def _check_aligned(name: str, *ts: torch.Tensor) -> None:
    """The tensor-core kernels (:func:`kernel_route` of ``name`` at ``ts[0]``'s
    dtype and padded head size: ``TENSOR_CORES`` or ``NARROW``) load by TMA
    (and the carry fold accesses ``acc`` as float2), so they need every
    tensor 16-byte aligned."""
    if (kernel_route(name, ts[0].dtype, ts[0].shape[-1])[1] in (TENSOR_CORES, NARROW)
            and any(t.data_ptr() % 16 for t in ts)):
        raise ValueError(f"{name}: the bf16 kernel's tensors must be 16-byte aligned (TMA)")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _pad_heads(name: str, *ts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Each ``[B, S, H, D]`` tensor zero-padded into a new contiguous ``[B, S,
    H, D']`` one, D' = :func:`host_head_dim` of ``name`` at ``ts[0]``
    (16-byte aligned, as a new allocation is). The tensors unchanged where
    D' is D."""
    d = host_head_dim(name, ts[0].dtype, ts[0].shape[-1])
    if d == ts[0].shape[-1]:
        return ts
    return tuple(F.pad(t, (0, d - t.shape[-1])) for t in ts)


def _unpad(t: torch.Tensor, d: int) -> torch.Tensor:
    return t if t.shape[-1] == d else t[..., :d].contiguous()


def flash_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, with_lse: bool
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Kernel forward: ``(out [B,Sq,H,D], lse [B,H,Sq] f32 or None)``.

    bf16 runs the tensor-core kernels at every D (the narrow kernel below
    64, with no copy where D is a multiple of 8; 64, 128 and 256; the grouped
    kernel above 256), whose TMA loads need every tensor 16-byte aligned;
    f32 runs the CUDA-core kernels (above 512 the chunked one)."""
    name = "flash_fwd" if with_lse else "flash_fwd_no_lse"
    _check_qkv(name, q, k, v)
    lib = _load()
    b, sq, h, d = q.shape
    q, k, v = _pad_heads(name, q, k, v)
    out = torch.empty_like(q)
    _check_aligned(name, q, k, v, out)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if with_lse else None
    code = lib.p2pfl_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        b, sq, k.shape[1], h, q.shape[3], _DTYPES[q.dtype], 1.0 / math.sqrt(d), int(causal), _stream(q),
    )
    _check(name, code)
    LAUNCHES[name] += 1
    return _unpad(out, d), lse


def flash_bwd_dq(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, causal: bool,
) -> torch.Tensor:
    """Kernel dq from the forward's ``lse`` and ``delta = rowsum(dO * O)``.

    bf16 runs the tensor-core kernels at every D (the narrow kernel below
    64, with no copy where D is a multiple of 8; 64, 128 and 256; the
    grouped kernel above 256; 16-byte-aligned tensors, as the forward); f32
    runs the CUDA-core kernels (above 512 the chunked one)."""
    _check_qkv("flash_bwd_dq", q, k, v)
    _check_bshd("flash_bwd_dq", q, do)
    if do.shape != q.shape:
        raise ValueError("flash_bwd_dq: dO must have q's shape")
    _check_rows("flash_bwd_dq", q, lse, delta)
    lib = _load()
    b, sq, h, d = q.shape
    q, k, v, do = _pad_heads("flash_bwd_dq", q, k, v, do)
    dq = torch.empty_like(q)
    _check_aligned("flash_bwd_dq", q, k, v, do, dq)
    code = lib.p2pfl_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(),
        b, sq, k.shape[1], h, q.shape[3], _DTYPES[q.dtype], 1.0 / math.sqrt(d), int(causal), _stream(q),
    )
    _check("flash_bwd_dq", code)
    LAUNCHES["flash_bwd_dq"] += 1
    return _unpad(dq, d)


def flash_bwd_dkv(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, causal: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel ``(dk, dv)`` from the forward's ``lse`` and ``delta``; bf16 and
    f32 as :func:`flash_bwd_dq`."""
    _check_qkv("flash_bwd_dkv", q, k, v)
    _check_bshd("flash_bwd_dkv", q, do)
    if do.shape != q.shape:
        raise ValueError("flash_bwd_dkv: dO must have q's shape")
    _check_rows("flash_bwd_dkv", q, lse, delta)
    lib = _load()
    b, sq, h, d = q.shape
    q, k, v, do = _pad_heads("flash_bwd_dkv", q, k, v, do)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _check_aligned("flash_bwd_dkv", q, k, v, do, dk, dv)
    code = lib.p2pfl_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, sq, k.shape[1], h, q.shape[3], _DTYPES[q.dtype], 1.0 / math.sqrt(d), int(causal), _stream(q),
    )
    _check("flash_bwd_dkv", code)
    LAUNCHES["flash_bwd_dkv"] += 1
    return _unpad(dk, d), _unpad(dv, d)


def flash_carry(
    carry: Tuple[torch.Tensor, torch.Tensor, torch.Tensor], q: torch.Tensor, k: torch.Tensor,
    v: torch.Tensor, q_offset: int, kv_offset: int, causal: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel fold of one kv chunk into the carry ``(m [B,H,Sq], l [B,H,Sq],
    acc [B,Sq,H,D])`` (f32); returns a new carry, the incoming one is only
    read. ``q_offset`` / ``kv_offset``: global positions of q's and k's row 0.

    bf16 runs the tensor-core kernels (the narrow one below 64, with no
    copy where D is a multiple of 8; the D 64 one; the grouped one above
    64; q, k, v and acc 16-byte aligned); f32 runs the CUDA-core kernels
    (above 512 the chunked one)."""
    _check_qkv("flash_carry", q, k, v)
    if k.shape[1] < 1:
        raise ValueError("flash_carry: the kv chunk is empty")
    m, l, acc = carry
    _check_rows("flash_carry", q, m, l)
    if acc.shape != q.shape or acc.dtype != torch.float32 or not acc.is_contiguous() or acc.device != q.device:
        raise ValueError("flash_carry: acc must be contiguous float32 with q's shape, on q's device")
    for off in (q_offset, kv_offset):
        if not -(2**31) <= int(off) < 2**31:
            raise ValueError(f"flash_carry: offset {off} does not fit in int32")
    lib = _load()
    b, sq, h, d = q.shape
    q, k, v, acc = _pad_heads("flash_carry", q, k, v, acc)
    _check_aligned("flash_carry", q, k, v, acc)
    m_out, l_out, acc_out = torch.empty_like(m), torch.empty_like(l), torch.empty_like(acc)
    code = lib.p2pfl_flash_carry(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(), l.data_ptr(), acc.data_ptr(),
        m_out.data_ptr(), l_out.data_ptr(), acc_out.data_ptr(),
        b, sq, k.shape[1], h, q.shape[3], _DTYPES[q.dtype], 1.0 / math.sqrt(d), int(causal),
        int(q_offset), int(kv_offset), _stream(q),
    )
    _check("flash_carry", code)
    LAUNCHES["flash_carry"] += 1
    return m_out, l_out, _unpad(acc_out, d)
