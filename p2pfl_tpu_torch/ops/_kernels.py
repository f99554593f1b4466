"""Build, bind and launch the hand-written Hopper kernels of ``csrc/``.

The CUDA source is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface under ``<repo>/build/`` (named by a
hash of the source and flags, so an edited source is rebuilt), then loaded
with :mod:`ctypes`. Nothing is built when this module is imported.

Each wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates its outputs with ``torch.empty``, launches on the
current stream, raises if the launch reports an error, and adds one to its
entry in :data:`LAUNCHES`. The plain versions and the choice between them
and these kernels live in :mod:`p2pfl_tpu_torch.ops.attention`.
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

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "flash_attn.cu"
BUILD_DIR = _PKG.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
HEAD_DIMS = (64,)  # the instances csrc/flash_attn.cu compiles
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: Launches per kernel since the last :func:`reset_launches`. Incremented only
#: where a kernel is launched, never by the plain versions.
LAUNCHES: Dict[str, int] = {
    "flash_fwd": 0,
    "flash_fwd_no_lse": 0,
    "flash_bwd_dq": 0,
    "flash_bwd_dkv": 0,
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
    """Where the library for the current source and flags lives."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"flash_attn_{digest[:16]}.so"


def build() -> Tuple[Path, str]:
    """Compile the CUDA source if its library is not built yet.

    Returns the library path and the compiler's log (``-Xptxas -v``: each
    kernel's registers, shared memory and spills); the log is kept beside
    the library. Raises ``RuntimeError`` with the compiler output on failure.
    """
    out = library_path()
    log = out.with_suffix(".log")
    if out.exists():
        return out, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    text = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{text}")
    log.write_text(text)
    os.replace(tmp, out)  # atomic: a process building at the same time never loads half a file
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
            for fn in (lib.p2pfl_flash_fwd, lib.p2pfl_flash_bwd_dq, lib.p2pfl_flash_bwd_dkv):
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


def _check_qkv(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    _check_bshd(name, q, k, v)
    b, _, h, d = q.shape
    if k.shape != v.shape or (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError(
            f"{name}: incompatible shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}"
        )
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} not supported ({HEAD_DIMS})")


def _check_rows(name: str, q: torch.Tensor, *rows: torch.Tensor) -> None:
    b, s, h, _ = q.shape
    for r in rows:
        if r.shape != (b, h, s) or r.dtype != torch.float32 or not r.is_contiguous():
            raise ValueError(f"{name}: row statistics must be contiguous float32 [B, H, S]")
        if r.device != q.device:
            raise ValueError(f"{name}: row statistics must be on {q.device}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, with_lse: bool
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Kernel forward: ``(out [B,Sq,H,D], lse [B,H,Sq] f32 or None)``."""
    _check_qkv("flash_fwd", q, k, v)
    lib = _load()
    b, sq, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if with_lse else None
    code = lib.p2pfl_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        b, sq, k.shape[1], h, d, _DTYPES[q.dtype], 1.0 / math.sqrt(d), int(causal), _stream(q),
    )
    _check("flash_fwd", code)
    LAUNCHES["flash_fwd" if with_lse else "flash_fwd_no_lse"] += 1
    return out, lse


def flash_bwd_dq(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, causal: bool,
) -> torch.Tensor:
    """Kernel dq from the forward's ``lse`` and ``delta = rowsum(dO * O)``."""
    _check_qkv("flash_bwd_dq", q, k, v)
    _check_bshd("flash_bwd_dq", q, do)
    if do.shape != q.shape:
        raise ValueError("flash_bwd_dq: dO must have q's shape")
    _check_rows("flash_bwd_dq", q, lse, delta)
    lib = _load()
    b, sq, h, d = q.shape
    dq = torch.empty_like(q)
    code = lib.p2pfl_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(),
        b, sq, k.shape[1], h, d, _DTYPES[q.dtype], 1.0 / math.sqrt(d), int(causal), _stream(q),
    )
    _check("flash_bwd_dq", code)
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, causal: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel ``(dk, dv)`` from the forward's ``lse`` and ``delta``."""
    _check_qkv("flash_bwd_dkv", q, k, v)
    _check_bshd("flash_bwd_dkv", q, do)
    if do.shape != q.shape:
        raise ValueError("flash_bwd_dkv: dO must have q's shape")
    _check_rows("flash_bwd_dkv", q, lse, delta)
    lib = _load()
    b, sq, h, d = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    code = lib.p2pfl_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, sq, k.shape[1], h, d, _DTYPES[q.dtype], 1.0 / math.sqrt(d), int(causal), _stream(q),
    )
    _check("flash_bwd_dkv", code)
    LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv
