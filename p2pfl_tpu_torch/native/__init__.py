"""The native PFLT frame assembly (``pflt_codec.cpp``), built with ``g++`` at
first use and bound by :mod:`ctypes` (the port's copy of
``p2pfl_tpu/native/__init__.py``).

Every weights frame of the wire goes through
:func:`p2pfl_tpu_torch.ops.serialization.serialize_arrays`. With the library
loaded it writes the frame in one pass into one buffer; without it, the
pure-Python path builds the same bytes. The library is built from the
source in the checkout into ``<repo>/build/`` (never into the package), under
a name that hashes the source, the flags and the compiler's version, so an
edited source is rebuilt and a ``build/`` copied from another machine is not
loaded. The link goes to a process-unique temporary file that is then moved into
place, so processes that cold-start together never load half a file.

``Settings.NO_NATIVE`` (``P2PFL_TPU_NO_NATIVE``) takes the pure path on
purpose. A build or load failure is not silent: it logs a warning, leaves
:func:`native_available` false and :data:`BUILD_ERROR` set, and every frame
then counts as a pure pack in :data:`PACKS`.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

log = logging.getLogger("p2pfl_tpu_torch")

SOURCE = Path(__file__).resolve().parent / "pflt_codec.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

#: Frames assembled since the last :func:`reset_packs`: ``native`` by the
#: library, ``pure`` by the Python path (opted out, or no library).
PACKS: Dict[str, int] = {"native": 0, "pure": 0}
#: Why the library is not loaded (the compiler's or the loader's message),
#: or ``None``.
BUILD_ERROR: Optional[str] = None

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def reset_packs() -> None:
    with _lock:
        for k in PACKS:
            PACKS[k] = 0


def count_pack(kind: str) -> None:
    with _lock:
        PACKS[kind] += 1


_compiler: Optional[str] = None


def compiler() -> str:
    """``g++ --version``'s first line (raises ``OSError`` without ``g++``)."""
    global _compiler
    if _compiler is None:
        out = subprocess.run(["g++", "--version"], capture_output=True, text=True, timeout=60)
        _compiler = (out.stdout.splitlines() or ["g++ (unknown version)"])[0]
    return _compiler


def library_path() -> Path:
    """Where the library for the current source, flags and compiler lives
    (another machine's build in a copied ``build/`` is never loaded)."""
    h = hashlib.sha256("\0".join((*CXX_FLAGS, compiler())).encode() + b"\0" + SOURCE.read_bytes())
    return BUILD_DIR / f"pflt_codec_{h.hexdigest()[:16]}.so"


def build() -> Tuple[Path, str]:
    """Compile the codec if its library is not built yet. Returns the
    library path and the compiler's version line; raises ``RuntimeError``
    with the compiler's output on failure (``OSError`` without ``g++``)."""
    out, cxx = library_path(), compiler()
    if out.exists():
        return out, cxx
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}): {' '.join(cmd)}\n{res.stderr[-4000:]}")
        os.replace(tmp, out)  # atomic: a process building at the same time never loads half a file
    finally:
        tmp.unlink(missing_ok=True)
    return out, cxx


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.pflt_packed_size.restype = ctypes.c_size_t
    lib.pflt_packed_size.argtypes = [ctypes.POINTER(ctypes.c_size_t), ctypes.c_size_t, ctypes.c_size_t]
    lib.pflt_pack.restype = ctypes.c_int64
    lib.pflt_pack.argtypes = [
        ctypes.c_char_p,  # dst
        ctypes.c_size_t,  # dst_cap
        ctypes.c_uint16,  # version
        ctypes.c_uint32,  # crc32 (0 = unchecked)
        ctypes.c_char_p,  # header
        ctypes.c_size_t,  # header_len
        ctypes.POINTER(ctypes.c_void_p),  # srcs
        ctypes.POINTER(ctypes.c_size_t),  # sizes
        ctypes.c_size_t,  # n
    ]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on the first call; ``None`` when
    ``Settings.NO_NATIVE`` is set or the build or load failed (then
    :data:`BUILD_ERROR` says why, once, in a warning)."""
    global _lib, _tried, BUILD_ERROR
    from p2pfl_tpu_torch.config import Settings

    if Settings.NO_NATIVE:
        return None
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            path, _ = build()
            _lib = _bind(ctypes.CDLL(str(path)))
        except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
            BUILD_ERROR = str(exc)
            log.warning("native PFLT codec unavailable, frames take the pure-Python path: %s", exc)
            _lib = None
        return _lib


def native_available() -> bool:
    return get_lib() is not None
