"""The port's native PFLT codec (``p2pfl_tpu_torch/native/``) against the
JAX package's frames on both of its paths (its own native codec and
``NO_NATIVE``'s pure-Python one): byte-equal frames for f32, bf16, int8,
0-d and empty leaves, with and without CRC; ``pflt_packed_size`` against the
Python framing; corruption caught; ``NO_NATIVE`` honored; the library built
under ``build/`` and never in the package, by two processes cold-starting
at once; a failed build visible (a warning, ``native_available()`` false,
every frame counted as a pure pack)."""

import ctypes
import os
import struct
import subprocess
import sys
import textwrap

import ml_dtypes
import numpy as np
import pytest
import torch

from p2pfl_tpu.config import Settings as JaxSettings
from p2pfl_tpu.ops import serialization as jax_ser
from p2pfl_tpu_torch import native
from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.exceptions import DecodingParamsError
from p2pfl_tpu_torch.ops import serialization as ser

from test_torch_comm import ROOT

META = {"contributors": ["mem://a", "mem://b"], "num_samples": 96, "additional_info": {"k": np.arange(3.0)}}


def _leaves(seed: int = 0):
    """The same leaves for both packages: (port leaves, JAX leaves). bf16 is a
    torch tensor on the port's side and an ``ml_dtypes`` array on the JAX
    package's, with the same bits."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(-2**15, 2**15, size=(5, 7), dtype=np.int16)
    f32 = rng.standard_normal((33, 17)).astype(np.float32)
    i8 = rng.integers(-128, 128, size=(129,), dtype=np.int8)
    scalar = np.asarray(np.float32(3.25))
    empty = np.zeros((0, 4), np.float32)
    i64 = rng.integers(0, 10**12, size=(3, 2), dtype=np.int64)
    port = [torch.from_numpy(f32), torch.from_numpy(bits.copy()).view(torch.bfloat16), i8, scalar, empty,
            torch.from_numpy(i64), f32[::2]]
    ref = [f32, bits.view(ml_dtypes.bfloat16), i8, scalar, empty, i64, f32[::2]]
    return port, ref


@pytest.mark.parametrize("checksum", [True, False], ids=["crc", "no-crc"])
def test_native_frames_equal_both_jax_paths_byte_for_byte(checksum):
    assert native.native_available(), native.BUILD_ERROR
    port, ref = _leaves()
    got = ser.serialize_arrays(port, META, checksum)
    assert isinstance(got, bytearray)
    ref_native = jax_ser.serialize_arrays(ref, META, checksum)
    with JaxSettings.overridden(NO_NATIVE=True):
        ref_pure = jax_ser.serialize_arrays(ref, META, checksum)
    with Settings.overridden(NO_NATIVE=True):
        got_pure = ser.serialize_arrays(port, META, checksum)
    assert isinstance(got_pure, bytes)
    assert bytes(got) == bytes(ref_native) == ref_pure == got_pure
    arrays, meta = ser.deserialize_arrays(got)
    assert meta["num_samples"] == 96 and meta["contributors"] == META["contributors"]
    assert torch.equal(arrays[1].view(torch.int16), port[1].view(torch.int16))  # bf16 bits, NaNs included
    assert arrays[3].shape == () and arrays[4].shape == (0, 4)
    for a, b in zip(arrays[::2], [p for i, p in enumerate(ref) if i % 2 == 0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_packed_size_equals_the_python_framing():
    lib = native.get_lib()
    assert lib is not None
    for sizes, header in (([], 0), ([0], 1), ([1, 2, 3], 17), ([64, 63, 65, 0, 128], 50), ([1 << 20], 49)):
        arr = (ctypes.c_size_t * max(len(sizes), 1))(*sizes)
        off = ser._PREFIX + header
        off += ser._pad(off)
        for n in sizes:
            off += n + ser._pad(off + n)
        assert lib.pflt_packed_size(arr, len(sizes), header) == off
    port, _ = _leaves(1)
    with Settings.overridden(NO_NATIVE=True):
        pure = ser.serialize_arrays(port, META)
    hosts = [ser._host(a)[2] for a in port]
    header_len = struct.unpack_from("<I", pure, 6)[0]
    sizes = (ctypes.c_size_t * len(hosts))(*[h.nbytes for h in hosts])
    assert lib.pflt_packed_size(sizes, len(hosts), header_len) == len(pure)


def test_native_frame_corruption_of_a_tensor_or_a_metadata_byte_is_caught():
    port, _ = _leaves(2)
    frame = ser.serialize_arrays(port, META)
    header_len = struct.unpack_from("<I", frame, 6)[0]
    for offset in (len(frame) - 200, ser._PREFIX + header_len - 3, ser._PREFIX + 5):
        bad = bytearray(frame)
        bad[offset] ^= 0x20
        with pytest.raises(DecodingParamsError):
            ser.deserialize_arrays(bad)


def test_no_native_is_honored_and_packs_are_counted():
    port, _ = _leaves(3)
    native.reset_packs()
    assert isinstance(ser.serialize_arrays(port), bytearray)
    with Settings.overridden(NO_NATIVE=True):
        assert native.get_lib() is None and not native.native_available()
        assert isinstance(ser.serialize_arrays(port), bytes)
    assert native.PACKS == {"native": 1, "pure": 1}


def test_library_is_built_under_build_never_in_the_package():
    path = native.library_path()
    assert path.parent == ROOT / "build" and path.name.startswith("pflt_codec_") and path.suffix == ".so"
    assert native.native_available() and path.is_file()
    pkg = ROOT / "p2pfl_tpu_torch"
    assert not [p for p in pkg.rglob("*.so")], "a library was built into the package"
    assert sorted(p.name for p in (pkg / "native").iterdir() if p.name != "__pycache__") == [
        "__init__.py", "pflt_codec.cpp"]


_PROBE = textwrap.dedent("""
    import sys
    from pathlib import Path
    sys.path.insert(0, {root!r})
    from p2pfl_tpu_torch import native
    from p2pfl_tpu_torch.ops.serialization import serialize_arrays
    import numpy as np
    native.BUILD_DIR = Path(sys.argv[1])
    ok = native.native_available()
    frame = serialize_arrays([np.arange(10, dtype=np.float32)])
    print(ok, type(frame).__name__, native.library_path().name if ok else "-", native.PACKS, native.BUILD_ERROR)
""")


def test_two_processes_cold_start_the_build_at_once_and_both_load_it(tmp_path):
    script = tmp_path / "probe.py"
    script.write_text(_PROBE.format(root=str(ROOT)))
    build = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, str(script), str(build)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        ok, kind, name, packs = out.split(" ", 3)
        assert ok == "True" and kind == "bytearray" and "'native': 1" in packs
    assert sorted(p.name for p in build.iterdir()) == [native.library_path().name]


def test_a_failed_build_is_visible_not_silent(tmp_path):
    """No compiler on the PATH: a warning, ``native_available()`` false,
    ``BUILD_ERROR`` set, and the frames counted as pure packs (the bytes are
    the same)."""
    script = tmp_path / "probe.py"
    script.write_text(_PROBE.format(root=str(ROOT)))
    env = {**os.environ, "PATH": str(tmp_path / "nowhere")}
    out = subprocess.run([sys.executable, str(script), str(tmp_path / "build")], capture_output=True, text=True,
                         env=env, timeout=240)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("False bytes ") and "'pure': 1" in out.stdout
    assert out.stdout.split("}")[1].strip() not in ("", "None")  # BUILD_ERROR says why
    assert "native PFLT codec unavailable" in out.stderr
    assert not (tmp_path / "build").exists() or not any((tmp_path / "build").iterdir())
