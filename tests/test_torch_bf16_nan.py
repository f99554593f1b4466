"""The port's bf16 wire casts keep a NaN's sign, as the JAX package's do
(ml_dtypes' cast: a NaN becomes the quiet NaN of its sign, 0x7FC0 / 0xFFC0;
torch's own cast gives 0xFFFF whatever the sign). Held on the CPU against
the JAX package's bf16 codec, its top-k encoders, its delta codec's value
plane and ml_dtypes itself, byte for byte, and against the chaos plane's
bit-level rounding on every class of f32 input.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from p2pfl_tpu.comm import delta as ref_delta
from p2pfl_tpu.ops import compression as ref_compression
from p2pfl_tpu.ops.serialization import serialize_arrays as ref_serialize
from p2pfl_tpu_torch.chaos.plane import _bf16_round
from p2pfl_tpu_torch.comm import delta
from p2pfl_tpu_torch.ops import compression
from p2pfl_tpu_torch.ops.serialization import serialize_arrays

SPECIALS = np.array([np.nan, -np.nan, 1.0, -0.0], np.float32)


def _bits(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(t).view(np.uint16)


def _random_f32(n: int, seed: int) -> np.ndarray:
    """Random f32 bit patterns: every class (normals, subnormals, zeros,
    infinities, NaNs of both signs with random payloads)."""
    u = np.random.default_rng(seed).integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    nans = np.uint32(0x7F800001) + (u[: n // 8] % np.uint32(0x7FFFFF))
    u[: n // 8] = nans | (u[n // 8: n // 4] & np.uint32(0x80000000))
    return u.view(np.float32)


def test_bf16_round_equals_ml_dtypes_and_the_chaos_plane_bit_for_bit():
    x = np.concatenate([SPECIALS, _random_f32(1 << 18, 0), np.array([np.inf, -np.inf, 3.4e38, -1e-40], np.float32)])
    got = _bits(compression.bf16_round(torch.from_numpy(x)))
    np.testing.assert_array_equal(got, x.astype(ml_dtypes.bfloat16).view(np.uint16))
    np.testing.assert_array_equal(got, _bf16_round(x))
    assert list(got[:4]) == [0x7FC0, 0xFFC0, 0x3F80, 0x8000]
    nan = np.isnan(x)
    assert nan.sum() > 1000 and set(got[nan]) == {0x7FC0, 0xFFC0}
    bf16 = torch.tensor([1.5, float("nan")], dtype=torch.bfloat16)
    assert compression.bf16_round(bf16) is bf16  # already bf16: unchanged


def test_bf16_codec_frame_bytes_equal_the_reference():
    enc, spec = compression.compress_arrays([torch.from_numpy(SPECIALS)], "bf16")
    ref_enc, ref_spec = ref_compression.compress_arrays([SPECIALS], "bf16")
    assert spec == ref_spec
    np.testing.assert_array_equal(_bits(enc[0]), _bits(ref_enc[0]))
    meta = {"contributors": ["a"], "num_samples": 1, "additional_info": {}, compression.CODEC_META_KEY: spec}
    assert bytes(serialize_arrays(enc, meta)) == bytes(ref_serialize([np.asarray(a) for a in ref_enc], meta))
    out = compression.decompress_arrays(enc, spec)[0].numpy()
    assert np.isnan(out[:2]).all() and np.signbit(out[:2]).tolist() == [False, True]


@pytest.mark.parametrize("k", [4, 3, 2, 1])
def test_bf16_topk_encoder_bytes_equal_the_reference(k):
    """Error-feedback top-k in bf16: NaN magnitudes rank above every number
    (as ``lax.top_k`` ranks them), and the values' bytes and residual equal
    the reference's."""
    idx, wire, resid = compression.ef_topk_encode(torch.from_numpy(SPECIALS), torch.zeros(4), k, "bf16")
    ref_idx, ref_wire, ref_resid = ref_compression.ef_topk_encode(SPECIALS, np.zeros(4, np.float32), k, "bf16")
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(_bits(wire), _bits(np.asarray(ref_wire)))
    np.testing.assert_array_equal(resid.numpy(), np.asarray(ref_resid))
    sel, vals = compression.topk_select(torch.from_numpy(SPECIALS), k)
    ref_sel, ref_vals = ref_compression.topk_select(SPECIALS, k)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(ref_sel))
    np.testing.assert_array_equal(vals.numpy().view(np.uint32), np.asarray(ref_vals).view(np.uint32))


def test_delta_codec_bf16_value_plane_equals_the_reference():
    got, entry = delta._encode_values(torch.from_numpy(SPECIALS), "bf16")
    ref, ref_entry = ref_delta._encode_values(SPECIALS, "bf16")
    assert entry == ref_entry and got == ref
    assert list(np.frombuffer(got, np.uint16)) == [0x7FC0, 0xFFC0, 0x3F80, 0x8000]


def test_topk_codec_ships_a_nan_leaf_raw_as_the_reference():
    enc, spec = compression.compress_arrays([torch.from_numpy(SPECIALS)], "topk", ratio=0.5, value_dtype="bf16")
    ref_enc, ref_spec = ref_compression.compress_arrays([SPECIALS], "topk", ratio=0.5, value_dtype="bf16")
    assert spec == ref_spec == [{"codec": "raw"}]
    np.testing.assert_array_equal(np.asarray(enc[0]).view(np.uint32), np.asarray(ref_enc[0]).view(np.uint32))
