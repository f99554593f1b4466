"""The port's wire plane against the JAX package's: PFLT frames, the index
and nibble codecs, the error-feedback top-k encoders, ``DeltaWireCodec``
frames across frameworks, hostile frames, ``ModelHandle`` frames and the
ledger's content hash.

Frames must decode in the other package to equal leaves, and dense PFLT
bytes must be identical in both directions (exact). The top-k encoders run
on tie-free inputs (``torch.topk`` and ``lax.top_k`` may order equal
magnitudes differently), where indices, values, scales and residuals are
exact: both compute in f32 with the same operations.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from p2pfl_tpu.comm.delta import DeltaWireCodec as JaxCodec
from p2pfl_tpu.config import Settings as JaxSettings
from p2pfl_tpu.exceptions import DecodingParamsError as JaxDecodingParamsError
from p2pfl_tpu.ops import compression as jax_comp
from p2pfl_tpu.ops import serialization as jax_ser
from p2pfl_tpu.telemetry.ledger import canonical_params_hash as jax_hash
from p2pfl_tpu_torch.comm.delta import COALESCE_META_KEY, DeltaWireCodec
from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.exceptions import DecodingParamsError, DeltaAnchorError
from p2pfl_tpu_torch.ops import compression as comp
from p2pfl_tpu_torch.ops import serialization as ser
from p2pfl_tpu_torch.telemetry.ledger import canonical_params_hash
from test_torch_classification import mlp_handles
from test_torch_kernels import hostile_abs32_frame


def _bf16_pair(shape, seed):
    """The same bf16 values as an ml_dtypes array and a torch tensor."""
    a = np.random.default_rng(seed).normal(size=shape).astype(ml_dtypes.bfloat16)
    return a, torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)


def _as_np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    return np.asarray(a, np.float32) if np.asarray(a).dtype == ml_dtypes.bfloat16 else np.asarray(a)


@pytest.mark.parametrize("case", ["f32", "bf16", "int8", "meta"])
def test_pflt_bytes_identical_both_ways_and_cross_decode(case):
    rng = np.random.default_rng(0)
    meta = {"contributors": ["a", "b"], "num_samples": 7, "additional_info": {}}
    if case == "f32":
        ref = [rng.normal(size=(33, 5)).astype(np.float32), np.full((), 2.5, np.float32)]
        port = [torch.from_numpy(a.copy()) for a in ref]
    elif case == "bf16":
        a, t = _bf16_pair((17, 3), 1)
        ref, port = [a, np.arange(4, dtype=np.uint16)], [t, np.arange(4, dtype=np.uint16)]
    elif case == "int8":
        ref = [rng.integers(-127, 128, size=(300,)).astype(np.int8)]
        port = [torch.from_numpy(ref[0].copy())]
    else:
        a, t = _bf16_pair((2, 2), 2)
        ref = port = [np.zeros((1,), np.float32)]
        meta = dict(meta, additional_info={"x": np.ones((3, 2), np.float32), "y": [1, -2.5, None, "s", b"\x00"],
                                           "big": list(range(70)), "neg": -40000})
        port_meta = dict(meta, additional_info=dict(meta["additional_info"], bf=t))
        meta["additional_info"]["bf"] = a
    ref_bytes = bytes(jax_ser.serialize_arrays(ref, meta))
    port_bytes = ser.serialize_arrays(port, port_meta if case == "meta" else meta)
    assert port_bytes == ref_bytes
    for blob, decode in ((ref_bytes, ser.deserialize_arrays), (port_bytes, jax_ser.deserialize_arrays)):
        arrays, got_meta = decode(blob)
        assert len(arrays) == len(ref)
        for a, b in zip(arrays, ref):
            np.testing.assert_array_equal(_as_np(a), _as_np(b))
        assert got_meta["contributors"] == ["a", "b"] and got_meta["num_samples"] == 7
    if case == "meta":
        got = ser.deserialize_arrays(ref_bytes)[1]["additional_info"]
        assert got["y"] == [1, -2.5, None, "s", b"\x00"] and got["neg"] == -40000
        assert got["bf"].dtype == torch.bfloat16 and torch.equal(got["bf"], port_meta["additional_info"]["bf"])
        np.testing.assert_array_equal(got["x"], np.ones((3, 2), np.float32))


def test_corrupted_and_foreign_frames_are_decoding_errors():
    blob = ser.serialize_arrays([np.ones(64, np.float32)], {"contributors": []})
    bad = bytearray(blob)
    bad[len(blob) // 2] ^= 0xFF
    for payload in (bytes(bad), b"NOPE" + blob[4:], blob[:20]):
        with pytest.raises(DecodingParamsError):
            ser.deserialize_arrays(payload)
        with pytest.raises(JaxDecodingParamsError):
            jax_ser.deserialize_arrays(payload)


def test_index_codecs_and_nibbles_equal_jax():
    rng = np.random.default_rng(3)
    for idx, gap8 in ((np.array([0, 3, 4, 100, 65535 + 90]), False), (np.array([5, 200_000]), False),
                      (np.sort(rng.choice(5000, 400, replace=False)), True), (np.array([], np.int64), True)):
        got, codec = ser.encode_sparse_indices(torch.from_numpy(idx.astype(np.int64)), allow_gap8=gap8)
        ref, ref_codec = jax_ser.encode_sparse_indices(idx, allow_gap8=gap8)
        assert codec == ref_codec and got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(ser.decode_sparse_indices(got, codec), jax_ser.decode_sparse_indices(ref, codec))
    q = rng.integers(-7, 8, size=(33,)).astype(np.int8)
    np.testing.assert_array_equal(comp.pack_nibbles(torch.from_numpy(q)), jax_comp.pack_nibbles(q))
    np.testing.assert_array_equal(comp.unpack_nibbles(jax_comp.pack_nibbles(q), 33), q)
    with pytest.raises(ValueError, match="nibble"):
        comp.unpack_nibbles(np.zeros(4, np.uint8), 8)
    with pytest.raises(ValueError, match="range"):
        comp.pack_nibbles(np.array([9], np.int8))


def _tie_free(size, seed, scale=1.0):
    """Distinct magnitudes (a random permutation of a grid), so top-k picks
    one set whatever the tie-break rule."""
    rng = np.random.default_rng(seed)
    mags = (np.arange(1, size + 1, dtype=np.float32) / size) * scale
    return (rng.permutation(mags) * rng.choice([-1.0, 1.0], size)).astype(np.float32)


@pytest.mark.parametrize("value_dtype", ["bf16", "float32"])
def test_ef_topk_encode_equals_jax(value_dtype):
    delta = _tie_free(2048, 4)
    residual = (0.01 * _tie_free(2048, 5)).astype(np.float32)
    idx, vals, res = comp.ef_topk_encode(torch.from_numpy(delta), torch.from_numpy(residual), 204, value_dtype)
    r_idx, r_vals, r_res = jax_comp.ef_topk_encode(delta, residual, 204, value_dtype)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(r_idx))
    np.testing.assert_array_equal(_as_np(vals), np.asarray(r_vals).astype(np.float32))
    np.testing.assert_array_equal(res.numpy(), np.asarray(r_res))  # bit-equal residual
    acc = delta + residual
    deq = vals.float()
    np.testing.assert_array_equal(res.index_add(0, idx, deq).numpy(), acc)  # EF conservation


@pytest.mark.parametrize("bits", [8, 4])
def test_ef_topk_quant_encode_equals_jax(bits):
    delta = _tie_free(4096, 6, 0.3)
    residual = (0.01 * _tie_free(4096, 7)).astype(np.float32)
    idx, q, scale, res = comp.ef_topk_quant_encode(torch.from_numpy(delta), torch.from_numpy(residual), 409, bits)
    r_idx, r_q, r_scale, r_res = jax_comp.ef_topk_quant_encode(delta, residual, 409, bits)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(r_idx))
    np.testing.assert_array_equal(q.numpy(), np.asarray(r_q))
    assert scale == r_scale
    np.testing.assert_array_equal(res.numpy(), np.asarray(r_res))
    acc = torch.from_numpy(delta + residual)
    deq = q.float() * torch.tensor(scale, dtype=torch.float32)
    assert torch.equal(res[idx], acc[idx] - deq)
    assert torch.equal(res.index_add(0, idx, deq), acc)  # the EF conservation contract


def tied_inputs(case, size=4096, seed=8):
    """Inputs whose magnitudes tie at the k-th place (k = 409): ``grid`` draws
    delta from {-2, -1, 1, 2} and the residual from 0.25 * {-1, 0, 1}, so
    acc sits on a 0.25 grid; ``zeros`` leaves 300 of delta's values nonzero,
    so a block of zeros crosses the k-th place."""
    rng = np.random.default_rng(seed)
    delta = rng.choice(np.array([-2.0, -1.0, 1.0, 2.0], np.float32), size)
    residual = (0.25 * rng.choice(np.array([-1.0, 0.0, 1.0], np.float32), size)).astype(np.float32)
    if case == "zeros":
        delta[rng.permutation(size)[300:]] = 0.0
        residual[:] = 0.0
    return delta.astype(np.float32), residual


@pytest.mark.parametrize("case", ["grid", "zeros"])
@pytest.mark.parametrize("encoder", ["select", "bf16", "float32", "int8", "int4"])
def test_topk_encoders_break_ties_as_jax(encoder, case):
    """Among equal magnitudes the lower index is kept, as ``lax.top_k`` does:
    indices, values, scales and residuals equal the JAX package's element
    for element."""
    delta, residual = tied_inputs(case)
    k = 409
    acc = delta + residual
    if encoder == "select":
        got = comp.topk_select(torch.from_numpy(acc), k)
        ref = jax_comp.topk_select(acc, k)
    elif encoder in ("bf16", "float32"):
        got = comp.ef_topk_encode(torch.from_numpy(delta), torch.from_numpy(residual), k, encoder)
        ref = jax_comp.ef_topk_encode(delta, residual, k, encoder)
    else:
        bits = 8 if encoder == "int8" else 4
        idx, q, scale, res = comp.ef_topk_quant_encode(torch.from_numpy(delta), torch.from_numpy(residual), k, bits)
        r_idx, r_q, r_scale, r_res = jax_comp.ef_topk_quant_encode(delta, residual, k, bits)
        got, ref = (idx, q, res), (r_idx, r_q, r_res)
        assert scale == r_scale
    # The boundary really ties: more entries share the k-th magnitude than are kept.
    kth = np.sort(np.abs(acc))[::-1][k - 1]
    assert (np.abs(acc) == kth).sum() > (np.abs(acc)[np.asarray(ref[0])] == kth).sum()
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(_as_np(a), np.asarray(b).astype(_as_np(a).dtype))


@pytest.mark.parametrize("scheme", ["bf16", "int8", "topk"])
def test_compress_arrays_round_trips_across_frameworks(scheme):
    arrays = [_tie_free(640, 8).reshape(64, 10), np.arange(5, dtype=np.int32)]
    got, spec = comp.compress_arrays([torch.from_numpy(arrays[0]), arrays[1]], scheme, ratio=0.2)
    ref, ref_spec = jax_comp.compress_arrays(arrays, scheme, ratio=0.2)
    assert spec == ref_spec
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(_as_np(a), _as_np(b))
    frame = ser.serialize_arrays(got, {comp.CODEC_META_KEY: spec})
    assert frame == bytes(jax_ser.serialize_arrays(ref, {comp.CODEC_META_KEY: ref_spec}))
    dec = comp.decompress_arrays(ser.deserialize_arrays(frame)[0], spec)
    ref_dec = jax_comp.decompress_arrays(jax_ser.deserialize_arrays(frame)[0], ref_spec)
    for a, b in zip(dec, ref_dec):
        np.testing.assert_array_equal(a.numpy(), b)


def _codec_pair(seed=0):
    """A JAX and a port MLP with the same weights, each perturbed by the same
    tie-free update, plus the anchor (canonical leaves)."""
    jh, ph = mlp_handles(seed)
    anchor = jh.get_parameters()
    update = [np.asarray(a) + 0.01 * _tie_free(a.size, 20 + i).reshape(a.shape) for i, a in enumerate(anchor)]
    jh.set_parameters(update)
    ph.set_parameters([torch.from_numpy(u) for u in update])
    for h in (jh, ph):
        h.set_contribution(["s"], 7)
    return jh, ph, anchor


@pytest.mark.parametrize("coalesce", [False, True])
@pytest.mark.parametrize("values", ["bf16", "int8", "int4"])
def test_delta_frames_decode_across_frameworks(values, coalesce):
    jh, ph, anchor = _codec_pair()
    knobs = dict(WIRE_COMPRESSION="topk", WIRE_TOPK_RATIO=0.1, WIRE_TOPK_VALUES=values, COALESCE_ENABLED=coalesce)
    frames = {}
    with Settings.overridden(**knobs), JaxSettings.overridden(**knobs):
        for side, codec, handle in (("port", DeltaWireCodec("s", device="cpu"), ph), ("jax", JaxCodec("s"), jh)):
            codec.set_anchor(anchor, 1)
            frames[side], label = codec.encode_tagged(handle, 1)
            assert label == {"bf16": "topk"}.get(values, f"topk-{values}")
    # Both encoders pick the same values: the frames are the same bytes.
    assert bytes(frames["port"]) == bytes(frames["jax"])
    port_rx, jax_rx = DeltaWireCodec("r", device="cpu"), JaxCodec("r")
    port_rx.set_anchor([torch.from_numpy(np.array(a)) for a in anchor], 1)
    jax_rx.set_anchor(anchor, 1)
    for blob in frames.values():
        got, meta = port_rx.decode_frame(blob)
        ref, ref_meta = jax_rx.decode_frame(bytes(blob))
        assert meta["contributors"] == ref_meta["contributors"] == ["s"] and meta["num_samples"] == 7
        assert (meta.get(COALESCE_META_KEY) is not None) == coalesce
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_delta_codec_round_gating_history_and_dense_frames():
    jh, ph, anchor = _codec_pair(1)
    codec = DeltaWireCodec("s", device="cpu")
    codec.set_anchor(anchor, 1)
    with Settings.overridden(WIRE_COMPRESSION="topk", WIRE_TOPK_RATIO=1.0, WIRE_TOPK_VALUES="float32"):
        assert codec.encode_model(ph, 7) is None  # no anchor for round 7: dense fallback
        blob = codec.encode_model(ph, 1)
        resid = codec.export_state()["residual"]
        codec.anchor_history = 2
        codec.set_anchor(ph.get_parameters(), 2)
        assert codec.encode_model(ph, 1) is not None  # the retired round encodes statelessly
        assert all(np.array_equal(a, b) for a, b in zip(codec.export_state()["residual"], resid))
    with Settings.overridden(WIRE_COMPRESSION="none"):
        assert codec.encode_model(ph, 2) is None
    stale = DeltaWireCodec("x", device="cpu")
    with pytest.raises(DeltaAnchorError):
        stale.decode_frame(blob)
    stale.set_anchor(anchor, 2)
    with pytest.raises(DeltaAnchorError):
        stale.decode_frame(blob)
    rx = DeltaWireCodec("r", device="cpu")
    rx.set_anchor(anchor, 1)
    for got, want in zip(rx.decode_frame(blob)[0], ph.get_parameters()):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    dense, _ = rx.decode_frame(bytes(jh.encode_parameters(compression="none")))
    for got, want in zip(dense, jh.get_parameters()):
        np.testing.assert_array_equal(got.numpy(), want)
    # export / import carries the anchor and residuals bit for bit, in the
    # JAX package's journal format.
    other = JaxCodec("j")
    other.import_state(codec.export_state())
    back = DeltaWireCodec("b", device="cpu")
    back.import_state(other.export_state())
    assert back.anchor_round == 2


def _tampered(blob, mutate):
    arrays, meta = jax_ser.deserialize_arrays(blob)
    arrays = [np.asarray(a) for a in arrays]
    out = mutate(arrays, meta)
    return bytes(jax_ser.serialize_arrays(out if out is not None else arrays, meta))


def _quantized(meta, key, value):
    for s in meta[comp.CODEC_META_KEY]:
        if s.get("values") in ("int8", "int4"):
            s[key] = value


_HOSTILE = {  # the JAX package's hostile coalesced frames (tests/test_sparse_delta.py)
    "nan_scale": lambda arrays, meta: _quantized(meta, "scale", float("nan")),
    "zero_scale": lambda arrays, meta: _quantized(meta, "scale", 0.0),
    "hostile_zero_point": lambda arrays, meta: _quantized(meta, "zero_point", 1e9),
    "extent_mismatch": lambda arrays, meta: meta[comp.CODEC_META_KEY][0].__setitem__(
        "idx_bytes", 1 + int(meta[comp.CODEC_META_KEY][0]["idx_bytes"])),
    "truncated_plane": lambda arrays, meta: arrays[:-1] + [arrays[-1][: max(1, arrays[-1].size // 2)]],
    "inflate_bomb": lambda arrays, meta: meta[COALESCE_META_KEY]["raw_len"].__setitem__(1, 2),
}


@pytest.mark.parametrize("name", list(_HOSTILE))
def test_hostile_coalesced_frames_rejected_before_anchor(name):
    jh, _, anchor = _codec_pair(2)
    sender = JaxCodec("s")
    sender.set_anchor(anchor, 1)
    with JaxSettings.overridden(WIRE_COMPRESSION="topk", WIRE_TOPK_RATIO=0.1, WIRE_TOPK_VALUES="int8",
                                COALESCE_ENABLED=True):
        blob = bytes(sender.encode_tagged(jh, 1)[0])
    hostile = _tampered(blob, _HOSTILE[name])
    port_rx, jax_rx = DeltaWireCodec("r", device="cpu"), JaxCodec("r")
    port_rx.set_anchor(anchor, 1)
    jax_rx.set_anchor(anchor, 1)
    with pytest.raises(JaxDecodingParamsError):
        jax_rx.decode_frame(hostile)
    before = port_rx.export_state()
    with pytest.raises(DecodingParamsError):
        port_rx.decode_frame(hostile)
    after = port_rx.export_state()
    assert after["anchor_round"] == before["anchor_round"]
    for a, b in zip(before["anchor"], after["anchor"]):
        np.testing.assert_array_equal(a, b)
    assert all(torch.isfinite(a).all() for a in port_rx.decode_frame(blob)[0])


@pytest.mark.parametrize("kind", ["delta", "dense"])
def test_unsorted_abs32_index_out_of_range_is_refused(kind):
    """abs32 indices arrive in any order: a frame whose out-of-range index
    sits mid-array (first and last in bounds) is refused with
    ``DecodingParamsError`` and the anchor is untouched. The card's
    counterpart is in ``test_torch_kernels.py``."""
    rx, honest, hostile = hostile_abs32_frame(kind, torch.device("cpu"))
    before = rx.export_state()
    with pytest.raises(DecodingParamsError, match="out of tensor bounds"):
        rx.decode_frame(hostile)
    for a, b in zip(before["anchor"], rx.export_state()["anchor"]):
        np.testing.assert_array_equal(a, b)
    assert all(torch.isfinite(t).all() for t in rx.decode_frame(honest)[0])


def test_model_handle_frames_decode_in_the_other_package():
    jh, ph = mlp_handles(3)
    ph.set_contribution(["p"], 11)
    ph.add_info("note", np.arange(3, dtype=np.int32))
    frame = ph.encode_parameters(compression="none")
    twin = jh.build_copy(contributors=["p"], num_samples=11)
    twin.add_info("note", np.arange(3, dtype=np.int32))
    assert frame == bytes(twin.encode_parameters(compression="none"))
    fresh = mlp_handles(4)[0]
    fresh.set_parameters(frame)
    for got, want in zip(fresh.get_parameters(), jh.get_parameters()):
        np.testing.assert_array_equal(got, want)
    assert fresh.contributors == ["p"] and fresh.num_samples == 11
    np.testing.assert_array_equal(fresh.get_info("note"), np.arange(3))
    back = mlp_handles(5)[1]
    back.set_parameters(bytes(fresh.encode_parameters(compression="none")))
    for name, t in ph.params.items():
        assert torch.equal(back.params[name], t)
    # Lossy codecs decode to the same leaves on both sides.
    for scheme in ("bf16", "int8"):
        blob = ph.encode_parameters(compression=scheme)
        jax_rx, port_rx = mlp_handles(6)
        port_rx.set_parameters(blob)
        jax_rx.set_parameters(bytes(blob))
        for got, want in zip(jax_rx.get_parameters(), port_rx.get_parameters()):
            np.testing.assert_array_equal(got, want.numpy())


def test_canonical_params_hash_equal_across_frameworks():
    jh, ph = mlp_handles(7)
    h = jax_hash(jh.params)
    assert canonical_params_hash(ph.params) == canonical_params_hash(ph.get_parameters()) == h
    assert jax_hash(jh.get_parameters()) == h
    nested = {"b": {"y": np.ones(2, np.float32), "x": -0.0 * np.ones(3, np.float32)}, "a": np.arange(2)}
    assert canonical_params_hash(nested) == jax_hash(nested)
    ph.params[next(iter(ph.params))][0, 0] += 1e-3
    assert canonical_params_hash(ph.params) != h
