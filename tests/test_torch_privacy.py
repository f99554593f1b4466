"""The port's privacy plane (``p2pfl_tpu_torch/privacy/``, ``MaskedFedAvg``,
``screen_masked``, the budget ledger) on the CPU.

Two halves:

* the JAX package's ``tests/test_privacy.py`` run against the port: pairwise
  masks cancel exactly in any merge order, masked FedAvg is bit-exact with
  the identical pipeline run maskless, error feedback carries what the
  lattice did not ship, dead maskers are repaired from revealed round
  secrets and from journaled keys, hostile keys / frames / repairs are
  refused and counted, the range check and the anchor-round check refuse
  to finalize, the budget ledger rides its gauge into the digest, a masked
  frame stays within 1.15x the top-k int8 frame, and the masked aggregate
  differs from plaintext FedAvg (the parity gate's negative control). Its
  ``fed_top`` case stays with the JAX package: the port has no ``fed_top``.
* the port against the JAX package on the same seeded numpy inputs and
  fixed private keys: key payloads, pair and round secrets, supports,
  streams, packed planes, ``mask_own`` lattices and residuals, frames and
  ``finalize`` outputs equal, bit for bit.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from p2pfl_tpu.config import Settings as RefSettings
from p2pfl_tpu.learning.aggregators.masked import MaskedFedAvg as RefMaskedFedAvg
from p2pfl_tpu.models.model_handle import ModelHandle as RefHandle
from p2pfl_tpu.privacy import masking as ref_masking
from p2pfl_tpu.privacy.secagg import PrivacyPlane as RefPlane
from p2pfl_tpu_torch.comm.admission import AdmissionController
from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.learning.aggregators import MaskedFedAvg
from p2pfl_tpu_torch.learning.privacy import dp_sgd_privacy_spent, gaussian_rdp_epsilon, resolve_seed
from p2pfl_tpu_torch.models.model_handle import ModelHandle
from p2pfl_tpu_torch.privacy import (
    BUDGETS,
    PairwiseMasker,
    PrivacyPlane,
    lattice_qmax,
    ring_dtype,
    round_secret,
    shared_support,
    signed_share,
    wire_epsilon,
)
from p2pfl_tpu_torch.privacy import masking
from p2pfl_tpu_torch.telemetry import REGISTRY

from test_torch_comm import RAW_VALUES, ROOT, SETTINGS_PROBE


@pytest.fixture(autouse=True)
def _fresh_registry():
    REGISTRY.reset()
    BUDGETS.reset()
    yield
    REGISTRY.reset()
    BUDGETS.reset()


#: Fixed session private keys, so the two packages' planes hold equal keys.
PRIVATE = [0x1F2E3D4C5B6A7988 + 7919 * i for i in range(6)]


def _inputs(n=3, seed=0, shapes=((24, 6), (11,))):
    rng = np.random.default_rng(seed)
    anchor = [rng.normal(size=s).astype(np.float32) for s in shapes]
    leaves = [[x + rng.normal(scale=1e-3, size=x.shape).astype(np.float32) for x in anchor] for _ in range(n)]
    return anchor, leaves


def _planes(cls, addrs, fixed_keys, **kw):
    planes = {a: cls(a, **kw) for a in addrs}
    if fixed_keys:
        for i, a in enumerate(addrs):
            planes[a].masker = planes[a].masker.__class__(a, _private=PRIVATE[i])
    for a in addrs:
        for b in addrs:
            if a != b:
                assert planes[a].learn_key(b, planes[b].masker.public_key_hex())
    return planes


def _federation(n=3, round=2, seed=0, fixed_keys=False):
    """n port planes with exchanged keys + n parameters-only handles around
    a shared anchor (the JAX package's ``_federation``)."""
    addrs = [f"n{i}" for i in range(n)]
    planes = _planes(PrivacyPlane, addrs, fixed_keys, device="cpu")
    anchor, leaves = _inputs(n, seed)
    models = {a: ModelHandle(params=leaves[i], contributors=[a], num_samples=10 + i) for i, a in enumerate(addrs)}
    return addrs, planes, anchor, models, round


def _ref_federation(n=3, round=2, seed=0):
    """The same federation in the JAX package (fixed keys)."""
    addrs = [f"n{i}" for i in range(n)]
    planes = _planes(RefPlane, addrs, True)
    anchor, leaves = _inputs(n, seed)
    models = {a: RefHandle(params=leaves[i], contributors=[a], num_samples=10 + i) for i, a in enumerate(addrs)}
    return addrs, planes, anchor, models, round


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _encode_all(planes, models, anchor, addrs, r, mask):
    handles = []
    for a in addrs:
        planes[a].reset()
        handles.append(planes[a].mask_own(models[a], anchor, r, addrs, mask=mask))
    return handles


# --- mask algebra -------------------------------------------------------------------------


def test_pair_secrets_symmetric_and_distinct():
    a, b, c = PairwiseMasker("a"), PairwiseMasker("b"), PairwiseMasker("c")
    for x, y in ((a, b), (a, c), (b, c)):
        assert x.learn_key(y.addr, y.public_key_hex())
        assert y.learn_key(x.addr, x.public_key_hex())
    assert a.pair_secret("b") == b.pair_secret("a")
    assert a.pair_secret("c") == c.pair_secret("a")
    assert a.pair_secret("b") != a.pair_secret("c")


def test_hostile_pubkeys_rejected():
    m = PairwiseMasker("a")
    assert not m.learn_key("b", "zz-not-hex")
    assert not m.learn_key("b", "0")  # out of group range
    assert not m.learn_key("b", "1")
    assert not m.learn_key("a", PairwiseMasker("x").public_key_hex())  # self


def test_total_masks_cancel_over_committee():
    addrs, planes, _, _, r = _federation(4)
    bits = Settings.PRIVACY_RING_BITS
    for tensor_idx, k in ((0, 31), (1, 7)):
        acc = np.zeros(k, ring_dtype(bits))
        for a in addrs:
            acc = acc + planes[a].masker.total_mask(addrs, r, tensor_idx, k, bits)
        assert not acc.any()


def test_signed_share_pair_sums_to_zero():
    a, b = PairwiseMasker("a"), PairwiseMasker("b")
    a.learn_key("b", b.public_key_hex())
    b.learn_key("a", a.public_key_hex())
    rs = a.pair_round_secret("b", 5)
    assert rs == b.pair_round_secret("a", 5)  # both ends derive it
    bits = Settings.PRIVACY_RING_BITS
    s_ab = signed_share(rs, "a", "b", 0, 16, bits)
    s_ba = signed_share(rs, "b", "a", 0, 16, bits)
    assert not (s_ab + s_ba).any()
    rs6 = a.pair_round_secret("b", 6)
    assert not np.array_equal(s_ab, signed_share(rs6, "a", "b", 0, 16, bits))
    assert not np.array_equal(s_ab, signed_share(rs, "a", "b", 1, 16, bits))


def test_repair_reveal_is_round_scoped():
    """The wire form of a repair is H(pair_secret, round), not the pair
    secret: a captured round-r reveal regenerates round r's stream and no
    other round's."""
    a, b = PairwiseMasker("a"), PairwiseMasker("b")
    a.learn_key("b", b.public_key_hex())
    b.learn_key("a", a.public_key_hex())
    r, bits = 5, Settings.PRIVACY_RING_BITS
    reveal = round_secret(a.pair_secret("b"), r)
    assert reveal != a.pair_secret("b")
    assert np.array_equal(PairwiseMasker.stream(reveal, 0, 16, bits),
                          PairwiseMasker.stream(a.pair_round_secret("b", r), 0, 16, bits))
    true_next = PairwiseMasker.stream(a.pair_round_secret("b", r + 1), 0, 16, bits)
    assert not np.array_equal(PairwiseMasker.stream(round_secret(reveal, r + 1), 0, 16, bits), true_next)
    assert not np.array_equal(PairwiseMasker.stream(reveal, 0, 16, bits), true_next)


def test_shared_support_deterministic_sorted_bounded():
    idx = shared_support(3, 0, 1000, 0.1)
    assert np.array_equal(idx, shared_support(3, 0, 1000, 0.1))
    assert idx.size == 100 and (np.diff(idx) > 0).all()
    assert 0 <= idx[0] and idx[-1] < 1000
    assert not np.array_equal(idx, shared_support(4, 0, 1000, 0.1))
    assert shared_support(3, 0, 3, 0.1).size == 1  # floor of one value


def test_lattice_qmax_bounds():
    assert lattice_qmax(16, 3) == 32767 // (3 * masking.LATTICE_HEADROOM)
    assert 3 * lattice_qmax(16, 3) * masking.LATTICE_HEADROOM <= (1 << 15) - 1
    with pytest.raises(ValueError):
        lattice_qmax(16, 40000)  # qmax < 1


def test_pack_ring_roundtrip_all_widths():
    rng = np.random.default_rng(3)
    for bits in (12, 16, 32):
        for k in (1, 2, 7, 64):
            v = rng.integers(0, 1 << bits, size=k, dtype=np.uint64).astype(ring_dtype(bits))
            packed = masking.pack_ring(v, bits)
            assert packed.dtype == np.uint8
            if bits == 12:
                assert packed.size == 3 * ((k + 1) // 2)  # 1.5 B/value
            assert np.array_equal(masking.unpack_ring(packed, k, bits), v)
    v = np.array([4096 + 5, 65535], np.uint16)  # unreduced mod-2**16 carrier
    assert np.array_equal(masking.unpack_ring(masking.pack_ring(v, 12), 2, 12), np.array([5, 4095], np.uint16))
    with pytest.raises(ValueError):
        masking.unpack_ring(np.zeros(4, np.uint8), 2, 12)  # wrong plane length
    with pytest.raises(ValueError):
        masking.unpack_ring(np.zeros(3, np.uint8), 4, 12)


def test_hostile_packed_frame_dies_as_value_error():
    addrs, planes, anchor, models, r = _federation(2)
    handle = planes[addrs[0]].mask_own(models[addrs[0]], anchor, r, addrs)
    blob = PrivacyPlane.encode_frame(handle)
    from p2pfl_tpu_torch.ops.serialization import deserialize_arrays

    arrays, meta = deserialize_arrays(bytes(blob))
    assert PrivacyPlane.is_masked_frame(meta)
    lat = PrivacyPlane.parse_frame(arrays, meta)
    ring = 1 << Settings.PRIVACY_RING_BITS
    for x, y in zip(lat, handle.get_parameters()):
        assert np.array_equal(x, (np.asarray(y).astype(np.uint32) % ring).astype(x.dtype))
    with pytest.raises(ValueError):
        PrivacyPlane.parse_frame(arrays[:-1], meta)  # tensor count
    with pytest.raises(ValueError):
        PrivacyPlane.parse_frame([np.zeros(2, np.uint8)] * len(arrays), meta)  # plane length
    bad_meta = {**meta, "__masked__": {**meta["__masked__"], "bits": 13}}
    with pytest.raises(ValueError):
        PrivacyPlane.parse_frame(arrays, bad_meta)  # unknown ring


# --- bit-exactness & merge-order independence --------------------------------------------


def test_masked_bitexact_with_maskless_and_merge_order_independent():
    addrs, planes, anchor, models, r = _federation(3)
    agg = MaskedFedAvg()
    agg.set_addr(addrs[0])

    def finalized(mask, order):
        handles = _encode_all(planes, models, anchor, addrs, r, mask)
        merged = agg.aggregate([handles[i] for i in order])
        out, outcome = planes[addrs[0]].finalize(merged, addrs, anchor)
        assert outcome == "ok"
        return [_np(t) for t in out]

    base = finalized(True, [0, 1, 2])
    for order in ([2, 1, 0], [1, 0, 2]):
        for x, y in zip(base, finalized(True, order)):
            assert np.array_equal(x, y)
    for x, y in zip(base, finalized(False, [0, 1, 2])):
        assert np.array_equal(x, y)  # bit-exact, not allclose


def test_masked_aggregate_tracks_true_mean():
    addrs, planes, anchor, models, r = _federation(3)
    agg = MaskedFedAvg()
    agg.set_addr(addrs[0])
    handles = _encode_all(planes, models, anchor, addrs, r, True)
    out, outcome = planes[addrs[0]].finalize(agg.aggregate(handles), addrs, anchor)
    assert outcome == "ok"
    true_mean = [anchor[i] + np.mean([np.asarray(models[a].params[i]) - anchor[i] for a in addrs], axis=0)
                 for i in range(len(anchor))]
    _, _, scale = PrivacyPlane.lattice_params(len(addrs))
    for i, (got, want) in enumerate(zip(out, true_mean)):
        got_f, want_f, anc_f = _np(got).reshape(-1), want.reshape(-1), anchor[i].reshape(-1)
        idx = shared_support(r, i, got_f.size, Settings.PRIVACY_MASK_RATIO)
        assert np.abs(got_f[idx] - want_f[idx]).max() <= scale
        off = np.setdiff1d(np.arange(got_f.size), idx)
        assert np.array_equal(got_f[off], anc_f[off])


def test_error_feedback_carries_untransmitted_mass():
    addrs, planes, anchor, models, r = _federation(2)
    p = planes[addrs[0]]
    p.mask_own(models[addrs[0]], anchor, r, addrs)
    delta0 = np.asarray(models[addrs[0]].params[0]).reshape(-1) - anchor[0].reshape(-1)
    resid = _np(p.residual()[0])
    idx = shared_support(r, 0, delta0.size, Settings.PRIVACY_MASK_RATIO)
    off = np.setdiff1d(np.arange(delta0.size), idx)
    assert np.allclose(resid[off], delta0[off])  # off-support: the full delta waits
    _, _, scale = PrivacyPlane.lattice_params(len(addrs))
    assert np.abs(resid[idx]).max() <= 0.5 * scale + 1e-7  # on-support: the lattice error


# --- dropout recovery ---------------------------------------------------------------------


def test_dropout_repair_via_revealed_secrets():
    addrs, planes, anchor, models, r = _federation(3)
    agg = MaskedFedAvg()
    agg.set_addr(addrs[0])
    handles = _encode_all(planes, models, anchor, addrs, r, True)
    dead = addrs[2]
    merged = agg.aggregate(handles[:2])  # the dead masker's frame never arrived
    out, outcome = planes[addrs[0]].finalize(merged, addrs, anchor)
    assert out is None and outcome == "unrepaired"
    sec = planes[addrs[1]].repair_secrets_for(dead, r)
    assert sec is not None
    assert planes[addrs[0]].note_repair(r, addrs[1], dead, sec)
    assert not planes[addrs[0]].note_repair(r, addrs[1], dead, "ab" * 32)  # first write wins
    out, outcome = planes[addrs[0]].finalize(merged, addrs, anchor)
    assert outcome == "ok"
    plain = _encode_all(planes, models, anchor, addrs, r, False)
    plain_merged = agg.aggregate(plain[:2])
    bits = Settings.PRIVACY_RING_BITS
    _, _, scale = PrivacyPlane.lattice_params(len(addrs))
    for i, (got, anc) in enumerate(zip(out, anchor)):
        idx = shared_support(r, i, anc.size, Settings.PRIVACY_MASK_RATIO)
        t = masking.center_ring(np.asarray(plain_merged.get_parameters()[i]), bits)
        vbar = (t.astype(np.float64) * float(scale) / 2).astype(np.float32)
        want = anc.reshape(-1).astype(np.float32, copy=True)
        want[idx] = want[idx] + vbar
        assert np.array_equal(_np(got).reshape(-1), want)
    fam = REGISTRY.get("p2pfl_privacy_repairs_total")
    roles = {(lbl["node"], lbl["role"]): c.value for lbl, c in fam.samples()}
    assert roles[(addrs[1], "tx")] == 1 and roles[(addrs[0], "rx")] == 1 and roles[(addrs[0], "applied")] == 2


def test_dropout_repair_via_journaled_seeds():
    """A crash-restarted masker re-derives identical masks from journaled key
    material (export/import round-trip)."""
    addrs, planes, anchor, models, r = _federation(3)
    p = planes[addrs[0]]
    resurrected = PrivacyPlane(addrs[0], device="cpu")
    resurrected.import_state(json.loads(json.dumps(p.export_state())))
    bits = Settings.PRIVACY_RING_BITS
    assert np.array_equal(p.masker.total_mask(addrs, r, 0, 17, bits),
                          resurrected.masker.total_mask(addrs, r, 0, 17, bits))
    assert resurrected.masker.pair_secret(addrs[1]) == p.masker.pair_secret(addrs[1])
    # ... and its re-encoded frame is the lost one, byte for byte.
    lost = PrivacyPlane.encode_frame(p.mask_own(models[addrs[0]], anchor, r, addrs))
    again = PrivacyPlane.encode_frame(resurrected.mask_own(models[addrs[0]], anchor, r, addrs))
    assert lost == again
    unreadable = PrivacyPlane(addrs[0], device="cpu")
    key = unreadable.key_payload()
    unreadable.import_state({"masker": {"private": "not-hex"}})  # keeps its own keypair
    assert unreadable.key_payload() == key


def test_repair_reveal_once_and_hostile_repairs_dropped():
    addrs, planes, _, _, r = _federation(3)
    p = planes[addrs[0]]
    assert p.repair_secrets_for("ghost", r) is None  # unknown peer: nothing
    sec = p.repair_secrets_for(addrs[1], r)
    assert sec is not None
    assert p.repair_secrets_for(addrs[1], r) is None  # dedup per (round, dead)
    q = planes[addrs[1]]
    q.note_committee(r, addrs)
    assert not q.note_repair(r, addrs[0], addrs[0], "ab" * 32)  # survivor == dead
    assert not q.note_repair(r, addrs[0], addrs[2], "zz")  # not hex
    assert not q.note_repair(r, addrs[0], addrs[2], "ab" * 8)  # wrong length
    assert not q.note_repair(r, "outsider", addrs[2], "ab" * 32)
    assert not q.note_repair(r, addrs[0], "outsider", "ab" * 32)
    assert not q.note_repair(r + 1, addrs[0], addrs[2], "ab" * 32)  # no committee registered
    assert q.note_repair(r, addrs[0], addrs[2], sec)
    assert not q.note_repair(r, addrs[0], addrs[2], "ab" * 32)
    assert q._repairs[(r, addrs[0], addrs[2])] == bytes.fromhex(sec)


# --- hostile masked frames -----------------------------------------------------------------


def _masked_meta(r=2, n=3, bits=None, ks=(10,)):
    return {"round": r, "bits": Settings.PRIVACY_RING_BITS if bits is None else bits, "n": n, "ks": list(ks)}


def test_hostile_masked_frames_rejected_and_counted():
    adm = AdmissionController("t0")
    committee = ["a", "b", "c"]
    dt = ring_dtype(Settings.PRIVACY_RING_BITS)
    good = [np.zeros(10, dt)]

    def rejected(reason, **kw):
        before = adm.rejected_count(reason)
        args = {"arrays": good, "info": _masked_meta(), "committee": committee, "contributors": ["a"],
                "expected_ks": [10], "source": "evil"}
        args.update(kw)
        assert adm.screen_masked(**args) == reason
        assert adm.rejected_count(reason) == before + 1

    rejected("masked_structure", info=None)
    rejected("masked_structure", info={"round": "x"})
    rejected("masked_structure", info=_masked_meta(bits=8))  # wrong ring
    rejected("masked_structure", info=_masked_meta(n=2))  # committee mismatch
    rejected("masked_member", contributors=["outsider"])
    rejected("masked_member", contributors=[])
    rejected("masked_structure", arrays=[np.zeros(9, dt)])  # short plane
    rejected("masked_structure", arrays=[np.zeros(10, np.float32)])  # not ring
    rejected("masked_structure", arrays=[])  # tensor count
    assert adm.screen_masked(good, _masked_meta(), committee=committee, contributors=["a"], expected_ks=[10],
                             source="honest") is None


def test_range_check_rejects_wrapped_sum_before_model():
    addrs, planes, anchor, models, r = _federation(2)
    agg = MaskedFedAvg()
    agg.set_addr(addrs[0])
    handles = _encode_all(planes, models, anchor, addrs, r, True)
    bad = handles[1]
    params = [np.asarray(a).copy() for a in bad.get_parameters()]
    params[0] = params[0] + ring_dtype(Settings.PRIVACY_RING_BITS).type(3 << (Settings.PRIVACY_RING_BITS - 3))
    hostile = ModelHandle(params=params, contributors=bad.contributors, num_samples=bad.num_samples,
                          additional_info=dict(bad.additional_info))
    out, outcome = planes[addrs[0]].finalize(agg.aggregate([handles[0], hostile]), addrs, anchor)
    assert out is None and outcome == "range"


def test_finalize_refuses_mismatched_anchor_round():
    addrs, planes, anchor, models, r = _federation(3)
    agg = MaskedFedAvg()
    agg.set_addr(addrs[0])
    merged = agg.aggregate(_encode_all(planes, models, anchor, addrs, r, True))
    out, outcome = planes[addrs[0]].finalize(merged, addrs, anchor, anchor_round=r + 1)
    assert out is None and outcome == "structure"
    out, outcome = planes[addrs[0]].finalize(merged, addrs, anchor, anchor_round=r)
    assert outcome == "ok" and out is not None
    fam = REGISTRY.get("p2pfl_privacy_masked_rounds_total")
    outcomes = {lbl["outcome"]: c.value for lbl, c in fam.samples() if lbl["node"] == addrs[0] and c.value}
    assert outcomes == {"structure": 1, "ok": 1}


def test_masked_merge_drops_plaintext_and_foreign_lattices():
    addrs, planes, anchor, models, r = _federation(3)
    agg = MaskedFedAvg()
    agg.set_addr(addrs[0])
    handles = _encode_all(planes, models, anchor, addrs, r, True)
    merged = agg.aggregate([handles[0], models[addrs[1]], handles[2]])
    assert sorted(merged.contributors) == [addrs[0], addrs[2]]
    other = _encode_all(planes, models, anchor, addrs, r + 1, True)
    assert agg.aggregate([handles[0], other[1]]).contributors == [addrs[0]]


# --- the parameters-only handle -------------------------------------------------------------


def test_parameters_only_handle_keeps_leaves_and_runs_nothing():
    lat = [np.arange(5, dtype=np.uint16), np.arange(3, dtype=np.uint32)]
    h = ModelHandle(params=lat, contributors=["a"], num_samples=3)
    got = h.get_parameters()
    assert [g is l for g, l in zip(got, lat)] == [True, True]  # as they are, on the host
    assert h.device == torch.device("cpu") and "params=8" in repr(h)
    with pytest.raises(TypeError):
        h.apply(lat, torch.zeros(1))
    with pytest.raises(TypeError):
        h.build_copy()
    with pytest.raises(TypeError):
        h.set_parameters(lat)


# --- accountant and budget ----------------------------------------------------------------


def test_accountant_monotonicity():
    eps = [gaussian_rdp_epsilon(1.0, t, 1e-5) for t in (1, 10, 100, 1000)]
    assert all(b > a for a, b in zip(eps, eps[1:]))
    sig = [gaussian_rdp_epsilon(s, 100, 1e-5) for s in (0.5, 1.0, 2.0, 4.0)]
    assert all(b < a for a, b in zip(sig, sig[1:]))
    assert gaussian_rdp_epsilon(1.0, 100, 1e-5) < gaussian_rdp_epsilon(1.0, 100, 1e-7)
    assert gaussian_rdp_epsilon(0.0, 10, 1e-5) == math.inf
    assert gaussian_rdp_epsilon(1.0, 0, 1e-5) == 0.0
    with pytest.raises(ValueError):
        gaussian_rdp_epsilon(1.0, 10, 1.5)


def test_privacy_spent_honest_about_voided_guarantee():
    ok = dp_sgd_privacy_spent(1.0, 1.0, 100)
    assert 0 < ok["epsilon"] < math.inf
    assert dp_sgd_privacy_spent(1.0, 1.0, 100, nonprivate_steps=1)["epsilon"] == math.inf
    assert dp_sgd_privacy_spent(1.0, 1.0, 0)["epsilon"] == 0.0


def test_resolve_seed_entropy_and_pinned_warning():
    assert resolve_seed(None) != resolve_seed(None)  # OS entropy (collision odds 2^-31)
    assert resolve_seed(42) == 42
    with pytest.warns(UserWarning):
        resolve_seed(42, dp_noise_multiplier=1.0)


def test_budget_ledger_rides_gauge_and_wire_sentinel():
    from p2pfl_tpu.privacy.budget import PrivacyBudgetLedger as RefLedger

    ref = RefLedger()
    for led in (BUDGETS, ref):
        led.record("nA", clip_norm=1.0, noise_multiplier=1.0, dp_steps=50)
    eps1 = BUDGETS.epsilon("nA")
    assert 0 < eps1 < math.inf and eps1 == ref.epsilon("nA")
    BUDGETS.record("nA", clip_norm=1.0, noise_multiplier=1.0, dp_steps=50)
    assert BUDGETS.epsilon("nA") > eps1  # composition is monotone
    vals = {lbl["node"]: c.value for lbl, c in REGISTRY.get("p2pfl_privacy_epsilon").samples()}
    assert vals["nA"] == pytest.approx(BUDGETS.epsilon("nA"))
    steps = {lbl["node"]: c.value for lbl, c in REGISTRY.get("p2pfl_privacy_dp_steps_total").samples()}
    assert steps["nA"] == 100
    BUDGETS.record("nA", clip_norm=0.0, noise_multiplier=0.0, nonprivate_steps=1)
    assert BUDGETS.epsilon("nA") == math.inf
    assert wire_epsilon(BUDGETS.epsilon("nA")) == -1.0
    assert wire_epsilon(0.0) == 0.0 and wire_epsilon(2.5) == 2.5


def test_digest_carries_epsilon():
    from p2pfl_tpu_torch.telemetry import digest as dig

    BUDGETS.record("nB", clip_norm=1.0, noise_multiplier=2.0, dp_steps=10)
    d = dig.collect("nB")
    assert d.dp_epsilon == pytest.approx(wire_epsilon(BUDGETS.epsilon("nB")))
    assert dig.decode(d.encode()).dp_epsilon == pytest.approx(d.dp_epsilon)
    legacy = dig.decode('{"node":"old","v":1}')
    assert legacy is not None and legacy.dp_epsilon is None
    silent = dig.collect("never-reported-dp")
    assert silent.dp_epsilon is None
    assert '"dp_epsilon"' not in silent.encode()
    assert dig.decode(silent.encode()).dp_epsilon is None


def test_learner_fit_records_its_steps_in_the_budget():
    """``TorchLearner.fit`` records every fit: DP steps with their clip and
    noise, non-private steps as a voided claim."""
    from p2pfl_tpu_torch.learning.dataset import RandomIIDPartitionStrategy, synthetic_mnist
    from p2pfl_tpu_torch.learning.learner import TorchLearner
    from p2pfl_tpu_torch.models.mlp import mlp_model

    part = synthetic_mnist(n_train=64, n_test=16).generate_partitions(1, RandomIIDPartitionStrategy)[0]
    dp = TorchLearner(mlp_model(seed=0, device="cpu"), part, "dp-node", batch_size=32, dp_clip_norm=8.0,
                      dp_noise_multiplier=0.5, seed=None, device="cpu")
    dp.fit()
    assert 0 < BUDGETS.epsilon("dp-node") < math.inf
    assert BUDGETS.spent("dp-node")["steps"] == dp._dp_total_steps > 0
    assert BUDGETS.epsilon("dp-node") == pytest.approx(dp.privacy_spent(Settings.PRIVACY_DELTA)["epsilon"])
    plain = TorchLearner(mlp_model(seed=0, device="cpu"), part, "plain-node", batch_size=32, device="cpu")
    plain.fit()
    assert BUDGETS.epsilon("plain-node") == math.inf


# --- wire overhead -----------------------------------------------------------------------------


def test_masked_wire_overhead_within_bound():
    """A masked frame costs <= 1.15x the top-k int8 frame of the same model
    at the same ratio: the shared support ships no index bytes."""
    from p2pfl_tpu_torch.comm.delta import DeltaWireCodec
    from p2pfl_tpu_torch.models.mlp import mlp_model

    anchor_model = mlp_model(seed=1, device="cpu")
    anchor = [_np(t) for t in anchor_model.get_parameters()]
    rng = np.random.default_rng(1)
    model = anchor_model.build_copy(params=[x + rng.normal(scale=1e-3, size=x.shape).astype(np.float32)
                                            for x in anchor], contributors=["n0"], num_samples=8)
    addrs, planes, _, _, _ = _federation(3)
    with Settings.overridden(WIRE_COMPRESSION="topk", WIRE_TOPK_RATIO=Settings.PRIVACY_MASK_RATIO,
                             WIRE_TOPK_VALUES="int8", COALESCE_ENABLED=True):
        codec = DeltaWireCodec("n0", device="cpu")
        codec.set_anchor(anchor, 2)
        tagged = codec.encode_tagged(model, 2)
        assert tagged is not None
        topk_bytes = len(tagged[0])
        masked_bytes = len(PrivacyPlane.encode_frame(planes[addrs[0]].mask_own(model, anchor, 2, addrs)))
    assert masked_bytes <= 1.15 * topk_bytes, (masked_bytes, topk_bytes)


# --- chaos, ledger, parity exemption ------------------------------------------------------------


def test_plan_masker_dropout_deterministic():
    from p2pfl_tpu_torch.chaos import CHAOS

    nodes = [f"mem://n{i}" for i in range(5)]
    a = CHAOS.plan_masker_dropout(4, nodes, seed=9, drop_round=1)
    assert a == CHAOS.plan_masker_dropout(4, nodes, seed=9, drop_round=1) and len(a) == 1
    assert a[0].kind == "crash" and a[0].node in nodes and a[0].when == 1
    assert CHAOS.plan_masker_dropout(4, nodes, seed=10, drop_round=1)[0].node in nodes
    assert CHAOS.plan_masker_dropout(4, [], seed=9) == ()
    assert CHAOS.plan_masker_dropout(2, nodes, seed=9, drop_round=5) == ()


def test_privacy_masked_kind_ranked_and_not_in_trajectory():
    from p2pfl_tpu_torch.telemetry.ledger import KIND_RANK, TRAJECTORY_KINDS

    assert "privacy_masked" in KIND_RANK
    assert "privacy_masked" not in TRAJECTORY_KINDS  # masked rounds are exempt from the parity gate


def test_parity_negative_control_masked_vs_plain_hashes_differ():
    """The masked aggregate (unit weights, lattice) is not plaintext FedAvg's,
    so the two ledgers must diverge: why masked runs are exempt from the
    parity gate."""
    from p2pfl_tpu_torch.ops import aggregation as agg_ops
    from p2pfl_tpu_torch.telemetry.ledger import canonical_params_hash

    addrs, planes, anchor, models, r = _federation(3)
    agg = MaskedFedAvg()
    agg.set_addr(addrs[0])
    out, outcome = planes[addrs[0]].finalize(agg.aggregate(_encode_all(planes, models, anchor, addrs, r, True)),
                                             addrs, anchor)
    assert outcome == "ok"
    stacked = agg_ops.tree_stack([{str(i): torch.from_numpy(p) for i, p in enumerate(models[a].params)}
                                  for a in addrs])
    plain = agg_ops.fedavg(stacked, torch.tensor([models[a].num_samples for a in addrs], dtype=torch.float32))
    assert canonical_params_hash([_np(t) for t in out]) != canonical_params_hash(
        [plain[str(i)].numpy() for i in range(len(anchor))])


# --- the port against the JAX package, byte for byte ------------------------------------------


def test_keys_secrets_supports_and_streams_equal_the_reference():
    for i, priv in enumerate(PRIVATE[:3]):
        assert PairwiseMasker(f"n{i}", _private=priv).public_key_hex() == \
            ref_masking.PairwiseMasker(f"n{i}", _private=priv).public_key_hex()
    port = [PairwiseMasker(f"n{i}", _private=PRIVATE[i]) for i in range(2)]
    ref = [ref_masking.PairwiseMasker(f"n{i}", _private=PRIVATE[i]) for i in range(2)]
    for ms in (port, ref):
        ms[0].learn_key("n1", ms[1].public_key_hex())
        ms[1].learn_key("n0", ms[0].public_key_hex())
    assert port[0].pair_secret("n1") == ref[0].pair_secret("n1") == ref[1].pair_secret("n0")
    for r in (0, 1, 7, -1):
        assert round_secret(port[0].pair_secret("n1"), r) == ref_masking.round_secret(ref[0].pair_secret("n1"), r)
    for r, t, size, ratio in ((0, 0, 1000, 0.1), (3, 5, 77, 0.1), (2, 1, 4096, 0.37), (9, 0, 1, 0.1)):
        assert np.array_equal(shared_support(r, t, size, ratio), ref_masking.shared_support(r, t, size, ratio))
    sec = port[0].pair_round_secret("n1", 4)
    for bits in (12, 16, 32):
        s = PairwiseMasker.stream(sec, 2, 513, bits)
        assert s.dtype == ring_dtype(bits)
        assert np.array_equal(s, ref_masking.PairwiseMasker.stream(sec, 2, 513, bits))
        for owner, peer in (("n0", "n1"), ("n1", "n0")):
            assert np.array_equal(signed_share(sec, owner, peer, 1, 65, bits),
                                  ref_masking.signed_share(sec, owner, peer, 1, 65, bits))
        assert np.array_equal(port[0].total_mask(["n0", "n1"], 4, 3, 33, bits),
                              ref[0].total_mask(["n0", "n1"], 4, 3, 33, bits))
    assert port[0].export_state() == ref[0].export_state()


@pytest.mark.parametrize("bits", [12, 16, 32])
def test_packed_planes_equal_the_reference(bits):
    rng = np.random.default_rng(bits)
    for k in (1, 2, 7, 64, 1001):
        v = rng.integers(0, 1 << bits, size=k, dtype=np.uint64).astype(ring_dtype(bits))
        packed = masking.pack_ring(v, bits)
        assert packed.tobytes() == ref_masking.pack_ring(v, bits).tobytes()
        assert np.array_equal(masking.unpack_ring(packed, k, bits), ref_masking.unpack_ring(packed, k, bits))
        assert np.array_equal(masking.center_ring(v, bits), ref_masking.center_ring(v, bits))
    assert masking.lattice_qmax(bits, 3) == ref_masking.lattice_qmax(bits, 3)


@pytest.mark.parametrize("bits", [12, 16, 32])
@pytest.mark.parametrize("mask", [True, False], ids=["masked", "maskless"])
def test_mask_own_frames_and_finalize_equal_the_reference(bits, mask):
    """Fixed keys, the same leaves and anchor: every node's lattice, residual
    and frame bytes equal the JAX package's over two rounds of error
    feedback (a NaN and an inf in one leaf, a leaf past the clamp), and the
    finalized parameters are the same bits."""
    with Settings.overridden(PRIVACY_RING_BITS=bits), RefSettings.overridden(PRIVACY_RING_BITS=bits):
        addrs, planes, anchor, models, r = _federation(3, fixed_keys=True)
        raddrs, rplanes, ranchor, rmodels, _ = _ref_federation(3)
        for mdl in (models, rmodels):
            mdl[addrs[1]].params[0][0, :3] = [np.nan, np.inf, 3.0]  # non-finite and past the clamp
        agg, ragg = MaskedFedAvg(), RefMaskedFedAvg()
        agg.set_addr(addrs[0])
        ragg.set_addr(addrs[0])
        for rnd in (r, r + 1):
            handles = [planes[a].mask_own(models[a], anchor, rnd, addrs, mask=mask) for a in addrs]
            rhandles = [rplanes[a].mask_own(rmodels[a], ranchor, rnd, raddrs, mask=mask) for a in raddrs]
            for a, h, rh in zip(addrs, handles, rhandles):
                assert h.additional_info == rh.additional_info
                for x, y in zip(h.get_parameters(), rh.get_parameters()):
                    assert x.dtype == y.dtype and np.array_equal(x, y)
                for x, y in zip(planes[a].residual(), rplanes[a]._residual):
                    assert _np(x).tobytes() == y.tobytes()
                assert PrivacyPlane.encode_frame(h) == RefPlane.encode_frame(rh)
            out, outcome = planes[addrs[0]].finalize(agg.aggregate(handles), addrs, anchor, anchor_round=rnd)
            rout, routcome = rplanes[addrs[0]].finalize(ragg.aggregate(rhandles), raddrs, ranchor, anchor_round=rnd)
            assert outcome == routcome == "ok"
            for x, y in zip(out, rout):
                assert x.dtype == torch.float32 and _np(x).tobytes() == y.tobytes()


def test_reference_frames_parse_and_merge_in_the_port():
    """A JAX-package node's masked frame decodes in the port (and the other
    way round) to the same lattice, so a mixed committee's masks cancel."""
    from p2pfl_tpu.ops.serialization import deserialize_arrays as ref_deserialize
    from p2pfl_tpu_torch.ops.serialization import deserialize_arrays

    addrs, planes, anchor, models, r = _federation(2, fixed_keys=True)
    raddrs, rplanes, ranchor, rmodels, _ = _ref_federation(2)
    port_frame = PrivacyPlane.encode_frame(planes[addrs[0]].mask_own(models[addrs[0]], anchor, r, addrs))
    ref_frame = RefPlane.encode_frame(rplanes[raddrs[1]].mask_own(rmodels[raddrs[1]], ranchor, r, raddrs))
    lat_port = PrivacyPlane.parse_frame(*deserialize_arrays(ref_frame))
    lat_ref = RefPlane.parse_frame(*ref_deserialize(port_frame))
    arrays, meta = deserialize_arrays(port_frame)
    mixed = [PrivacyPlane.handle_from_frame(PrivacyPlane.parse_frame(arrays, meta), meta, [addrs[0]], 10),
             PrivacyPlane.handle_from_frame(lat_port, deserialize_arrays(ref_frame)[1], [raddrs[1]], 11)]
    agg = MaskedFedAvg()
    agg.set_addr(addrs[0])
    out, outcome = planes[addrs[0]].finalize(agg.aggregate(mixed), addrs, anchor)
    assert outcome == "ok"
    maskless = _encode_all(planes, models, anchor, addrs, r, False)
    want, _ = planes[addrs[0]].finalize(agg.aggregate(maskless), addrs, anchor)
    for x, y in zip(out, want):
        assert torch.equal(x, y)
    assert all(x.dtype == ring_dtype(Settings.PRIVACY_RING_BITS) for x in lat_ref)


# --- settings -----------------------------------------------------------------------------------

PRIVACY_FIELDS = ("PRIVACY_SECAGG", "PRIVACY_MASK_RATIO", "PRIVACY_RING_BITS", "PRIVACY_VALUE_RANGE",
                  "PRIVACY_RANGE_MULT", "PRIVACY_MAX_COMMITTEE", "PRIVACY_KEY_WAIT_S", "PRIVACY_DP_CLIP",
                  "PRIVACY_DP_SIGMA", "PRIVACY_DELTA")


def test_privacy_settings_match_reference_defaults_and_bounds():
    """Every ``PRIVACY_*`` setting has the reference's default, parses the
    same environment values to the same value, and rejects the same ones
    (the ring width only as 12, 16 or 32)."""
    cases = [[name, raw] for name in PRIVACY_FIELDS for raw in RAW_VALUES]
    env = {k: v for k, v in os.environ.items() if not k.startswith("P2PFL_TPU_")}
    outs = {}
    for module in ("p2pfl_tpu_torch.config", "p2pfl_tpu.config"):
        proc = subprocess.run([sys.executable, "-c", SETTINGS_PROBE, module, json.dumps(cases)], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=240)
        assert proc.returncode == 0, proc.stderr[-2000:]
        outs[module] = json.loads(proc.stdout.strip().splitlines()[-1])
    assert outs["p2pfl_tpu_torch.config"] == outs["p2pfl_tpu.config"]
    by_case = dict(zip(map(tuple, cases), outs["p2pfl_tpu_torch.config"]))
    assert by_case[("PRIVACY_RING_BITS", "16")] == ["ok", "16"]
    assert by_case[("PRIVACY_RING_BITS", "17")][0] == "ValueError"
    assert all(by_case[(name, None)][0] == "ok" for name in PRIVACY_FIELDS)
