"""Pairwise mask algebra for committee-based secure aggregation (the port's
copy of ``p2pfl_tpu/privacy/masking.py``: numpy and the standard library,
host code whose keys, secrets, supports, streams and packed bytes equal the
JAX package's byte for byte, so a mixed federation's masks cancel).

The DisAgg insight (arxiv 2605.13708): secure aggregation does not need a
trusted server — an *aggregator committee* whose members exchange pairwise
masks can compute the sum of its updates without any member (or observer)
seeing an individual one. This federation already elects a per-round
committee by voting (the trainset), so the trust structure exists; this
module supplies the mask algebra that rides it.

Three layers, each exactly-cancelling by construction:

* **Key agreement** — each node mints a per-session finite-field
  Diffie-Hellman keypair (RFC 3526 group 14, stdlib ``pow`` — the
  ``cryptography`` package is optional in this image, so X25519 is not
  assumed) and broadcasts the public half on the gossip wire
  (``privacy_key``). A pair's shared secret is the SHA-256 of the DH shared
  value bound to the sorted pair, so both ends derive the same secret and
  no third party can.
* **Per-round mask streams** — the stream KDF is two-stage:
  ``round_secret = SHA256(pair_secret, round)`` scopes the pair secret to
  one round, and the per-tensor stream is a PRG seeded from
  ``SHA256(round_secret, tensor)``. The two-stage split is load-bearing
  for dropout repair: a survivor reveals ONLY the round-scoped secret
  (``privacy_repair``), which reconstructs the dead pair's masks for that
  round and nothing else — a wire observer who captures every reveal of
  round ``r`` learns nothing about any other round's streams, even when a
  crash-restarted masker resumes with the same journaled keypair. The
  lexicographically smaller address ADDS the stream, the larger SUBTRACTS
  it, so the pair's net contribution to any sum that contains both is the
  zero vector of the ring — exactly, in integer arithmetic, not to float
  epsilon.
* **Integer lattice** — masked values live in Z mod 2**PRIVACY_RING_BITS.
  Senders clamp (clipping-at-sender) and quantize their delta values onto
  a shared lattice; masks are uniform ring elements; sums wrap. Pairwise
  cancellation in a modular ring is exact, which is what makes masked
  FedAvg bit-exact with the same pipeline run maskless — the property the
  privacy tests (``tests/test_torch_privacy.py``) assert.

Threat model note: the PRG is numpy's PCG64 (fast, deterministic across
platforms), keyed from SHA-256-derived seeds. That defends the
honest-but-curious peer and the wire observer — the threat model of
``docs/components/privacy.md`` — not a cryptanalytic adversary; the seed
derivation is the single swap point for a crypto-grade stream.
"""

from __future__ import annotations

import hashlib
import secrets
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# RFC 3526 MODP group 14 (2048-bit) — stdlib-only DH. The generator is 2.
_MODP_P = int(
    "FFFFFFFFFFFFFFFFC90FDAA22168C234C4C6628B80DC1CD129024E088A67CC74"
    "020BBEA63B139B22514A08798E3404DDEF9519B3CD3A431B302B0A6DF25F1437"
    "4FE1356D6D51C245E485B576625E7EC6F44C42E9A637ED6B0BFF5CB6F406B7ED"
    "EE386BFB5A899FA5AE9F24117C4B1FE649286651ECE45B3DC2007CB8A163BF05"
    "98DA48361C55D39A69163FA8FD24CF5F83655D23DCA3AD961C62F356208552BB"
    "9ED529077096966D670C354E4ABC9804F1746C08CA18217C32905E462E36CE3B"
    "E39E772C180E86039B2783A2EC07A28FB5C55DF06F4C52C9DE2BCBF695581718"
    "3995497CEA956AE515D2261898FA051015728E5A8AACAA68FFFFFFFFFFFFFFFF",
    16,
)
_MODP_G = 2

#: Hex digits of a group-14 public key (2048 bits).
_PUBKEY_HEX_LEN = 512


def _sha(*parts: bytes) -> bytes:
    h = hashlib.sha256()
    for p in parts:
        h.update(len(p).to_bytes(4, "big"))
        h.update(p)
    return h.digest()


def _seed64(*parts: bytes) -> int:
    """Stable 64-bit PRG seed from hashed parts."""
    return int.from_bytes(_sha(*parts)[:8], "big")


def ring_dtype(bits: int) -> np.dtype:
    """Unsigned IN-MEMORY dtype of the masked lattice. For sub-word rings
    (12-bit) the carrier wraps mod 2**16, which is mod-2**12-consistent
    (4096 divides 65536): sums and pairwise cancellations reduce correctly
    at decode time via ``% ring``. The WIRE form of a 12-bit lattice is the
    packed two-values-per-three-bytes layout (:func:`pack_ring`)."""
    if bits <= 16:
        return np.dtype(np.uint16)
    return np.dtype(np.uint32)


def pack_ring(vals: np.ndarray, bits: int) -> np.ndarray:
    """Wire-pack lattice values. 12-bit rings pack two values into three
    bytes (values are reduced ``% ring`` first — in-memory carriers may
    hold unreduced mod-2**16 sums); wider rings ship their native bytes."""
    if bits != 12:
        return np.ascontiguousarray(vals, ring_dtype(bits)).view(np.uint8)
    v = (np.asarray(vals, np.uint32) % (1 << 12)).astype(np.uint16)
    if v.size % 2:
        v = np.concatenate([v, np.zeros(1, np.uint16)])
    a, b = v[0::2].astype(np.uint32), v[1::2].astype(np.uint32)
    out = np.empty(3 * a.size, np.uint8)
    out[0::3] = a & 0xFF
    out[1::3] = (a >> 8) | ((b & 0xF) << 4)
    out[2::3] = b >> 4
    return out


def unpack_ring(buf: np.ndarray, k: int, bits: int) -> np.ndarray:
    """Invert :func:`pack_ring` into ``k`` lattice values. Raises
    ``ValueError`` on a plane whose length disagrees with ``k`` — a hostile
    frame dies here before any value is summed."""
    buf = np.asarray(buf, np.uint8)
    dt = ring_dtype(bits)
    if bits != 12:
        if buf.size != k * dt.itemsize:
            raise ValueError("masked plane length disagrees with k")
        return buf.view(dt).copy()
    pairs = (k + 1) // 2
    if buf.size != 3 * pairs:
        raise ValueError("masked plane length disagrees with k")
    b0 = buf[0::3].astype(np.uint16)
    b1 = buf[1::3].astype(np.uint16)
    b2 = buf[2::3].astype(np.uint16)
    a = b0 | ((b1 & 0xF) << 8)
    b = (b1 >> 4) | (b2 << 4)
    out = np.empty(2 * pairs, np.uint16)
    out[0::2] = a
    out[1::2] = b
    return out[:k].copy()


#: Protocol constant (NOT a knob — both ends must derive the same lattice):
#: the honest committee sum is kept this factor inside the signed half of
#: the ring, so a mask share that failed to cancel — uniform over the ring —
#: lands OUTSIDE the honest bound with probability ~(1 - 1/HEADROOM) per
#: coordinate, and the committee-side range check (a max over the whole
#: support, so the per-frame miss probability is ~HEADROOM**-k) actually
#: bites. Without headroom the honest bound would span the whole ring and a
#: wrapped sum would be indistinguishable from a large honest one.
LATTICE_HEADROOM = 2


def lattice_qmax(bits: int, committee_size: int) -> int:
    """Largest per-sender lattice magnitude that keeps the committee sum
    decodable AND range-checkable: ``n * qmax * LATTICE_HEADROOM`` stays
    inside the signed half of the ring."""
    if committee_size < 1:
        raise ValueError("committee must be non-empty")
    qmax = ((1 << (bits - 1)) - 1) // (committee_size * LATTICE_HEADROOM)
    if qmax < 1:
        raise ValueError(
            f"ring of {bits} bits cannot carry a committee of "
            f"{committee_size} (qmax < 1) — raise PRIVACY_RING_BITS"
        )
    return qmax


def center_ring(acc: np.ndarray, bits: int) -> np.ndarray:
    """Reinterpret an unsigned mod-2**bits accumulator as the signed sum it
    encodes (valid while the true sum's magnitude < 2**(bits-1)). Reduces
    ``% ring`` first: sub-word rings ride wider unsigned carriers whose
    wrap (mod 2**16) is ring-consistent but leaves values unreduced."""
    ring = 1 << bits
    half = 1 << (bits - 1)
    a = acc.astype(np.int64) % ring
    return np.where(a >= half, a - ring, a)


def shared_support(
    round: int, tensor_idx: int, size: int, ratio: float
) -> np.ndarray:
    """Shared pseudorandom rand-k support for one tensor of one masked
    round — a pure function of PUBLIC state (round, tensor geometry,
    ratio), so every committee member derives the same indices and the
    wire ships none. Sorted int64 positions."""
    k = max(1, min(size, int(round_half_up(size * ratio))))
    seed = _seed64(
        b"p2pfl-privacy-support",
        int(round).to_bytes(8, "big", signed=True),
        int(tensor_idx).to_bytes(4, "big"),
        int(size).to_bytes(8, "big"),
        repr(float(ratio)).encode(),
    )
    rng = np.random.Generator(np.random.PCG64(seed))
    idx = rng.choice(size, size=k, replace=False)
    idx.sort()
    return idx.astype(np.int64)


def round_half_up(x: float) -> int:
    return int(np.floor(x + 0.5))


def round_secret(pair_secret: bytes, round: int) -> bytes:
    """Round-scoped derivation of a pair secret — the ONLY value the repair
    path ever puts on the wire. One-way: holding ``round_secret(s, r)``
    yields round ``r``'s mask streams and no other round's (the pair secret
    itself never leaves the two endpoints' memory/journal)."""
    return _sha(
        b"p2pfl-privacy-round",
        pair_secret,
        int(round).to_bytes(8, "big", signed=True),
    )


class PairwiseMasker:
    """One node's key material + mask generator.

    Owns the per-session DH keypair, learns peers' public keys from the
    ``privacy_key`` gossip, caches pair secrets, and renders per-round mask
    streams. Export/import round-trips through the node's journal so a
    crashed masker resumes with the same seeds (its re-sent masked frame
    cancels exactly like the lost one would have).
    """

    def __init__(self, addr: str, _private: Optional[int] = None) -> None:
        self.addr = addr
        self._private = (
            _private if _private is not None else secrets.randbits(256)
        )
        self._public = pow(_MODP_G, self._private, _MODP_P)
        self._peer_keys: Dict[str, int] = {}
        self._pair_secrets: Dict[str, bytes] = {}

    # --- key agreement -------------------------------------------------------

    def public_key_hex(self) -> str:
        return format(self._public, f"0{_PUBKEY_HEX_LEN}x")

    def learn_key(self, peer: str, pubkey_hex: str) -> bool:
        """Store ``peer``'s public key; returns True when it was new.
        Malformed keys are dropped (False) — an unparseable key must not
        wedge the handshake."""
        if peer == self.addr:
            return False
        try:
            pub = int(pubkey_hex, 16)
        except (TypeError, ValueError):
            return False
        if not 1 < pub < _MODP_P - 1:
            return False
        if self._peer_keys.get(peer) == pub:
            return False
        self._peer_keys[peer] = pub
        self._pair_secrets.pop(peer, None)
        return True

    def knows(self, peer: str) -> bool:
        return peer == self.addr or peer in self._peer_keys

    def known_peers(self) -> List[str]:
        return sorted(self._peer_keys)

    def pair_secret(self, peer: str) -> bytes:
        """Shared secret with ``peer`` (requires its public key)."""
        sec = self._pair_secrets.get(peer)
        if sec is not None:
            return sec
        pub = self._peer_keys.get(peer)
        if pub is None:
            raise KeyError(f"no public key for {peer}")
        shared = pow(pub, self._private, _MODP_P)
        a, b = sorted((self.addr, peer))
        sec = _sha(
            b"p2pfl-privacy-pair",
            shared.to_bytes((shared.bit_length() + 7) // 8 or 1, "big"),
            a.encode(),
            b.encode(),
        )
        self._pair_secrets[peer] = sec
        return sec

    # --- mask streams --------------------------------------------------------

    @staticmethod
    def stream(
        round_sec: bytes, tensor_idx: int, k: int, bits: int
    ) -> np.ndarray:
        """The pair's uniform ring-element stream for one tensor of the
        round baked into ``round_sec`` (:func:`round_secret`): both ends
        render the identical array from the shared secret."""
        seed = _seed64(
            b"p2pfl-privacy-mask",
            round_sec,
            int(tensor_idx).to_bytes(4, "big"),
        )
        rng = np.random.Generator(np.random.PCG64(seed))
        return rng.integers(0, 1 << bits, size=int(k), dtype=np.uint64).astype(
            ring_dtype(bits)
        )

    def pair_round_secret(self, peer: str, round: int) -> bytes:
        """Round-scoped pair secret with ``peer`` — the revealable form."""
        return round_secret(self.pair_secret(peer), round)

    def pair_share(
        self,
        peer: str,
        round: int,
        tensor_idx: int,
        k: int,
        bits: int,
        *,
        owner: Optional[str] = None,
    ) -> np.ndarray:
        """SIGNED mask share the pair member ``owner`` (default: self) adds
        for the pair (owner, peer): ``+stream`` when owner sorts first,
        ``-stream`` (mod ring) otherwise — so owner's and peer's shares sum
        to zero in the ring."""
        owner = owner or self.addr
        return signed_share(
            self.pair_round_secret(peer, round), owner, peer, tensor_idx, k, bits
        )

    def total_mask(
        self,
        committee: Sequence[str],
        round: int,
        tensor_idx: int,
        k: int,
        bits: int,
    ) -> np.ndarray:
        """Sum of this node's signed shares against every OTHER committee
        member — the vector added to its lattice values on the wire."""
        dt = ring_dtype(bits)
        acc = np.zeros(int(k), dt)
        for peer in committee:
            if peer == self.addr:
                continue
            acc = acc + self.pair_share(peer, round, tensor_idx, k, bits)
        return acc.astype(dt)

    # --- recovery journal round-trip ---------------------------------------------

    def export_state(self) -> Dict[str, str]:
        """Journalable key material: the session private key plus every
        learned peer key. Plaintext on disk — the same trust the journal
        already extends to model params; the threat model doc states it."""
        return {
            "private": format(self._private, "x"),
            "peers": {p: format(k, "x") for p, k in self._peer_keys.items()},
        }

    @classmethod
    def import_state(cls, addr: str, st: Dict) -> "PairwiseMasker":
        m = cls(addr, _private=int(st["private"], 16))
        for p, k in (st.get("peers") or {}).items():
            try:
                m._peer_keys[str(p)] = int(k, 16)
            except (TypeError, ValueError):
                continue
        return m


def signed_share(
    round_sec: bytes,
    owner: str,
    peer: str,
    tensor_idx: int,
    k: int,
    bits: int,
) -> np.ndarray:
    """Render the signed mask share ``owner`` contributes for the pair
    (owner, peer) from the ROUND-SCOPED secret (:func:`round_secret`) — the
    repair path: a survivor reveals its round-scoped secret with a dead
    masker (``privacy_repair``) and any aggregator reconstructs the share
    to subtract, without the dead peer and without learning any other
    round's streams."""
    stream = PairwiseMasker.stream(round_sec, tensor_idx, k, bits)
    if owner < peer:
        return stream
    dt = ring_dtype(bits)
    return (np.zeros_like(stream) - stream).astype(dt)


__all__ = [
    "LATTICE_HEADROOM",
    "PairwiseMasker",
    "center_ring",
    "lattice_qmax",
    "pack_ring",
    "ring_dtype",
    "round_secret",
    "shared_support",
    "signed_share",
    "unpack_ring",
]
