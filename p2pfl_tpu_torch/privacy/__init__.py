"""Privacy plane: committee secure aggregation + the DP-SGD budget (the
port's copy of ``p2pfl_tpu/privacy/``).

* :mod:`p2pfl_tpu_torch.privacy.masking` — pairwise mask algebra (DH key
  agreement, per-round PRG streams, the exactly-cancelling integer
  lattice), host code byte-equal to the JAX package's.
* :mod:`p2pfl_tpu_torch.privacy.secagg` — the per-node :class:`PrivacyPlane`
  (masked encode/finalize, repairs, journal round-trip); its full-size
  passes run on the node's device.
* :mod:`p2pfl_tpu_torch.privacy.budget` — the per-node RDP privacy-budget
  ledger surfaced through the digest and the observatory.
"""

from p2pfl_tpu_torch.privacy.budget import BUDGETS, PrivacyBudgetLedger, wire_epsilon
from p2pfl_tpu_torch.privacy.masking import (
    PairwiseMasker,
    center_ring,
    lattice_qmax,
    ring_dtype,
    round_secret,
    shared_support,
    signed_share,
)
from p2pfl_tpu_torch.privacy.secagg import (
    MASKED_INFO_KEY,
    MASKED_META_KEY,
    PrivacyPlane,
    masked_info,
)

__all__ = [
    "BUDGETS",
    "MASKED_INFO_KEY",
    "MASKED_META_KEY",
    "PairwiseMasker",
    "PrivacyBudgetLedger",
    "PrivacyPlane",
    "center_ring",
    "lattice_qmax",
    "masked_info",
    "ring_dtype",
    "round_secret",
    "shared_support",
    "signed_share",
    "wire_epsilon",
]
