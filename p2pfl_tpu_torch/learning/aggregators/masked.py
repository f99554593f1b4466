"""MaskedFedAvg — FedAvg whose round table can hold masked lattice frames
(the port's copy of ``p2pfl_tpu/learning/aggregators/masked.py``).

Masked lattice vectors are ADDITIVE mod the ring (that is the whole design
of :mod:`p2pfl_tpu_torch.privacy.secagg`), so the base aggregator's
machinery — contributor-set dedup, partial aggregation + re-gossip,
retired-round snapshots, death-shrunk expectations — works on masked
handles unchanged; only the combine step differs, and it sums numpy ring
vectors on the host. Plaintext handles (init frames, a node that could not
mask) still aggregate through the plain FedAvg kernel, but the two domains
never mix: a masked merge drops plaintext entries with a warning rather
than summing floats into a ring.

The UNMASKING is not here: ``aggregate`` returns the merged masked handle
(still lattice-domain) and the stage machine finalizes it through
:meth:`p2pfl_tpu_torch.privacy.secagg.PrivacyPlane.finalize` — the
aggregator stays a dumb accumulator, exactly like the plaintext path.
"""

from __future__ import annotations

import logging
from typing import List

import numpy as np

from p2pfl_tpu_torch.learning.aggregators.fedavg import FedAvg
from p2pfl_tpu_torch.models.model_handle import ModelHandle
from p2pfl_tpu_torch.privacy.secagg import MASKED_INFO_KEY, masked_info

log = logging.getLogger("p2pfl_tpu_torch")


class MaskedFedAvg(FedAvg):
    """FedAvg with a masked-lattice merge path (``PRIVACY_SECAGG``)."""

    partial_aggregation = True

    def aggregate(self, models: List[ModelHandle]) -> ModelHandle:
        masked = [m for m in models if masked_info(m) is not None]
        if not masked:
            return super().aggregate(models)
        if len(masked) != len(models):
            # Mixed round table: a plaintext float model cannot enter a ring
            # sum. Keep the masked majority (the protocol's domain) — the
            # dropped plaintext entry's sender keeps gossiping and will be
            # counted missing at finalize like any other absentee.
            log.warning(
                "(%s) dropping %d plaintext model(s) from a masked merge",
                self.node_addr, len(models) - len(masked),
            )
        infos = [masked_info(m) for m in masked]
        first = infos[0]
        same = [
            m for m, i in zip(masked, infos)
            if i["round"] == first["round"]
            and i["bits"] == first["bits"]
            and i["n"] == first["n"]
        ]
        if len(same) != len(masked):
            log.warning(
                "(%s) dropping %d masked frame(s) from another lattice "
                "generation", self.node_addr, len(masked) - len(same),
            )
        out = [np.asarray(a).copy() for a in same[0].get_parameters()]
        for m in same[1:]:
            for i, a in enumerate(m.get_parameters()):
                out[i] = (out[i] + np.asarray(a)).astype(out[i].dtype)
        contributors, total = self._merge_metadata(same)
        return ModelHandle(
            params=out,
            contributors=contributors,
            num_samples=total,
            additional_info={MASKED_INFO_KEY: dict(first)},
        )


__all__ = ["MaskedFedAvg"]
