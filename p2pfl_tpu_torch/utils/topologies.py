"""Network topology construction.

Parity with reference p2pfl/utils/topologies.py:30-93 (STAR / FULL / LINE /
RING adjacency + connect), extended with GRID and ERDOS_RENYI which are useful
for larger gossip simulations.

The port's copy of ``p2pfl_tpu/utils/topologies.py``.
"""

from __future__ import annotations

import enum
from typing import TYPE_CHECKING, List, Sequence

import numpy as np

if TYPE_CHECKING:  # pragma: no cover
    from p2pfl_tpu_torch.node import Node


class TopologyType(enum.Enum):
    STAR = "star"
    FULL = "full"
    LINE = "line"
    RING = "ring"
    GRID = "grid"
    ERDOS_RENYI = "erdos_renyi"


class TopologyFactory:
    """Build adjacency matrices and wire up nodes accordingly."""

    @staticmethod
    def generate_matrix(
        topology: TopologyType, n: int, *, p: float = 0.3, seed: int = 0
    ) -> np.ndarray:
        """Symmetric 0/1 adjacency matrix with empty diagonal."""
        adj = np.zeros((n, n), dtype=np.int8)
        if n <= 1:
            return adj
        if topology == TopologyType.STAR:
            adj[0, 1:] = 1
            adj[1:, 0] = 1
        elif topology == TopologyType.FULL:
            adj[:] = 1
            np.fill_diagonal(adj, 0)
        elif topology == TopologyType.LINE:
            idx = np.arange(n - 1)
            adj[idx, idx + 1] = 1
            adj[idx + 1, idx] = 1
        elif topology == TopologyType.RING:
            idx = np.arange(n)
            nxt = (idx + 1) % n
            adj[idx, nxt] = 1
            adj[nxt, idx] = 1
        elif topology == TopologyType.GRID:
            side = int(np.ceil(np.sqrt(n)))
            for i in range(n):
                r, c = divmod(i, side)
                for rr, cc in ((r + 1, c), (r, c + 1)):
                    j = rr * side + cc
                    if rr < side and cc < side and j < n:
                        adj[i, j] = adj[j, i] = 1
        elif topology == TopologyType.ERDOS_RENYI:
            rng = np.random.default_rng(seed)
            upper = rng.random((n, n)) < p
            adj = np.triu(upper, 1).astype(np.int8)
            adj = adj | adj.T
            # Guarantee connectivity with a ring backbone.
            idx = np.arange(n)
            nxt = (idx + 1) % n
            adj[idx, nxt] = 1
            adj[nxt, idx] = 1
        else:  # pragma: no cover
            raise ValueError(f"unknown topology {topology}")
        return adj

    @staticmethod
    def connect_nodes(matrix: np.ndarray, nodes: Sequence["Node"]) -> None:
        """Connect each pair (i<j) with matrix[i,j]==1 via node.connect."""
        n = len(nodes)
        for i in range(n):
            for j in range(i + 1, n):
                if matrix[i, j]:
                    nodes[i].connect(nodes[j].addr)

    @staticmethod
    def neighbors_of(matrix: np.ndarray, i: int) -> List[int]:
        return [int(j) for j in np.nonzero(matrix[i])[0]]
