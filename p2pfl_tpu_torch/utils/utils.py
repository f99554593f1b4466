"""Experiment-control helpers.

Parity with reference p2pfl/utils/utils.py:24-145: shrink timeouts for tests,
wait for membership convergence, wait for training to finish, and compare
models across nodes.

The port's copy of ``p2pfl_tpu/utils/utils.py``.
"""

from __future__ import annotations

import time
from typing import TYPE_CHECKING, Sequence

import numpy as np
import torch

from p2pfl_tpu_torch.config import Settings

if TYPE_CHECKING:  # pragma: no cover
    from p2pfl_tpu_torch.node import Node


def set_test_settings() -> None:
    """Shrink every timeout so multi-node tests run fast in one process.

    Mirrors reference utils/utils.py:24-40.
    """
    Settings.GRPC_TIMEOUT = 0.5
    Settings.HEARTBEAT_PERIOD = 0.25
    Settings.HEARTBEAT_TIMEOUT = 1.5
    Settings.WAIT_HEARTBEATS_CONVERGENCE = 0.3
    Settings.GOSSIP_PERIOD = 0.05
    Settings.TTL = 10
    Settings.GOSSIP_MESSAGES_PER_PERIOD = 100
    Settings.GOSSIP_MODELS_PERIOD = 0.1
    Settings.GOSSIP_MODELS_PER_ROUND = 4
    Settings.GOSSIP_EXIT_ON_X_EQUAL_ROUNDS = 20
    Settings.GOSSIP_SEND_RETRIES = 2
    Settings.GOSSIP_SEND_BACKOFF = 0.05
    Settings.CHAOS_ENABLED = False  # chaos is opt-in per test/bench scope
    Settings.TRAIN_SET_SIZE = 4
    Settings.VOTE_TIMEOUT = 10.0
    Settings.AGGREGATION_TIMEOUT = 30.0
    # Well above clean-run fit variance (~1-2s fits), well below the timeout.
    Settings.AGGREGATION_STALL_PATIENCE = 8.0
    Settings.RESOURCE_MONITOR_PERIOD = 0.5
    Settings.LOG_LEVEL = "DEBUG"


def wait_convergence(
    nodes: Sequence["Node"],
    n_neis: int,
    *,
    only_direct: bool = False,
    wait: float = 5.0,
) -> None:
    """Block until every node sees ``n_neis`` neighbors (or raise)."""
    deadline = time.time() + wait
    while time.time() < deadline:
        if all(len(n.get_neighbors(only_direct=only_direct)) == n_neis for n in nodes):
            return
        time.sleep(0.05)
    counts = {n.addr: len(n.get_neighbors(only_direct=only_direct)) for n in nodes}
    raise TimeoutError(f"convergence not reached: {counts} (wanted {n_neis})")


def full_connection(node: "Node", others: Sequence["Node"]) -> None:
    """Connect ``node`` to every node in ``others``."""
    for other in others:
        node.connect(other.addr)


def wait_to_finish(nodes: Sequence["Node"], timeout: float = 3600.0) -> None:
    """Block until every node reports learning finished (or raise)."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        if all(not n.learning_in_progress() for n in nodes):
            return
        time.sleep(0.1)
    raise TimeoutError("learning did not finish in time")


def _host(a) -> np.ndarray:
    return a.detach().float().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def check_equal_models(nodes: Sequence["Node"], atol: float = 1e-1) -> None:
    """Assert all nodes hold (approximately) the same parameters.

    Mirrors reference utils/utils.py:119-145 (allclose, atol=1e-1).
    """
    ref_params = None
    for node in nodes:
        params = node.learner.get_model().get_parameters()
        if ref_params is None:
            ref_params = params
            continue
        assert len(params) == len(ref_params), "layer count mismatch"
        for a, b in zip(ref_params, params):
            assert a.shape == b.shape, f"shape mismatch {a.shape} vs {b.shape}"
            np.testing.assert_allclose(_host(a), _host(b), atol=atol)
