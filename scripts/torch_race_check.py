"""The port's race-check: the runtime lock-order sentinel over a real
federation round of port Nodes.

Phase 1 — a 3-node in-memory federation of PyTorch port Nodes runs one
chaos-enabled round (5% injected drop) with EVERY lock created by the port
wrapped in the sentinel's instrumented lock; the observed acquisition graph
must be acyclic (no two code paths ever disagreed on lock order at
runtime).

Phase 2 — negative control: a deliberate lock-order inversion is executed
under the same sentinel and MUST be detected as a cycle, proving the gate
can actually fail.

Exit 0 when both phases pass; nonzero with a reason on stderr otherwise.
The Nodes train on the card; ``--device cpu`` runs them on the host::

    python scripts/torch_race_check.py --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import threading  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402,F401  (import BEFORE patching: torch's own locks stay raw)

from p2pfl_tpu_torch.analysis.runtime import SENTINEL  # noqa: E402

ROUNDS = 1
WALL_BUDGET_S = 60.0


def _run_round(device: str) -> int:
    from p2pfl_tpu_torch.chaos import CHAOS
    from p2pfl_tpu_torch.comm.memory.registry import InMemoryRegistry
    from p2pfl_tpu_torch.config import Settings
    from p2pfl_tpu_torch.learning.dataset import RandomIIDPartitionStrategy, synthetic_mnist
    from p2pfl_tpu_torch.models.mlp import mlp_model
    from p2pfl_tpu_torch.node import Node
    from p2pfl_tpu_torch.telemetry import REGISTRY
    from p2pfl_tpu_torch.utils.utils import set_test_settings, wait_convergence

    set_test_settings()
    Settings.RESOURCE_MONITOR_PERIOD = 0
    Settings.LOG_LEVEL = "WARNING"
    Settings.TRAIN_SET_SIZE = 3
    REGISTRY.reset()

    n = 3
    data = synthetic_mnist(n_train=96 * n, n_test=64)
    parts = data.generate_partitions(n, RandomIIDPartitionStrategy)
    with CHAOS.overridden(seed=42, drop_rate=0.05):
        nodes = [Node(mlp_model(seed=i, device=device), parts[i], batch_size=32, device=device)
                 for i in range(n)]
        for nd in nodes:
            nd.start()
        try:
            for i in range(1, n):
                nodes[i].connect(nodes[0].addr)
            wait_convergence(nodes, n - 1, wait=15)
            nodes[0].set_start_learning(rounds=ROUNDS, epochs=1)
            deadline = time.monotonic() + WALL_BUDGET_S
            while time.monotonic() < deadline:
                if all(
                    not nd.learning_in_progress()
                    and nd.learning_workflow is not None
                    for nd in nodes
                ):
                    break
                time.sleep(0.2)
            else:
                print("FAIL: round did not finish in budget", file=sys.stderr)
                return 1
        finally:
            for nd in nodes:
                nd.stop()
            InMemoryRegistry.reset()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device of the Nodes (default: cuda)")
    device = ap.parse_args(argv).device
    # Phase 1: real round, every framework lock instrumented. The node/comm
    # modules import lazily INSIDE the patch so module-level locks (registry,
    # chaos plane, logger) are wrapped too.
    with SENTINEL.patched():
        rc = _run_round(device)
        if rc != 0:
            return rc
        stats = SENTINEL.stats()
        cycle = SENTINEL.find_cycle()
        if cycle is not None:
            print(
                "FAIL: runtime lock-order cycle observed: " + " -> ".join(cycle),
                file=sys.stderr,
            )
            return 1
        if stats["edges"] == 0:
            print(
                "FAIL: sentinel recorded no nested acquisitions — "
                "instrumentation is not wired",
                file=sys.stderr,
            )
            return 1

        # Phase 2: deliberate inversion under the SAME sentinel must be
        # caught (the gate can fail). Sequential, so it records the cycle
        # without actually deadlocking this process. Separate lines on
        # purpose: the sentinel groups locks into lockdep-style classes by
        # creation site, and one line would make a and b one class.
        a = threading.Lock()
        b = threading.Lock()
        with a:
            with b:
                pass
        with b:
            with a:
                pass
        if SENTINEL.find_cycle() is None:
            print(
                "FAIL: deliberate inversion was not detected as a cycle",
                file=sys.stderr,
            )
            return 1

    print(
        f"race-check OK: {ROUNDS}-round 3-node chaos federation on {device} acyclic over "
        f"{stats['locks']} instrumented locks / {stats['edges']} order edges; "
        "deliberate inversion detected"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
