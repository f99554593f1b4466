"""Crash-restart outcomes of a three-Node federation, in either package, on
the CPU.

    python scripts/torch_crash_resume.py --package port --delay 0
    python scripts/torch_crash_resume.py --package jax --delay 3 --agg-timeout 20

Three in-memory Nodes (MLPs, ``CanonicalFedAvg``, committee 3, dense frames,
the test timings of ``set_test_settings``) run ``--rounds`` rounds with a
journal each. Once node 2 has journaled it crashes, stays down ``--delay``
seconds, and comes back through ``Node.resume`` / ``start`` /
``resume_learning``. Prints the seconds to the end, the resumed Node's
stage history, whether the three final parameter sets are equal, and per
node the hashes its ledger committed beside its final parameters' hash.

What it showed (the port and the JAX package alike): a restart quicker than
the fleet's round folds the resumed Node back in (the three final sets
equal); a slower one lets the fleet close the round it sits out, and it
finishes the experiment on its own trajectory.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("port", "jax"), default="port")
    ap.add_argument("--delay", type=float, default=0.0, help="seconds node 2 stays down")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--agg-timeout", type=float, default=20.0, help="AGGREGATION_TIMEOUT (stall patience: half)")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    if args.package == "jax":
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")
        from p2pfl_tpu.config import Settings
        from p2pfl_tpu.learning.aggregators.fedavg import CanonicalFedAvg
        from p2pfl_tpu.learning.dataset import RandomIIDPartitionStrategy, synthetic_mnist
        from p2pfl_tpu.management.checkpoint import NodeJournal, attach_node_journal
        from p2pfl_tpu.models import mlp_model
        from p2pfl_tpu.node import Node
        from p2pfl_tpu.telemetry.ledger import LEDGERS, canonical_params_hash
        from p2pfl_tpu.utils.utils import set_test_settings, wait_convergence

        def model(seed):
            return mlp_model(seed=seed)

        node_kw = {}
    else:
        import torch

        torch.set_num_threads(1)
        from p2pfl_tpu_torch.config import Settings
        from p2pfl_tpu_torch.learning.aggregators import CanonicalFedAvg
        from p2pfl_tpu_torch.learning.dataset import RandomIIDPartitionStrategy, synthetic_mnist
        from p2pfl_tpu_torch.management.checkpoint import NodeJournal, attach_node_journal
        from p2pfl_tpu_torch.models.mlp import mlp_model
        from p2pfl_tpu_torch.node import Node
        from p2pfl_tpu_torch.telemetry.ledger import LEDGERS, canonical_params_hash
        from p2pfl_tpu_torch.utils.utils import set_test_settings, wait_convergence

        def model(seed):
            return mlp_model(seed=seed, device="cpu")

        node_kw = {"device": "cpu"}

    set_test_settings()
    Settings.LOG_LEVEL = "WARNING"
    Settings.RESOURCE_MONITOR_PERIOD = 0
    Settings.LEDGER_ENABLED = True
    Settings.TRAIN_SET_SIZE = 3
    Settings.WIRE_COMPRESSION = "none"
    Settings.AGGREGATION_TIMEOUT = args.agg_timeout
    Settings.AGGREGATION_STALL_PATIENCE = args.agg_timeout / 2
    Settings.GOSSIP_EXIT_ON_X_EQUAL_ROUNDS = 400
    Settings.GOSSIP_MODELS_PER_ROUND = 3
    n = 3
    parts = synthetic_mnist(n_train=128 * n, n_test=64).generate_partitions(n, RandomIIDPartitionStrategy)
    root = tempfile.mkdtemp(prefix="crash_resume_")
    os.chdir(root)  # flight-recorder dumps land here

    def kw():
        return dict(aggregator=CanonicalFedAvg(), batch_size=32, **node_kw)

    nodes = [Node(model(0), parts[i], addr=f"mem://c{i}", **kw()) for i in range(n)]
    journals = [NodeJournal(os.path.join(root, f"j{i}")) for i in range(n)]
    for nd, journal in zip(nodes, journals):
        attach_node_journal(nd, journal)
        nd.start()
    for i, nd in enumerate(nodes):
        for other in nodes[i + 1:]:
            nd.connect(other.addr)
    wait_convergence(nodes, n - 1, wait=15)
    LEDGERS.reset()
    t0 = time.time()
    nodes[0].set_start_learning(rounds=args.rounds, epochs=1)
    while not journals[2].all_steps():
        time.sleep(0.01)
    nodes[2].crash()
    journals[2].wait()
    time.sleep(args.delay)
    resumed = Node.resume(model(99), parts[2], journals[2], **kw())
    resumed.start()
    resumed.resume_learning()
    nodes[2] = resumed
    while not all(not nd.learning_in_progress() and nd.learning_workflow is not None for nd in nodes):
        time.sleep(0.02)
    print(f"package {args.package}, delay {args.delay} s: finished in {time.time() - t0:.1f} s")
    print(f"resumed history {resumed.learning_workflow.history}")
    finals = [canonical_params_hash(nd.learner.get_model().get_parameters()) for nd in nodes]
    print(f"three final parameter sets equal: {len(set(finals)) == 1}")
    for nd, final in zip(nodes, finals):
        commits = [(e["round"], e["hash"][:15]) for e in LEDGERS.peek(nd.addr).canonical_events()
                   if e["kind"] == "aggregate_committed"]
        print(f"{nd.addr}: committed {commits}; final {final[:15]}; final is the last commit: "
              f"{bool(commits) and final[:15] == commits[-1][1]}")
    for nd in nodes:
        nd.stop()
    for journal in journals:
        journal.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
