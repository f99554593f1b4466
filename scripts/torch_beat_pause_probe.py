"""A process-wide beat silence right after round 0's vote, in a four-Node
federation of either package (or two of each), on the CPU.

    python scripts/torch_beat_pause_probe.py --package port
    python scripts/torch_beat_pause_probe.py --package jax
    python scripts/torch_beat_pause_probe.py --package mixed --heartbeat-timeout 30

Four in-memory Nodes (f32 MLPs with hidden (16, 8), ``CanonicalFedAvg``,
committee 4, dense frames, the test timings of ``set_test_settings`` with
the mixed federation test's gossip budget 400, stall patience 60 s and
aggregation timeout 120 s) run two rounds. The first fit of every Node
sleeps ``--fit-delay`` seconds first (a first compile), and once the first
Node has voted in round 0 every Node drops the beats it receives for
``--pause`` seconds: each Node writes off its live peers, as a loaded host
that stalls every beater at once makes them do. Prints each Node's
finished rounds, stage and round, and one ``RESULT`` line: whether all four
finished both rounds, and the seconds it took (at most ``--limit``).

What it showed (both packages alike, and mixed): with the 1.5 s
``HEARTBEAT_TIMEOUT`` the write-offs shrink each Node's committee and
aggregation expectation on its own; the heal does not restore them. A Node
that wrote off every peer closes round 0 alone and moves on, its peers still
expect its model, it never gossips it, and they sit out the stall patience:
no run finishes both rounds on all four inside the limit. With a liveness
timeout that outlasts the silence nobody is written off and all finish.
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("port", "jax", "mixed"), default="port")
    ap.add_argument("--pause", type=float, default=2.2, help="seconds every Node drops incoming beats")
    ap.add_argument("--fit-delay", type=float, default=3.0, help="seconds the first fit of each Node waits")
    ap.add_argument("--heartbeat-timeout", type=float, default=1.5, help="HEARTBEAT_TIMEOUT of both packages")
    ap.add_argument("--limit", type=float, default=90.0, help="seconds to wait for both rounds")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch

    torch.set_num_threads(1)
    from p2pfl_tpu.comm.heartbeater import Heartbeater as RefHeartbeater
    from p2pfl_tpu.comm.memory.registry import InMemoryRegistry as RefRegistry
    from p2pfl_tpu.config import Settings as RefSettings
    from p2pfl_tpu.learning.aggregators import CanonicalFedAvg as RefCanonicalFedAvg
    from p2pfl_tpu.learning.dataset import RandomIIDPartitionStrategy as RefIID
    from p2pfl_tpu.learning.dataset import synthetic_mnist as ref_mnist
    from p2pfl_tpu.models import mlp_model as ref_mlp
    from p2pfl_tpu.node import Node as RefNode
    from p2pfl_tpu.stages import base_node as ref_stages
    from p2pfl_tpu.utils.utils import set_test_settings as ref_test_settings
    from p2pfl_tpu_torch.comm.heartbeater import Heartbeater
    from p2pfl_tpu_torch.comm.memory.registry import InMemoryRegistry
    from p2pfl_tpu_torch.config import Settings
    from p2pfl_tpu_torch.learning.aggregators import CanonicalFedAvg
    from p2pfl_tpu_torch.learning.dataset import RandomIIDPartitionStrategy, synthetic_mnist
    from p2pfl_tpu_torch.models.mlp import mlp_model
    from p2pfl_tpu_torch.node import Node
    from p2pfl_tpu_torch.stages import base_node as stages
    from p2pfl_tpu_torch.utils.utils import set_test_settings

    ref_test_settings()
    set_test_settings()
    for s in (Settings, RefSettings):
        s.LOG_LEVEL = "WARNING"
        s.RESOURCE_MONITOR_PERIOD = 0
        s.COMPUTE_DTYPE = "float32"
        s.GOSSIP_EXIT_ON_X_EQUAL_ROUNDS = 400
        s.AGGREGATION_STALL_PATIENCE = 60.0
        s.AGGREGATION_TIMEOUT = 120.0
        s.HEARTBEAT_TIMEOUT = args.heartbeat_timeout
    # One wire for both packages (explicit addresses below).
    InMemoryRegistry._servers = RefRegistry._servers
    InMemoryRegistry._lock = RefRegistry._lock

    silence = {"until": 0.0, "armed": True}
    lock = threading.Lock()
    for cls in (Heartbeater, RefHeartbeater):
        def beat(self, source, timestamp, _beat=cls.beat):
            if time.monotonic() < silence["until"]:
                return None
            return _beat(self, source, timestamp)

        cls.beat = beat
    for mod in (stages, ref_stages):
        def execute(node, _execute=mod.VoteTrainSetStage.execute):
            out = _execute(node)
            with lock:
                if silence["armed"] and node.state.round == 0:
                    silence["armed"] = False
                    silence["until"] = time.monotonic() + args.pause
                    print(f"beats dropped for {args.pause} s after {node.addr}'s round-0 vote", flush=True)
            return out

        mod.VoteTrainSetStage.execute = staticmethod(execute)

    kinds = {"port": "pppp", "jax": "jjjj", "mixed": "pjpj"}[args.package]
    kw = dict(n_train=4 * 128, n_test=64)
    ref_parts = ref_mnist(**kw).generate_partitions(4, RefIID)
    parts = synthetic_mnist(**kw).generate_partitions(4, RandomIIDPartitionStrategy)
    nodes = []
    for i, kind in enumerate(kinds):
        addr = f"mem://pause-{args.package}-{kind}{i}"
        if kind == "p":
            node = Node(mlp_model(0, hidden_sizes=(16, 8), device="cpu"), parts[i], addr=addr,
                        aggregator=CanonicalFedAvg(), batch_size=32, lr=1e-3, seed=i, device="cpu")
        else:
            node = RefNode(ref_mlp(0, hidden_sizes=(16, 8)), ref_parts[i], addr=addr,
                           aggregator=RefCanonicalFedAvg(), batch_size=32, lr=1e-3, seed=i)
        fit, calls = node.learner.fit, [0]

        def first_fit_waits(*a, _fit=fit, _calls=calls, **k):
            _calls[0] += 1
            if _calls[0] == 1:
                time.sleep(args.fit_delay)
            return _fit(*a, **k)

        node.learner.fit = first_fit_waits
        nodes.append(node)
    try:
        for node in nodes:
            node.start()
        for node in nodes[1:]:
            node.connect(nodes[0].addr)
        t0 = time.time()
        while not all(len(n.get_neighbors()) == 3 for n in nodes) and time.time() - t0 < 15:
            time.sleep(0.05)
        nodes[0].set_start_learning(rounds=2, epochs=1)
        t0 = time.time()
        while time.time() - t0 < args.limit:
            if all(not n.learning_in_progress() and n.learning_workflow is not None for n in nodes):
                break
            time.sleep(0.1)
        seconds = time.time() - t0
        finished = []
        for node in nodes:
            history = node.learning_workflow.history if node.learning_workflow is not None else []
            finished.append(history.count("RoundFinishedStage"))
            print(f"{node.addr}: rounds finished {finished[-1]}, stage {node.state.current_stage!r}, "
                  f"round {node.state.round}", flush=True)
        ok = all(f == 2 for f in finished)
        print(f"RESULT package={args.package} pause={args.pause} heartbeat_timeout={args.heartbeat_timeout} "
              f"all_finished={ok} seconds={seconds:.1f}", flush=True)
    finally:
        for node in nodes:
            node.stop()
    os._exit(0)  # leftover daemon threads of stopped Nodes


if __name__ == "__main__":
    sys.exit(main())
