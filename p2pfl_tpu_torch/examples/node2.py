"""Two-process gRPC quickstart, process 2 (the port's copy of
``p2pfl_tpu/examples/node2.py``).

Connects to node1 at 127.0.0.1:6666 and takes part in the experiment it
starts. Run ``python -m p2pfl_tpu_torch.examples.node1`` first.
``--device cuda`` (the default) trains on the card and fails without one;
``--device cpu`` trains on the CPU.
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="p2pfl-tpu-torch experiment run node2", description=__doc__)
    p.add_argument("--peer", default="127.0.0.1:6666", help="node1's address")
    p.add_argument("--wait", type=float, default=600.0, help="start-of-learning timeout (s)")
    p.add_argument("--device", default="cuda", help="where the node trains (cuda or cpu)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from p2pfl_tpu_torch.comm.grpc.grpc_protocol import GrpcCommunicationProtocol
    from p2pfl_tpu_torch.learning.dataset import RandomIIDPartitionStrategy, synthetic_mnist
    from p2pfl_tpu_torch.models.mlp import mlp_model
    from p2pfl_tpu_torch.node import Node

    data = synthetic_mnist(n_train=600, n_test=256)
    part = data.generate_partitions(2, RandomIIDPartitionStrategy)[1]
    node = Node(mlp_model(seed=0, device=args.device), part, addr="127.0.0.1", protocol=GrpcCommunicationProtocol,
                device=args.device)
    node.start()
    if not node.connect(args.peer):
        print(f"could not connect to {args.peer}; is node1 running?", file=sys.stderr)
        node.stop()
        return 1
    print(f"node2 up at {node.addr}, connected to {args.peer}", flush=True)
    try:
        # Wait (bounded) for node1 to kick off learning, then for it to end.
        deadline = time.time() + args.wait
        while not node.learning_in_progress():
            if time.time() > deadline:
                print("node1 never started learning", file=sys.stderr)
                return 1
            time.sleep(0.5)
        node.wait_learning_finished(timeout=600)
        print("done:", node.learner.evaluate(), flush=True)
    finally:
        node.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
