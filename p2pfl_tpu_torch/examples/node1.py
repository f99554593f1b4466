"""Two-process gRPC quickstart, process 1 (the port's copy of
``p2pfl_tpu/examples/node1.py``).

Starts a gRPC node on 127.0.0.1:6666, waits for node2 to connect, runs a
2-round experiment, then shuts down. Run
``python -m p2pfl_tpu_torch.examples.node2`` in another terminal.
``--device cuda`` (the default) trains on the card and fails without one;
``--device cpu`` trains on the CPU.
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="p2pfl-tpu-torch experiment run node1", description=__doc__)
    p.add_argument("--addr", default="127.0.0.1:6666", help="bind address")
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--wait", type=float, default=600.0, help="peer-wait timeout (s)")
    p.add_argument("--device", default="cuda", help="where the node trains (cuda or cpu)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from p2pfl_tpu_torch.comm.grpc.grpc_protocol import GrpcCommunicationProtocol
    from p2pfl_tpu_torch.learning.dataset import RandomIIDPartitionStrategy, synthetic_mnist
    from p2pfl_tpu_torch.models.mlp import mlp_model
    from p2pfl_tpu_torch.node import Node

    data = synthetic_mnist(n_train=600, n_test=256)
    part = data.generate_partitions(2, RandomIIDPartitionStrategy)[0]
    node = Node(mlp_model(seed=0, device=args.device), part, addr=args.addr, protocol=GrpcCommunicationProtocol,
                device=args.device)
    node.start()
    print(f"node1 up at {node.addr}; waiting for a peer...", flush=True)
    try:
        deadline = time.time() + args.wait
        while not node.get_neighbors():
            if time.time() > deadline:
                print("no peer connected in time", file=sys.stderr)
                return 1
            time.sleep(0.5)
        print(f"peer connected; starting {args.rounds}-round experiment", flush=True)
        node.set_start_learning(rounds=args.rounds, epochs=1)
        node.wait_learning_finished(timeout=600)
        print("done:", node.learner.evaluate(), flush=True)
    finally:
        node.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
