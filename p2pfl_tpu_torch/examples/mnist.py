"""MNIST federation example on the port (counterpart of
``p2pfl_tpu/examples/mnist.py``; the same flags and result keys).

``--mode mesh`` (the default) runs the whole population as one fused
simulation on the card (:class:`~p2pfl_tpu_torch.parallel.simulation.
MeshSimulation`). ``--mode nodes`` runs real :class:`~p2pfl_tpu_torch.node.Node`
s gossiping over the in-memory transport in ``--topology``, each training on
``--device`` (``--protocol grpc`` waits for the gRPC transport and raises
``NotImplementedError``).
``--profiling`` writes a host cProfile ``.pstat`` under ``profile/mnist/``;
``--trace DIR`` writes a ``torch.profiler`` Chrome trace of the run to
``DIR/mnist/trace.json``. ``--measure-time`` times the run itself.

    python -m p2pfl_tpu_torch.examples.mnist --nodes 8 --rounds 5 --aggregator krum

``--device cuda`` (the default) runs on the card and fails without one;
``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="p2pfl-tpu-torch experiment run mnist", description=__doc__)
    p.add_argument("--nodes", type=int, default=4, help="population size")
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--epochs", type=int, default=1, help="local epochs per round")
    p.add_argument("--topology", choices=["line", "ring", "star", "full"], default="line",
                   help="overlay topology (nodes mode)")
    p.add_argument("--protocol", choices=["memory", "grpc"], default="memory", help="transport (nodes mode)")
    p.add_argument("--aggregator", choices=["fedavg", "fedmedian", "scaffold", "krum", "trimmed_mean", "geomedian"],
                   default="fedavg")
    p.add_argument("--mode", choices=["mesh", "nodes"], default="mesh")
    p.add_argument("--server-opt", choices=["none", "fedavgm", "fedadam", "fedyogi"], default="none",
                   help="FedOpt server optimizer (mesh mode; Reddi et al. 2021)")
    p.add_argument("--server-lr", type=float, default=0.01,
                   help="server step size for --server-opt (adaptive variants want ~0.003-0.01; fedavgm ~1.0)")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--train-set-size", type=int, default=4, help="committee size")
    p.add_argument("--samples-per-node", type=int, default=300)
    p.add_argument("--measure-time", action="store_true")
    p.add_argument("--profiling", action="store_true", help="cProfile the run")
    p.add_argument("--trace", metavar="DIR", default=None, help="write a torch.profiler trace of the run under DIR")
    p.add_argument("--dp-clip", type=float, default=0.0,
                   help="DP-SGD per-example clip norm (> 0 enables private training)")
    p.add_argument("--dp-noise", type=float, default=0.0, help="DP-SGD Gaussian noise multiplier sigma")
    p.add_argument("--wire-compression", choices=["none", "bf16", "int8", "topk"], default=None,
                   help="codec for gossiped weight frames (nodes mode; mesh mode never puts weights on a wire)")
    p.add_argument("--seed", type=int, default=None,
                   help="pin the trainer RNG seed (reproducible runs; voids the DP noise-unpredictability "
                   "guarantee). Unset: OS entropy.")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda", help="where the federation runs")
    return p


def _make_aggregator(name: str):
    """A node-mode aggregator by its flag name."""
    from p2pfl_tpu_torch.learning.aggregators import FedAvg, FedMedian, GeometricMedian, Krum, Scaffold, TrimmedMean

    return {
        "fedavg": FedAvg,
        "fedmedian": FedMedian,
        "scaffold": Scaffold,
        "krum": Krum,
        "trimmed_mean": TrimmedMean,
        "geomedian": GeometricMedian,
    }[name]()


def run_mesh(args: argparse.Namespace) -> dict:
    from p2pfl_tpu_torch.learning.dataset import RandomIIDPartitionStrategy, synthetic_mnist
    from p2pfl_tpu_torch.models.mlp import mlp_model
    from p2pfl_tpu_torch.ops import aggregation as agg_ops
    from p2pfl_tpu_torch.parallel.simulation import MeshSimulation

    # 2 * trim must stay below the committee size or the trimmed mean is empty
    trim = min(max(1, args.train_set_size // 4), (args.train_set_size - 1) // 2)
    agg_fn = {
        "fedavg": agg_ops.fedavg,
        "fedmedian": lambda stacked, w: agg_ops.fedmedian(stacked),
        "krum": lambda stacked, w: agg_ops.krum(stacked, w, num_byzantine=1)[0],
        "trimmed_mean": lambda stacked, w: agg_ops.trimmed_mean(stacked, trim=trim),
        "geomedian": agg_ops.geometric_median,
    }.get(args.aggregator)
    algorithm = "scaffold" if args.aggregator == "scaffold" else "fedavg"
    # The data stays deterministic either way; only the trainer seed goes
    # entropy-derived when unset.
    data = synthetic_mnist(n_train=args.nodes * args.samples_per_node, n_test=1024,
                           seed=42 if args.seed is None else args.seed)
    parts = data.generate_partitions(args.nodes, RandomIIDPartitionStrategy)
    sim = MeshSimulation(
        mlp_model(seed=0, device=args.device),
        parts,
        train_set_size=args.train_set_size,
        batch_size=args.batch_size,
        seed=args.seed,
        aggregate_fn=agg_fn,
        algorithm=algorithm,
        lr=0.05 if algorithm == "scaffold" else 1e-3,
        dp_clip_norm=args.dp_clip,
        dp_noise_multiplier=args.dp_noise,
        server_optimizer=None if args.server_opt == "none" else args.server_opt,
        server_lr=args.server_lr,
        device=args.device,
    )
    res = sim.run(rounds=args.rounds, epochs=args.epochs, warmup=True)
    out = {
        "mode": "mesh",
        "sec_per_round": res.seconds_per_round,
        "final_test_acc": res.test_acc[-1] if res.test_acc else None,
    }
    if args.dp_clip > 0.0:
        out["dp_epsilon_at_1e-5"] = round(sim.privacy_spent()["epsilon"], 3)
    return out


def run_nodes(args: argparse.Namespace) -> dict:
    """Real nodes: one :class:`Node` per partition, connected in
    ``--topology``, trained for ``--rounds``; returns the nodes' mean final
    test accuracy (and the DP spend of node 0's learner)."""
    import numpy as np

    from p2pfl_tpu_torch.config import Settings

    if args.protocol == "grpc":
        raise NotImplementedError("--protocol grpc needs the gRPC transport, not ported yet: queue A item 14")
    if args.wire_compression is not None:  # unset keeps the env override
        Settings.WIRE_COMPRESSION = args.wire_compression
    from p2pfl_tpu_torch.learning.dataset import RandomIIDPartitionStrategy, synthetic_mnist
    from p2pfl_tpu_torch.models.mlp import mlp_model
    from p2pfl_tpu_torch.node import Node
    from p2pfl_tpu_torch.utils.topologies import TopologyFactory, TopologyType
    from p2pfl_tpu_torch.utils.utils import check_equal_models, wait_convergence, wait_to_finish

    data = synthetic_mnist(n_train=args.nodes * args.samples_per_node, n_test=512,
                           seed=42 if args.seed is None else args.seed)
    parts = data.generate_partitions(args.nodes, RandomIIDPartitionStrategy)
    nodes = [
        Node(mlp_model(seed=0, device=args.device), parts[i], aggregator=_make_aggregator(args.aggregator),
             batch_size=args.batch_size, dp_clip_norm=args.dp_clip, dp_noise_multiplier=args.dp_noise,
             device=args.device)
        for i in range(args.nodes)
    ]
    for n in nodes:
        n.start()
    try:
        matrix = TopologyFactory.generate_matrix(TopologyType(args.topology), args.nodes)
        TopologyFactory.connect_nodes(matrix, nodes)
        wait_convergence(nodes, args.nodes - 1, only_direct=False, wait=60)
        nodes[0].set_start_learning(rounds=args.rounds, epochs=args.epochs)
        wait_to_finish(nodes, timeout=3600)
        check_equal_models(nodes)
        accs = [m["test_acc"] for m in (n.learner.evaluate() for n in nodes) if "test_acc" in m]
        out = {"mode": "nodes", "final_test_acc": float(np.mean(accs)) if accs else None}
        if args.dp_clip > 0.0:
            # A local claim of node 0's own learner.
            out["dp_epsilon_at_1e-5"] = round(nodes[0].learner.privacy_spent()["epsilon"], 3)
        return out
    finally:
        for n in nodes:
            n.stop()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from p2pfl_tpu_torch.management.profiler import profile_run

    with profile_run(host_dir="profile/mnist" if args.profiling else None, device_trace_dir=args.trace,
                     label="mnist") as prof_info:
        result = run_mesh(args) if args.mode == "mesh" else run_nodes(args)
    if args.measure_time:
        result["total_elapsed_s"] = round(prof_info["elapsed_s"], 3)
    print(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
