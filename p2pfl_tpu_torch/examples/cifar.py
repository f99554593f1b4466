"""Federated CIFAR-10 ResNet-18 on the port (counterpart of
``p2pfl_tpu/examples/cifar.py``; the same flags, validation and result
dict).

A GroupNorm ResNet-18 (:mod:`p2pfl_tpu_torch.models.resnet`) federated over
Dirichlet non-IID partitions of the synthetic CIFAR-10 stand-in, with
SCAFFOLD against client drift or a robust aggregation rule (Multi-Krum,
trimmed mean, median, geometric median) against Byzantine nodes
(``--poison-frac``: label flipping, or model poisoning with ``--attack
signflip|scaled``).

    python -m p2pfl_tpu_torch.examples.cifar --aggregator krum --poison-frac 0.1

``--device cuda`` (the default) runs on the card and fails without one;
``--device cpu`` runs on the CPU. ``--cost-analysis`` adds the counted work
of one round (``MeshSimulation.round_cost_analysis``) to the result.
"""

from __future__ import annotations

import argparse
import math
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="p2pfl-tpu-torch experiment run cifar", description=__doc__)
    p.add_argument("--nodes", type=int, default=50, help="population size")
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--epochs", type=int, default=1, help="local epochs per round")
    p.add_argument("--aggregator", choices=["fedavg", "fedmedian", "scaffold", "krum", "trimmed_mean", "geomedian"],
                   default="krum")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--train-set-size", type=int, default=8, help="committee size")
    p.add_argument("--samples-per-node", type=int, default=128)
    p.add_argument("--rounds-per-call", type=int, default=1,
                   help="the JAX package's rounds per compiled call (validated; the port runs rounds one by one)")
    p.add_argument("--eval-every", type=int, default=1,
                   help="evaluate every k-th round (final round always evaluated)")
    p.add_argument("--poison-frac", type=float, default=0.0,
                   help="fraction of Byzantine nodes (attack per --attack)")
    p.add_argument("--attack", choices=["labelflip", "signflip", "scaled"], default="labelflip",
                   help="Byzantine mechanism: data poisoning (labelflip) or in-round model poisoning "
                   "(signflip / 10x-scaled delta)")
    p.add_argument("--alpha", type=float, default=0.5, help="Dirichlet concentration for the non-IID partition")
    p.add_argument("--image-size", type=int, default=32, help="synthetic image side length")
    p.add_argument("--lr", type=float, default=None, help="default: 0.05 scaffold, 1e-3 else")
    p.add_argument("--clip-update-norm", type=float, default=0.0,
                   help="norm-bounding defense: clip member deltas to this L2 norm before aggregation (0 = off)")
    p.add_argument("--seed", type=int, default=None,
                   help="pin the trainer RNG seed (unset: OS entropy; data stays deterministic either way)")
    p.add_argument("--measure-time", action="store_true")
    p.add_argument("--cost-analysis", action="store_true",
                   help="add the counted FLOPs / bytes of one round to the result")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda", help="where the federation runs")
    return p


def run(args: argparse.Namespace) -> dict:
    """Build the data and the federation from parsed ``args``, run it, and
    return the result dict :func:`main` prints."""
    if not 0.0 <= args.poison_frac < 1.0:
        raise SystemExit(f"--poison-frac must be in [0, 1), got {args.poison_frac}")
    if args.rounds_per_call < 1:
        raise SystemExit(f"--rounds-per-call must be >= 1, got {args.rounds_per_call}")
    if args.eval_every < 1:
        raise SystemExit(f"--eval-every must be >= 1, got {args.eval_every}")
    if args.aggregator == "scaffold" and args.clip_update_norm > 0:
        raise SystemExit(
            "--clip-update-norm composes with fedavg-style aggregators; "
            "scaffold's control variates assume unclipped deltas"
        )
    if args.aggregator == "scaffold" and args.attack != "labelflip" and args.poison_frac > 0:
        raise SystemExit(
            "model-poisoning attacks (--attack signflip/scaled) need a robust "
            "aggregator (krum/trimmed_mean/fedavg contrast); scaffold's server "
            "update has no robust variant"
        )
    import numpy as np

    from p2pfl_tpu_torch.learning.dataset import (
        DirichletPartitionStrategy,
        poison_partitions,
        select_poisoned,
        synthetic_cifar10,
    )
    from p2pfl_tpu_torch.models.resnet import resnet18_model
    from p2pfl_tpu_torch.ops import aggregation as agg_ops
    from p2pfl_tpu_torch.parallel.simulation import MeshSimulation

    num_classes = 10
    data = synthetic_cifar10(
        n_train=args.nodes * args.samples_per_node, n_test=1024, num_classes=num_classes,
        image_size=args.image_size, seed=42,
    )
    parts = data.generate_partitions(
        args.nodes, DirichletPartitionStrategy, alpha=args.alpha,
        min_partition_size=max(2, args.samples_per_node // 8),
    )
    poisoned = []
    byzantine_mask = None
    if args.poison_frac > 0.0 and args.attack == "labelflip":
        parts, poisoned = poison_partitions(parts, args.poison_frac, num_classes, seed=7)
    elif args.poison_frac > 0.0:
        # The same selection as poison_partitions: label flipping and model
        # poisoning at equal --poison-frac attack the same nodes.
        chosen = select_poisoned(args.nodes, args.poison_frac, seed=7)
        if len(chosen):
            poisoned = chosen
            byzantine_mask = np.zeros(args.nodes, np.float32)
            byzantine_mask[poisoned] = 1.0

    # Byzantine budget for the robust rules: the expected number of poisoned
    # committee members, rounded up, within Krum's n - f - 2 >= 1 headroom.
    committee = args.train_set_size
    f = max(1, math.ceil(args.poison_frac * committee)) if len(poisoned) else 1
    f = min(f, max(1, (committee - 3) // 2))
    agg_fn = {
        "fedavg": agg_ops.fedavg,
        "fedmedian": lambda stacked, w: agg_ops.fedmedian(stacked),
        "krum": lambda stacked, w: agg_ops.krum(stacked, w, num_byzantine=f, num_selected=max(1, committee - f))[0],
        "trimmed_mean": lambda stacked, w: agg_ops.trimmed_mean(stacked, trim=f),
        "geomedian": agg_ops.geometric_median,
    }.get(args.aggregator)
    algorithm = "scaffold" if args.aggregator == "scaffold" else "fedavg"
    lr = args.lr if args.lr is not None else (0.05 if algorithm == "scaffold" else 1e-3)

    with MeshSimulation(
        resnet18_model(seed=0, input_shape=(args.image_size, args.image_size, 3), device=args.device),
        parts,
        train_set_size=committee,
        batch_size=args.batch_size,
        seed=args.seed,
        aggregate_fn=agg_fn,
        algorithm=algorithm,
        lr=lr,
        byzantine_mask=byzantine_mask,
        byzantine_attack=args.attack,
        clip_update_norm=args.clip_update_norm,
        device=args.device,
    ) as sim:
        res = sim.run(rounds=args.rounds, epochs=args.epochs, warmup=True, rounds_per_call=args.rounds_per_call,
                      eval_every=args.eval_every)
        cost = (sim.round_cost_analysis(epochs=args.epochs, rounds_per_call=args.rounds_per_call,
                                        eval_every=args.eval_every)
                if args.cost_analysis else None)
    return {
        "mode": "mesh",
        "model": "resnet18-groupnorm",
        "aggregator": args.aggregator,
        "attack": args.attack if len(poisoned) else None,
        "nodes": args.nodes,
        "poisoned_nodes": [int(i) for i in poisoned],
        "byzantine_budget": f if args.aggregator in ("krum", "trimmed_mean") else None,
        "sec_per_round": res.seconds_per_round,
        "test_acc": [round(a, 4) for a in res.test_acc],
        "final_test_acc": res.test_acc[-1] if res.test_acc else None,
        # The counted work of one round: flops_per_round over sec_per_round
        # is the run's achieved FLOP rate.
        "cost_analysis": cost,
    }


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    t0 = time.monotonic()
    result = run(args)
    if args.measure_time:
        result["total_elapsed_s"] = round(time.monotonic() - t0, 3)
    print(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
