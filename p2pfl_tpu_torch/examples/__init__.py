"""Runnable examples of the port (counterparts of ``p2pfl_tpu/examples/``).

``EXAMPLES`` maps a name to ``(module, description)``; the CLI's
``experiment`` subcommands (:mod:`p2pfl_tpu_torch.cli`) list and run them.
"""

from __future__ import annotations

EXAMPLES = {
    "mnist": (
        "p2pfl_tpu_torch.examples.mnist",
        "N-node MNIST federation: --nodes/--rounds/--epochs/--aggregator/--server-opt/--dp-clip "
        "(--mode mesh: one fused simulation on the card; --mode nodes: real Nodes, --protocol memory|grpc).",
    ),
    "cifar": (
        "p2pfl_tpu_torch.examples.cifar",
        "Federated CIFAR-10 ResNet-18 (configs #3/#4): --aggregator "
        "{scaffold,krum,trimmed_mean,fedavg,fedmedian,geomedian}/--poison-frac/"
        "--attack {labelflip,signflip,scaled}/--nodes/--alpha.",
    ),
    "longcontext": (
        "p2pfl_tpu_torch.examples.longcontext",
        "Federated long-context LM fine-tuning (task='lm'): --seq-len/--attention {blockwise,flash,dense}/"
        "--layers/--nodes.",
    ),
    "node1": (
        "p2pfl_tpu_torch.examples.node1",
        "Two-process gRPC quickstart, process 1 (waits for node2, then trains): --addr/--rounds/--device.",
    ),
    "node2": (
        "p2pfl_tpu_torch.examples.node2",
        "Two-process gRPC quickstart, process 2 (connects to node1): --peer/--device.",
    ),
}

__all__ = ["EXAMPLES"]
