"""Runnable examples of the port (counterparts of ``p2pfl_tpu/examples/``).

``EXAMPLES`` maps a name to ``(module, description)``; the CLI's
``experiment`` subcommands (:mod:`p2pfl_tpu_torch.cli`) list and run them.
The reference's two-process gRPC quickstart (``node1`` / ``node2``) waits
for the port's ``Node``.
"""

from __future__ import annotations

EXAMPLES = {
    "mnist": (
        "p2pfl_tpu_torch.examples.mnist",
        "N-node MNIST federation: --nodes/--rounds/--epochs/--aggregator/--server-opt/--dp-clip "
        "(--mode mesh: one fused simulation on the card; --mode nodes waits for the Node).",
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
}

__all__ = ["EXAMPLES"]
