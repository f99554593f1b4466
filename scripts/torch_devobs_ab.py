#!/usr/bin/env python3
"""What the port's devobs tripwires cost a round, on one card.

    python3 scripts/torch_devobs_ab.py [REPEATS]

First the tripwire itself on the card: the diverging MLP run (``lr=1e30``,
4 nodes of 64 samples) must raise ``devobs tripwire: nonfinite at round
0``. Then two ``MeshSimulation`` rounds of ``chip_smoke.py``, each on one
simulation that runs on from where it stopped: the MLP round at bench.py's
metric configuration (100 nodes, committee 4, ``MLP_ROUNDS`` rounds a run)
and the full-width flash LM round (``ROUNDS`` rounds a run), with
``Settings.DEVOBS_ENABLED`` on, off, off, on, ``REPEATS`` times (default
2), at the default ``rounds_per_call=1`` (one read of the devobs rows a
round), and then, each time, one more run with it on at
``rounds_per_call`` equal to the run's rounds (one read a run: what the
per-round read costs). Prints each run's s/round and, last, one JSON
object ``{"mlp": {"on": [...], "off": [...], "on_one_read": [...]}, "lm":
{...}}``. Runs on the card only.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def trips_on_card() -> str:
    from p2pfl_tpu_torch.config import Settings
    from p2pfl_tpu_torch.learning.dataset import RandomIIDPartitionStrategy, synthetic_mnist
    from p2pfl_tpu_torch.models.mlp import mlp_model
    from p2pfl_tpu_torch.parallel.simulation import MeshSimulation

    Settings.DEVOBS_ENABLED = True
    parts = synthetic_mnist(n_train=256, n_test=64).generate_partitions(4, RandomIIDPartitionStrategy)
    sim = MeshSimulation(mlp_model(seed=0, device="cuda"), parts, train_set_size=2, batch_size=32, lr=1e30,
                         seed=0, device="cuda")
    try:
        sim.run(rounds=2, warmup=False)
    except RuntimeError as e:
        return str(e)
    raise SystemExit("the diverging run did not trip on the card")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_devobs_ab: no CUDA device visible", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from p2pfl_tpu_torch.config import Settings
    from p2pfl_tpu_torch.models.mlp import mlp_model
    from p2pfl_tpu_torch.models.transformer import transformer_lm_model
    from p2pfl_tpu_torch.parallel.simulation import MeshSimulation

    repeats = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    print(cs.nvidia_smi())
    msg = trips_on_card()
    print(f"[devobs] the diverging MLP run raised: {msg}")
    if not msg.startswith("devobs tripwire: nonfinite at round 0 (chunk 0)"):
        raise SystemExit("the diverging run tripped with another kind or round")

    mlp = MeshSimulation(mlp_model(seed=0, device="cuda"), cs.mlp_partitions(), train_set_size=cs.MLP_COMMITTEE,
                         batch_size=cs.MLP_BATCH, seed=1, device="cuda")
    lm = transformer_lm_model(seed=0, vocab_size=cs.VOCAB, num_layers=cs.LAYERS, num_heads=cs.HEADS,
                              embed_dim=cs.EMBED, attention_kind="flash", device="cuda")
    train, xt = cs.lm_data(5)
    lm_sim = MeshSimulation(lm, train, test_data=(xt, None), train_set_size=cs.COMMITTEE, batch_size=cs.BATCH,
                            lr=cs.LR, seed=1, task="lm", device="cuda")
    out: dict = {}
    for label, sim, rounds in (("mlp", mlp, cs.MLP_ROUNDS), ("lm", lm_sim, cs.ROUNDS)):
        times: dict = {"on": [], "off": [], "on_one_read": []}
        first = True
        for _ in range(repeats):
            for state in ("on", "off", "off", "on", "on_one_read"):
                Settings.DEVOBS_ENABLED = state != "off"
                res = sim.run(rounds=rounds, epochs=1, warmup=first,
                              rounds_per_call=rounds if state == "on_one_read" else 1)
                first = False
                times[state].append(res.seconds_per_round)
                print(f"[devobs] {label} devobs {state}: {res.seconds_per_round:.6f} s/round "
                      f"({rounds} rounds, host clock ending in torch.cuda.synchronize())")
        out[label] = times
    Settings.DEVOBS_ENABLED = True
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
