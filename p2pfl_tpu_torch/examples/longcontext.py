"""Federated long-context LM fine-tuning example on the port (counterpart of
``p2pfl_tpu/examples/longcontext.py``; the same flags, defaults, data and
printed keys).

N federated nodes fine-tune a decoder-only transformer on their private
token corpora through the fused round's causal-LM path
(``MeshSimulation(task="lm")``), with the attention kind selectable:
``blockwise`` (online softmax), ``flash`` (the port's Hopper kernels) or
``dense``. The corpus is synthetic but learnable: arithmetic token
progressions mod the vocab, so next-token loss falls fast.

    python -m p2pfl_tpu_torch.examples.longcontext --attention flash

``--platform default`` (the default) runs on the card and fails without
one; ``--platform cpu`` runs the kernels' plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Dict

import numpy as np

from p2pfl_tpu_torch.models.transformer import transformer_lm_model
from p2pfl_tpu_torch.parallel.simulation import MeshSimulation

TEST_SEQS = 16  # held-out sequences, evaluated in one batch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m p2pfl_tpu_torch.examples.longcontext", description=__doc__)
    p.add_argument("--nodes", type=int, default=8)
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--seq-len", type=int, default=256)
    p.add_argument("--vocab", type=int, default=64)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--embed-dim", type=int, default=64)
    p.add_argument("--seqs-per-node", type=int, default=32)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--train-set-size", type=int, default=4)
    p.add_argument("--attention", choices=["blockwise", "flash", "dense"], default="blockwise",
                   help="attention kind inside the federated LM")
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--dp-clip", type=float, default=0.0,
                   help="DP-SGD per-sequence clip norm (> 0 enables private training)")
    p.add_argument("--dp-noise", type=float, default=0.0, help="DP-SGD Gaussian noise multiplier sigma")
    p.add_argument("--measure-time", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--platform", choices=["default", "cpu", "cuda"], default="default",
                   help="where the federation runs (default: the card)")
    return p


def run(args: argparse.Namespace) -> Dict[str, Any]:
    """Build the data and the federation from parsed ``args``, run it, and
    return the result dict :func:`main` prints."""
    device = "cpu" if args.platform == "cpu" else "cuda"
    rng = np.random.default_rng(args.seed)
    n, s, length = args.nodes, args.seqs_per_node, args.seq_len
    starts = rng.integers(0, args.vocab, size=(n, s, 1))
    x = ((starts + np.arange(length)[None, None, :]) % args.vocab).astype(np.int32)
    y = np.zeros((n, s), np.int32)  # unused for task="lm"
    mask = np.ones((n, s), np.float32)
    xt = ((rng.integers(0, args.vocab, size=(TEST_SEQS, 1)) + np.arange(length)) % args.vocab).astype(np.int32)

    model = transformer_lm_model(
        seed=args.seed, seq_len=length, vocab_size=args.vocab, num_layers=args.layers, num_heads=args.heads,
        embed_dim=args.embed_dim, attention_kind=args.attention, device=device,
    )
    sim = MeshSimulation(
        model, (x, y, mask), test_data=(xt, None), train_set_size=args.train_set_size,
        batch_size=args.batch_size, lr=args.lr, seed=args.seed, task="lm", dp_clip_norm=args.dp_clip,
        dp_noise_multiplier=args.dp_noise, device=device,
    )
    t0 = time.time()
    res = sim.run(rounds=args.rounds, epochs=args.epochs, warmup=True)
    result: Dict[str, Any] = {
        "seq_len": length,
        "attention": args.attention,
        "sec_per_round": round(res.seconds_per_round, 4),
        "first_token_loss": round(res.test_loss[0], 4),
        "final_token_loss": round(res.test_loss[-1], 4),
        "final_token_acc": round(res.test_acc[-1], 4),
    }
    if args.dp_clip > 0.0:
        result["dp_epsilon_at_1e-5"] = round(sim.privacy_spent()["epsilon"], 3)
    if args.measure_time:
        result["total_elapsed_s"] = round(time.time() - t0, 3)
    return result


def main(argv=None) -> int:
    print(run(build_parser().parse_args(argv)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
