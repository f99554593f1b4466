"""Command-line interface of the port (counterpart of ``p2pfl_tpu/cli.py``).

Subcommands:

* ``experiment list`` — the runnable examples (:data:`~p2pfl_tpu_torch.
  examples.EXAMPLES`),
* ``experiment help <name>`` — an example's flags,
* ``experiment run <name> [args...]`` — run it in a subprocess, so a crashed
  experiment cannot take the CLI down,
* ``bench`` — the repo's ``bench.py`` is the JAX package's; the port has no
  benchmark of its own yet, so it raises ``NotImplementedError``,
* ``login`` / ``remote`` / ``launch`` — reserved, as in the reference.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

from p2pfl_tpu_torch.examples import EXAMPLES


def _cmd_experiment(args: argparse.Namespace) -> int:
    if args.action == "list":
        width = max(len(n) for n in EXAMPLES)
        print("Available experiments:")
        for name, (_, desc) in sorted(EXAMPLES.items()):
            print(f"  {name:<{width}}  {desc}")
        return 0
    if args.name not in EXAMPLES:
        print(f"unknown experiment {args.name!r}; try 'experiment list'", file=sys.stderr)
        return 2
    module = EXAMPLES[args.name][0]
    if args.action == "help":
        return subprocess.call([sys.executable, "-m", module, "--help"])
    extra = args.extra[1:] if args.extra[:1] == ["--"] else args.extra
    return subprocess.call([sys.executable, "-m", module, *extra])


def _cmd_bench(args: argparse.Namespace) -> int:
    raise NotImplementedError(
        "bench: bench.py measures the JAX package; the port has no benchmark of its own yet "
        "(python3 chip_smoke.py drives it on the card)"
    )


def _cmd_stub(args: argparse.Namespace) -> int:
    print(f"{args.command}: not implemented yet (reserved, as in the reference CLI)")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="p2pfl-tpu-torch", description="P2P federated learning on one NVIDIA H100")
    sub = p.add_subparsers(dest="command", required=True)
    exp = sub.add_parser("experiment", help="list/inspect/run example experiments")
    exp_sub = exp.add_subparsers(dest="action", required=True)
    exp_sub.add_parser("list", help="list available experiments")
    h = exp_sub.add_parser("help", help="show an experiment's flags")
    h.add_argument("name")
    r = exp_sub.add_parser("run", help="run an experiment in a subprocess")
    r.add_argument("name")
    r.add_argument("extra", nargs=argparse.REMAINDER, help="flags forwarded to the experiment")
    exp.set_defaults(fn=_cmd_experiment)
    b = sub.add_parser("bench", help="the port's benchmark (none yet)")
    b.set_defaults(fn=_cmd_bench)
    for stub in ("login", "remote", "launch"):
        s = sub.add_parser(stub, help="reserved (not implemented yet)")
        s.set_defaults(fn=_cmd_stub)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
