"""The port's campaign-check — the campaign-universe replay gate.

Replays the COMMITTED campaign baseline of the PyTorch port
deterministically: the first ``P2PFL_TPU_CAMPAIGN_CHECK_SCENARIOS``
scenarios of the default campaign (one per family in rotation order, so
the ADAPTIVE-adversary headline family is always in the gate) run on BOTH
backends (port wire Nodes and the port's fused round), under the ledger
parity differ, graded against their family invariants — and the result
must match ``tests/torch_campaign_fixtures/campaign_baseline.json`` on the
deterministic surface:

1. the sampler re-derives the exact committed scenario keys (the campaign
   space itself didn't drift);
2. zero graded invariant violations (for the replay-stable families that
   includes wire hashes == fused hashes, bit for bit, on this device);
3. on the baseline's own device, every replay-stable family's per-round
   aggregate hashes equal the committed ones (wire AND fused). Another
   device's arithmetic differs (CUDA against the host), so there the
   committed hashes are not compared;
4. the adaptive adversary's realized attack ladder (the attack of every
   round) equals the committed one. The rejection counts beside it are
   printed, not compared: they are cumulative counts of the adversary's
   re-shipped frames that honest nodes rejected before its next fit, which
   follow the gossip loop's timing from run to run (in the JAX package
   too: its committed fixture's 5 / 29 came back as 4 / 30, 5 / 40 and
   5 / 35 in three CPU runs of its own scenario).

``--write-baseline`` regenerates the fixture after an INTENDED trajectory
change — the diff then shows exactly which hashes moved, which is the
point of committing them. The scenarios run on the card; ``--device cpu``
runs them on the host (the committed baseline is the host's)::

    python scripts/torch_campaign_check.py --device cpu
    python scripts/torch_campaign_check.py --device cpu --write-baseline

Exit 0 on pass, 1 on failure.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

BASELINE_PATH = os.path.join(REPO, "tests", "torch_campaign_fixtures", "campaign_baseline.json")


def _fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr)
    return 1


def replay_entries(sampled, rep):
    """The baseline's view of a campaign report: per scenario, its key, its
    hashes (replay-stable families only) and its adaptive decisions."""
    entries = []
    for cs, s in zip(sampled, rep["scenarios"]):
        entries.append({
            "family": s["family"],
            "index": s["index"],
            "run_id": s["run_id"],
            "seed": s["seed"],
            "key": cs.key,
            "wire_hashes": s.get("wire_hashes") if s.get("baseline_hashes") else None,
            "fused_hashes": s.get("fused_hashes") if s.get("baseline_hashes") else None,
            "adaptive_decisions": s["adaptive"]["decisions"] if "adaptive" in s else None,
        })
    return entries


def ladder(decisions):
    """The deterministic part of an adaptive decision stream: each round's
    attack (``None`` for a scenario without an adaptive adversary)."""
    return None if decisions is None else [(d["round"], d["attack"]) for d in decisions]


def rejections(decisions):
    return None if decisions is None else [d["rejections"] for d in decisions]


def compare_to_baseline(baseline, entries, seed: int, k: int, device: str):
    """None when ``entries`` replay ``baseline``, else the first mismatch."""
    if baseline.get("campaign_seed") != seed or baseline.get("check_scenarios") != k:
        return (f"baseline shape (seed={baseline.get('campaign_seed')}, k={baseline.get('check_scenarios')}) "
                f"!= configured (seed={seed}, k={k}) — regenerate with --write-baseline")
    committed = baseline.get("scenarios", [])
    if len(committed) != len(entries):
        return f"baseline holds {len(committed)} scenario(s), replay produced {len(entries)}"
    same_device = baseline.get("device") == device
    for want, got in zip(committed, entries):
        where = f"{got['family']}[{got['index']}]"
        if want["key"] != got["key"]:
            return f"{where}: sampler drift — key\n  committed {want['key']}\n  replayed  {got['key']}"
        for side in ("wire_hashes", "fused_hashes") if same_device else ():
            if want.get(side) != got.get(side):
                return (f"{where}: {side} diverged from committed baseline\n"
                        f"  committed {want.get(side)}\n  replayed  {got.get(side)}")
        if ladder(want.get("adaptive_decisions")) != ladder(got.get("adaptive_decisions")):
            return (f"{where}: adaptive decision stream diverged\n"
                    f"  committed {want.get('adaptive_decisions')}\n  replayed  {got.get('adaptive_decisions')}")
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device of both backends (default: cuda)")
    ap.add_argument("--write-baseline", action="store_true", help="rewrite the committed baseline from this run")
    args = ap.parse_args(argv)
    from p2pfl_tpu_torch.campaigns import run_campaign, sample_campaign
    from p2pfl_tpu_torch.config import Settings

    seed = int(Settings.CAMPAIGN_SEED)
    k = int(Settings.CAMPAIGN_CHECK_SCENARIOS)
    t0 = time.monotonic()
    print(f"campaign-check: seed={seed}, replaying {k} scenario(s) on both backends on {args.device}...",
          file=sys.stderr)

    # Round-robin sampling makes the first k scenarios of ANY campaign size
    # identical (family = FAMILIES[i % len], per-family ordinals): the gate
    # replays a true prefix of the full campaign.
    sampled = sample_campaign(seed, k)
    rep = run_campaign(seed, k, emit=lambda m: print(f"  {m}", file=sys.stderr), device=args.device)

    if rep["violations_total"]:
        bad = [v for s in rep["scenarios"] for v in s.get("violations", [s.get("error", "")])]
        return _fail(f"{rep['violations_total']} graded violation(s): {bad}")
    print(f"PASS: {k} scenario(s), zero invariant violations", file=sys.stderr)
    entries = replay_entries(sampled, rep)

    if args.write_baseline:
        os.makedirs(os.path.dirname(BASELINE_PATH), exist_ok=True)
        with open(BASELINE_PATH, "w") as f:
            json.dump({"campaign_seed": seed, "check_scenarios": k, "device": args.device, "scenarios": entries},
                      f, indent=1)
            f.write("\n")
        print(f"baseline written to {BASELINE_PATH}", file=sys.stderr)
        return 0

    try:
        with open(BASELINE_PATH) as f:
            baseline = json.load(f)
    except OSError as e:
        return _fail(f"no committed baseline at {BASELINE_PATH} ({e}); run with --write-baseline to create one")
    for want, got in zip(baseline.get("scenarios", []), entries):
        if got["adaptive_decisions"] is not None:
            print(f"  {got['family']}[{got['index']}] ladder {[a for _, a in ladder(got['adaptive_decisions'])]}, "
                  f"rejections {rejections(got['adaptive_decisions'])} (committed "
                  f"{rejections(want.get('adaptive_decisions'))})", file=sys.stderr)
    err = compare_to_baseline(baseline, entries, seed, k, args.device)
    if err is not None:
        return _fail(err)
    print(f"PASS: committed baseline replayed ({sum(1 for e in entries if e['wire_hashes'])} hash sets"
          + (" compared" if baseline.get("device") == args.device else f" not compared: baseline is "
             f"{baseline.get('device')}'s") + f", {sum(1 for e in entries if e['adaptive_decisions'])} "
          "adaptive stream(s))", file=sys.stderr)
    print(f"campaign-check PASSED in {time.monotonic() - t0:.1f}s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
