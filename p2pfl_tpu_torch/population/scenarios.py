"""Declarative, seeded population scenarios — one spec, two backends
(counterpart of ``p2pfl_tpu/population/scenarios.py``; the host pieces,
data, schedules and Byzantine draws, equal the JAX package's exactly).

A :class:`PopulationScenario` extends the parity harness's
:class:`~p2pfl_tpu_torch.parity.ParityScenario` with the population-scale
environment axes Papaya (arxiv 2111.04877) treats as production reality:

* **Dirichlet non-IID partitioning** — per-node label proportions drawn
  from ``Dirichlet(alpha)``, materialized with fixed per-node sample counts
  (label SKEW, equal sizes) so both backends batch the same shapes and the
  shared train step stays bit-identical;
* **cohort sampling** — a :class:`~p2pfl_tpu_torch.population.cohort.CohortPlan`
  over the scenario's node names; the fused backend compiles it into a
  committee schedule, the wire backend filters its vote candidates through
  the SAME hash sampler;
* **availability/churn traces** — the plan's hash-derived eligibility
  filter (a churned-out node is not solicited that round; it still gossips,
  matching the fused backend where non-members simply don't train);
* **device-class speed tiers** — fused-side ``node_speed`` multipliers
  (trajectory-invariant virtual timing);
* **seeded Byzantine fractions** — a seeded draw of adversaries applying
  the shared ``poison_delta`` transform on both backends.

Because cohorts shrink the per-round committee, a single wire node no
longer witnesses every fold: :func:`stitch_observer_stream` assembles the
wire's certified trajectory from a rotating per-round observer (the round's
first cohort member — its ``CanonicalFedAvg`` folds every contribution and
its commit carries the content hash), which ``scripts/parity_diff.py`` then
aligns against the fused ledger end-to-end. Both runners take the port's
``device`` (default ``"cuda"``).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.device import DeviceLike
from p2pfl_tpu_torch.parity import ParityLearner, ParityScenario, build_train_fn
from p2pfl_tpu_torch.population.cohort import (
    CohortPlan,
    clear_plan,
    cohort_size,
    committee_schedule,
    install_plan,
)


def dirichlet_label_counts(rng: np.random.Generator, n: int, s: int, num_classes: int, alpha: float) -> np.ndarray:
    """Per-node class counts ``[n, num_classes]`` summing to ``s`` per row:
    proportions drawn from ``Dirichlet(alpha)``, quantized by largest
    remainder so every node holds exactly ``s`` samples (fixed counts keep
    the stacked shapes the same under any skew)."""
    props = rng.dirichlet(np.full(num_classes, float(alpha)), size=n)
    raw = props * s
    counts = np.floor(raw).astype(np.int64)
    short = s - counts.sum(axis=1)
    order = np.argsort(-(raw - counts), axis=1, kind="stable")
    for i in range(n):
        counts[i, order[i, : int(short[i])]] += 1
    return counts


@dataclass
class PopulationScenario(ParityScenario):
    """A seeded population scenario both backends can execute.

    Inherits the parity scenario's learner/data knobs; adds the population
    axes. ``byzantine`` / ``straggler`` may still be given explicitly, but
    ``byzantine_fraction`` / ``speed_tiers`` are the population-scale way:
    seeded draws, so the spec stays declarative at any n.
    """

    #: Dirichlet concentration for label skew (None = the IID parity recipe;
    #: small alpha = extreme skew).
    dirichlet_alpha: Optional[float] = None
    #: cohort fraction/floor per round (1.0 = full-population committees,
    #: the parity default).
    cohort_fraction: float = 1.0
    cohort_min: int = 1
    #: hash-derived per-round unavailability (eligibility filter).
    churn_rate: float = 0.0
    #: seeded fraction of nodes poisoning their updates.
    byzantine_fraction: float = 0.0
    byzantine_attack: str = "signflip"
    #: device-class speed multipliers, assigned to nodes by seeded draw and
    #: mapped to the fused backend's ``node_speed`` tiers (fused-only;
    #: trajectory-invariant by construction).
    speed_tiers: Tuple[float, ...] = ()
    #: run the wire federation under masked secure aggregation
    #: (``Settings.PRIVACY_SECAGG``): gossip ships ring-lattice frames and
    #: nodes aggregate via ``MaskedFedAvg``. Fused execution stays
    #: plaintext — masked quantization changes the arithmetic by design, so
    #: the campaign grades this family STRUCTURALLY plus the
    #: masked-vs-plain hash negative control instead of bit parity.
    privacy: bool = False
    #: node index of one ADAPTIVE adversary (chaos/plane.py's
    #: AdaptiveAdversary family): climbs the signflip -> scaled -> norm_ride
    #: ladder as its admission rejections accumulate. None = no adaptive
    #: adversary (the static ``byzantine_fraction`` axis is independent).
    adaptive_adversary: Optional[int] = None
    adaptive_patience: int = 1

    def __post_init__(self) -> None:
        if self.byzantine_fraction and not self.byzantine:
            rng = np.random.default_rng(self.seed + 0x5EED)
            k = int(round(self.byzantine_fraction * self.n_nodes))
            for idx in rng.choice(self.n_nodes, size=k, replace=False):
                self.byzantine[int(idx)] = self.byzantine_attack
        super().__post_init__()
        if not (0.0 < self.cohort_fraction <= 1.0):
            raise ValueError(
                f"cohort_fraction must be in (0, 1], got {self.cohort_fraction}"
            )
        if self.privacy and (
            self.adaptive_adversary is not None
            or self.byzantine
            or self.byzantine_fraction
        ):
            # Masked frames hide individual updates from admission — the
            # rejection signal every adversary axis is graded on cannot
            # exist under secagg (the admission-vs-secrecy tension,
            # node.py's linear-rule check).
            raise ValueError(
                "privacy does not compose with the byzantine/adaptive axes"
            )
        if self.adaptive_adversary is not None:
            # The adaptive family's cross-backend replica (fold_schedule on
            # the fused mesh) and its decision-stream oracle both assume a
            # full, stable committee with a working admission signal:
            #  * full cohorts, no churn — every round folds either n or n-1
            #    contributions, so the two fused programs cover the run;
            #  * no frame drops — a dropped poisoned frame would starve the
            #    rejection signal the ladder escalates on;
            #  * n >= 6 — each honest receiver admits >= 4 honest norms in
            #    round 0, arming the adaptive bound (MIN_NORM_HISTORY) that
            #    must ADMIT the terminal norm_ride stage;
            #  * index != 0 — names[0] is the rotating observer whose ledger
            #    certifies the trajectory, and must stay honest;
            #  * no static byzantine axis on top — one attributed source.
            if not 0 < int(self.adaptive_adversary) < self.n_nodes:
                raise ValueError(
                    f"adaptive_adversary must be in [1, {self.n_nodes}) — "
                    "index 0 is the trajectory observer"
                )
            if self.cohort_fraction != 1.0 or self.churn_rate != 0.0:
                raise ValueError(
                    "adaptive_adversary needs full stable committees "
                    "(cohort_fraction=1.0, churn_rate=0.0)"
                )
            if self.drop_rate != 0.0:
                raise ValueError(
                    "adaptive_adversary needs a lossless wire (drop_rate=0)"
                )
            if self.n_nodes < 6:
                raise ValueError(
                    "adaptive_adversary needs n_nodes >= 6 so admission's "
                    "norm history arms during round 0"
                )
            if self.byzantine or self.byzantine_fraction:
                raise ValueError(
                    "adaptive_adversary does not compose with the static "
                    "byzantine axis (rejection attribution must be unique)"
                )
            if self.adaptive_patience < 1:
                raise ValueError(
                    f"adaptive_patience must be >= 1, got {self.adaptive_patience}"
                )

    @property
    def run_id(self) -> str:
        base = (
            f"population-s{self.seed}-n{self.n_nodes}-r{self.rounds}"
            f"-c{self.cohort_fraction:g}"
        )
        if self.adaptive_adversary is not None:
            base += f"-adv{self.adaptive_adversary}p{self.adaptive_patience}"
        if self.privacy:
            base += "-priv"
        return base

    def adaptive_schedule(self) -> Tuple[str, ...]:
        """The adaptive adversary's attack-per-round oracle (pure seeded
        recurrence — what the realized wire decision stream must equal)."""
        from p2pfl_tpu_torch.chaos.plane import adaptive_attack_schedule

        if self.adaptive_adversary is None:
            return ()
        return adaptive_attack_schedule(
            self.rounds, patience=self.adaptive_patience
        )

    @property
    def cohort_k(self) -> int:
        """The static per-round committee size (both backends')."""
        return cohort_size(self.n_nodes, self.cohort_fraction, self.cohort_min)

    def plan(self) -> CohortPlan:
        """The scenario's cohort plan, pinned to the full name set so a
        wire node with a briefly-stale neighbor view derives the same
        cohort as the fused schedule."""
        return CohortPlan(
            seed=self.seed,
            fraction=self.cohort_fraction,
            min_size=self.cohort_min,
            churn_rate=self.churn_rate,
            names=tuple(self.node_names),
        )

    def schedule(self, start_round: int = 0) -> np.ndarray:
        """The fused backend's ``[rounds, K]`` committee schedule."""
        return committee_schedule(
            self.plan(), self.node_names, self.rounds, start_round=start_round
        )

    def node_speed_array(self) -> Optional[np.ndarray]:
        """Seeded device-class tiers as a ``node_speed`` array (None when
        the scenario declares no tiers and no explicit stragglers)."""
        if not self.speed_tiers and not self.straggler:
            return None
        speed = np.ones(self.n_nodes, np.float32)
        if self.speed_tiers:
            rng = np.random.default_rng(self.seed + 0x7153)
            speed = np.asarray(self.speed_tiers, np.float32)[
                rng.integers(0, len(self.speed_tiers), size=self.n_nodes)
            ]
        for idx, delay in self.straggler.items():
            speed[int(idx)] = 1.0 + float(delay)
        return speed

    def data(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if self.dirichlet_alpha is None:
            return super().data()
        rng = np.random.default_rng(self.seed)
        n, s = self.n_nodes, self.samples_per_node
        templates = rng.uniform(0.0, 1.0, size=(10, 28, 28)).astype(np.float32)
        counts = dirichlet_label_counts(rng, n, s, 10, self.dirichlet_alpha)
        y = np.empty((n, s), np.int32)
        for i in range(n):
            y[i] = rng.permutation(np.repeat(np.arange(10, dtype=np.int32), counts[i]))
        x = templates[y] + rng.normal(0.0, 0.35, size=(n, s, 28, 28)).astype(
            np.float32
        )
        x = np.clip(x, 0.0, 1.0).astype(np.float32)
        return x, y, np.ones((n, s), np.float32)


class PopulationLearner(ParityLearner):
    """Cohort-aware wire learner: trains with the fused round's step and
    generator schedule, but derives its per-fit ``(round, rank, K)`` from
    the scenario's cohort plan — node ``i`` only fits in rounds whose
    cohort contains it, with the generator of its rank in the sorted cohort
    (exactly the generator the fused schedule row gives that member)."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        # The adaptive-adversary node carries its live ladder state
        # (chaos.plane.AdaptiveAdversary); honest nodes carry None.
        self._adaptive = kwargs.pop("adaptive", None)
        super().__init__(*args, **kwargs)
        scn = self.scenario
        if not isinstance(scn, PopulationScenario):
            raise ValueError("PopulationLearner needs a PopulationScenario")
        plan = scn.plan()
        names = scn.node_names
        me = names[self.node_idx]
        self._slots: List[Tuple[int, int, int]] = []
        for r in range(scn.rounds):
            cohort = plan.cohort(r, names)
            if me in cohort:
                self._slots.append((r, cohort.index(me), len(cohort)))

    def fit(self):
        from p2pfl_tpu_torch.parallel.simulation import member_generator, poison_delta

        slot = self._fits
        self._fits += 1
        if slot >= len(self._slots):
            raise RuntimeError(
                f"{self._self_addr}: fit #{slot} but the cohort plan schedules this node for only "
                f"{len(self._slots)} rounds — the wire solicited a non-member (cohort gate broken?)"
            )
        r, rank, _k = self._slots[slot]
        if self._delay_s > 0.0:
            time.sleep(self._delay_s)
        scn = self.scenario
        model = self.get_model()
        start = {n: p.to(self.device) for n, p in model.params.items()}
        new_params, _loss = self._train_fn(start, self._x, self._y, self._w, member_generator(scn.seed, r, rank))
        if self._adaptive is not None:
            # One ladder decision per round, BEFORE corruption: the adversary
            # observes the rejections its previous rounds earned and may
            # escalate, then this round's attack corrupts the whole tree.
            from p2pfl_tpu_torch.chaos.plane import adaptive_poison

            attack = self._adaptive.attack_for_round(r)
            new_params = {n: adaptive_poison(p, start[n], attack).to(p.dtype) for n, p in new_params.items()}
        elif self._attack:
            new_params = {n: poison_delta(p, start[n], self._attack).to(p.dtype) for n, p in new_params.items()}
        model.set_parameters(new_params)
        model.set_contribution([self._self_addr], int(self._w.sum()))
        return model


def stitch_observer_stream(
    scn: PopulationScenario, events_by_node: Dict[str, List[Dict[str, Any]]]
) -> List[Dict[str, Any]]:
    """The wire federation's certified trajectory under cohort sampling.

    A non-member adopts each round's aggregate via gossip but never
    witnesses the folds, so no single node's ledger spans the whole
    trajectory. Rotate the observer instead: round ``r``'s events come from
    the round's FIRST (sorted) cohort member — a train-set node whose
    aggregator folded every contribution and whose commit carries the
    content hash. The concatenation is one stream ``parity_diff`` aligns
    against the fused ledger (same rotation both runs, so two wire runs
    also compare)."""
    plan = scn.plan()
    names = scn.node_names
    stream: List[Dict[str, Any]] = []
    for r in range(scn.rounds):
        observer = plan.cohort(r, names)[0]
        stream.extend(e for e in events_by_node.get(observer, ()) if e.get("round") == r)
    return stream


# --- backend runners ----------------------------------------------------------


def build_adaptive_aggregator(adv: Any) -> Any:
    """The adaptive adversary's OWN aggregator: a :class:`CanonicalFedAvg`
    that, in rejected ladder stages, drops its own poisoned contribution
    from the final fold.

    The poisoned model must stay STORED (gossip distributes from the
    aggregator's model table — un-stored poison would never reach peers and
    the rejection signal the ladder climbs on would never exist), so the
    exclusion happens at :meth:`aggregate` time instead: honest nodes never
    admitted the poisoned frame and stall-patience-aggregate the n-1 honest
    set; the adversary aggregates the SAME n-1 set, so every node — and the
    fused backend's fold_schedule replica — commits a bit-identical
    aggregate. In admitted stages (norm_ride) nothing is filtered and all n
    contributions fold everywhere."""
    from p2pfl_tpu_torch.chaos.plane import ADAPTIVE_REJECTED_STAGES
    from p2pfl_tpu_torch.learning.aggregators import CanonicalFedAvg

    class AdaptiveAdversaryAggregator(CanonicalFedAvg):
        def aggregate(self, models):
            if adv.current_attack in ADAPTIVE_REJECTED_STAGES:
                honest = [m for m in models if set(m.contributors) != {self.node_addr}]
                if honest:
                    models = honest
            return super().aggregate(models)

    return AdaptiveAdversaryAggregator()


def run_scenario_wire(
    scn: PopulationScenario,
    ledger_dir: Optional[str] = None,
    timeout_s: float = 600.0,
    device: DeviceLike = "cuda",
) -> Dict[str, Any]:
    """Run the scenario on real port ``Node`` s over the in-memory
    transport with cohort sampling live: the plan is installed ambiently, so
    ``VoteTrainSetStage`` filters its candidates to the round's cohort and
    (with ``TRAIN_SET_SIZE == K``) elects exactly the cohort,
    deterministically. Returns the parity runner's shape plus
    ``"stitched"`` — the rotating-observer stream for ``parity_diff``."""
    from p2pfl_tpu_torch.chaos import CHAOS
    from p2pfl_tpu_torch.comm.memory.registry import InMemoryRegistry
    from p2pfl_tpu_torch.learning.aggregators import CanonicalFedAvg
    from p2pfl_tpu_torch.learning.dataset.dataset import FederatedDataset
    from p2pfl_tpu_torch.node import Node
    from p2pfl_tpu_torch.telemetry.ledger import LEDGERS
    from p2pfl_tpu_torch.utils.utils import set_test_settings, wait_convergence

    snap = Settings.snapshot()
    names = scn.node_names
    x, y, w = scn.data()
    template = scn.template_model(device)
    train_fn = build_train_fn(template.apply, scn.lr, scn.batch_size, scn.epochs)
    nodes: List[Any] = []
    try:
        set_test_settings()
        Settings.LOG_LEVEL = "WARNING"
        Settings.RESOURCE_MONITOR_PERIOD = 0
        Settings.LEDGER_ENABLED = True
        # K-sized committees: the cohort filter leaves exactly K candidates,
        # so every vote elects the whole cohort (a deterministic election).
        Settings.TRAIN_SET_SIZE = scn.cohort_k
        Settings.WIRE_COMPRESSION = "none"
        Settings.VOTE_TIMEOUT = 20.0
        Settings.AGGREGATION_TIMEOUT = 120.0
        Settings.AGGREGATION_STALL_PATIENCE = 60.0
        Settings.GOSSIP_EXIT_ON_X_EQUAL_ROUNDS = 400
        Settings.GOSSIP_MODELS_PER_ROUND = scn.n_nodes
        CHAOS.reset()
        if scn.drop_rate > 0.0:
            Settings.CHAOS_ENABLED = True
            Settings.CHAOS_SEED = scn.seed
            Settings.CHAOS_DROP_RATE = float(scn.drop_rate)
            # Heartbeats ride the same lossy links: widen the miss budget so
            # a live peer is not written off (a partial fold would break bit
            # parity), and give both escape hatches (the aggregation
            # deadline and the stall patience) headroom past repair time.
            Settings.HEARTBEAT_TIMEOUT = 10.0
            Settings.AGGREGATION_TIMEOUT = 600.0
            Settings.AGGREGATION_STALL_PATIENCE = 180.0
        if scn.privacy:
            Settings.PRIVACY_SECAGG = True
        adv = None
        if scn.adaptive_adversary is not None:
            from p2pfl_tpu_torch.chaos.plane import AdaptiveAdversary

            # Rejected-stage rounds never deliver the adversary's frame, so
            # honest aggregators must stall-patience out of the full-set
            # wait quickly.
            Settings.AGGREGATION_STALL_PATIENCE = float(Settings.CAMPAIGN_STALL_PATIENCE)
            adv = AdaptiveAdversary(names[scn.adaptive_adversary], patience=scn.adaptive_patience)
        LEDGERS.reset()
        LEDGERS.configure(scn.run_id)
        install_plan(scn.plan())

        for i, name in enumerate(names):
            is_adv = adv is not None and i == scn.adaptive_adversary
            nodes.append(Node(
                template.build_copy(), FederatedDataset.from_arrays(x[i], y[i]), addr=name,
                learner=PopulationLearner,
                # Masked rounds need a linear partial-aggregation rule: Node
                # picks MaskedFedAvg when given None.
                aggregator=(build_adaptive_aggregator(adv) if is_adv
                            else (None if scn.privacy else CanonicalFedAvg())),
                executor=False, device=device, node_idx=i, scenario=scn, arrays=(x[i], y[i], w[i]),
                train_fn=train_fn, adaptive=adv if is_adv else None,
            ))
            if is_adv:
                # The adversary does not defend itself: a permissive gate
                # lets its own-contribution-filtering aggregator fold
                # exactly the honest set, keeping its round-start params
                # bit-identical to the honest nodes'.
                nodes[-1].state.admission.permissive = True
        for nd in nodes:
            nd.start()
        for i in range(1, len(nodes)):
            nodes[i].connect(nodes[0].addr)
        wait_convergence(nodes, scn.n_nodes - 1, wait=30)
        nodes[0].set_start_learning(rounds=scn.rounds, epochs=scn.epochs)
        deadline = time.time() + timeout_s
        while not all(not nd.learning_in_progress() and nd.learning_workflow is not None for nd in nodes):
            if time.time() >= deadline:
                raise TimeoutError("population wire federation did not finish")
            time.sleep(0.05)

        out: Dict[str, Any] = {"ledgers": {}, "hashes": {}, "events": {}}
        for name in names:
            led = LEDGERS.peek(name)
            events = led.canonical_events() if led is not None else []
            out["events"][name] = events
            out["hashes"][name] = {ev["round"]: ev["hash"] for ev in events
                                   if ev["kind"] == "aggregate_committed" and "hash" in ev}
            out["ledgers"][name] = (led.dump(os.path.join(ledger_dir, f"ledger_{name}.jsonl"))
                                    if ledger_dir is not None and led is not None else None)
        out["stitched"] = stitch_observer_stream(scn, out["events"])
        if adv is not None:
            out["adaptive"] = {"decisions": list(adv.decisions), "schedule": list(scn.adaptive_schedule())}
        return out
    finally:
        clear_plan()
        for nd in nodes:
            try:
                nd.stop()
            except Exception:  # noqa: BLE001 — teardown must not mask results
                pass
        InMemoryRegistry.reset()
        CHAOS.reset()
        Settings.restore(snap)


def run_scenario_fused(
    scn: PopulationScenario, ledger_dir: Optional[str] = None, mesh=None, device: DeviceLike = "cuda",
) -> Dict[str, Any]:
    """Run the scenario on the fused round: the plan compiles to a
    committee schedule (``sim.run(committee_schedule=...)``), speed tiers
    map to ``node_speed``, adversaries to the Byzantine mask. Same return
    shape as :func:`p2pfl_tpu_torch.parity.run_fused`, plus
    ``"final_params"`` — the end-of-run global model, ``{torch name: numpy}``.

    An ``adaptive_adversary`` scenario replays the wire's adaptive ladder
    exactly: the adversary is a static ``norm_ride`` Byzantine node (the
    TERMINAL, admitted stage — the only one whose corruption ever reaches
    an aggregate), and each rejected-stage round narrows the fold with a
    ``fold_schedule`` row excluding the adversary's committee position (the
    fused replica of every honest receiver rejecting its frame). Rounds run
    one ``run()`` call each."""
    from p2pfl_tpu_torch.optim import sgd
    from p2pfl_tpu_torch.parallel.simulation import MeshSimulation
    from p2pfl_tpu_torch.telemetry.ledger import LEDGERS

    snap = Settings.snapshot()
    names = scn.node_names
    x, y, w = scn.data()
    byz_mask = None
    attack = scn.byzantine_attack
    if scn.byzantine:
        byz_mask = np.zeros(scn.n_nodes, np.float32)
        for idx, att in scn.byzantine.items():
            byz_mask[int(idx)] = 1.0
            attack = att
    if scn.adaptive_adversary is not None:
        byz_mask = np.zeros(scn.n_nodes, np.float32)
        byz_mask[int(scn.adaptive_adversary)] = 1.0
        attack = "norm_ride"
    sim = None
    try:
        Settings.LEDGER_ENABLED = True
        LEDGERS.configure(scn.run_id)
        sim = MeshSimulation(
            model=scn.template_model(device), partitions=(x, y, w), test_data=None, train_set_size=scn.cohort_k,
            batch_size=scn.batch_size, lr=scn.lr, optimizer=sgd(scn.lr), seed=scn.seed, byzantine_mask=byz_mask,
            byzantine_attack=attack, node_speed=scn.node_speed_array(), canonical_committee=True, mesh=mesh,
            device=device,
        )
        led = sim.attach_ledger(node="mesh-sim", node_names=names)
        if scn.adaptive_adversary is None:
            sim.run(scn.rounds, epochs=scn.epochs, warmup=False, rounds_per_call=1,
                    committee_schedule=scn.schedule())
        else:
            from p2pfl_tpu_torch.chaos.plane import ADAPTIVE_REJECTED_STAGES

            sched = scn.schedule()
            k = sched.shape[1]
            for r, att in enumerate(scn.adaptive_schedule()):
                row = sched[r]
                if att in ADAPTIVE_REJECTED_STAGES:
                    fold = [p for p in range(k) if int(row[p]) != int(scn.adaptive_adversary)]
                else:
                    fold = list(range(k))
                sim.run(1, epochs=scn.epochs, warmup=False, rounds_per_call=1, committee_schedule=sched[r: r + 1],
                        fold_schedule=np.asarray([fold], np.int32))
        final_params = {k: v[0].detach().cpu().numpy().copy() for k, v in sim.params_stack.items()}
        events = led.canonical_events()
        path = led.dump(os.path.join(ledger_dir, "ledger_mesh-sim.jsonl")) if ledger_dir is not None else None
        return {
            "ledger": path,
            "events": events,
            "hashes": {ev["round"]: ev["hash"] for ev in events
                       if ev["kind"] == "aggregate_committed" and "hash" in ev},
            "final_params": final_params,
        }
    finally:
        if sim is not None:
            sim.close()
        Settings.restore(snap)


__all__ = [
    "PopulationLearner",
    "PopulationScenario",
    "build_adaptive_aggregator",
    "dirichlet_label_counts",
    "run_scenario_fused",
    "run_scenario_wire",
    "stitch_observer_stream",
]
