"""Sim<->real parity harness (counterpart of ``p2pfl_tpu/parity.py``): one
seeded scenario, run on the fused round and on the wire's model plane, with
bit-exact ``canonical_params_hash`` agreement every round.

What makes bit-exactness possible inside the port:

* **one local-train step** — :class:`ParityLearner` runs the same
  :func:`~p2pfl_tpu_torch.parallel.simulation.local_train_step` the fused
  round runs, with the fused round's generator for each member:
  :func:`round_member_keys` reproduces the port's schedule, member ``pos``
  of round ``r`` drawing from ``member_generator(seed, r, pos)``;
* **canonical reduction order** — the wire side aggregates with
  :class:`~p2pfl_tpu_torch.learning.aggregators.CanonicalFedAvg`
  (contributor-sorted stack), the fused side with
  ``canonical_committee=True`` (node-index-sorted committee), and node names
  sort as their indices;
* **full committee** — ``train_set_size = n``, so every round elects
  everyone and the vote's draws cannot matter;
* **deterministic adversaries** — a Byzantine node poisons its own update
  with the shared :func:`~p2pfl_tpu_torch.parallel.simulation.poison_delta`.

:func:`run_wire` runs real port ``Node`` s over the in-memory gossip
transport, as the JAX package's does; :func:`run_frames` runs the wire's
model plane without the transport: each node's fit, its dense PFLT frame, a
fresh handle decoding it, ``CanonicalFedAvg`` and the aggregate's diffusion
as a frame.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.device import DeviceLike, resolve_device
from p2pfl_tpu_torch.learning.learner import Learner, softmax_cross_entropy
from p2pfl_tpu_torch.models.model_handle import ModelHandle


@dataclass
class ParityScenario:
    """One seeded federation scenario both backends can execute."""

    seed: int = 1234
    n_nodes: int = 8
    rounds: int = 3
    samples_per_node: int = 64
    batch_size: int = 16
    lr: float = 0.05
    epochs: int = 1
    hidden: Tuple[int, ...] = (32,)
    #: node index -> attack ("signflip" | "scaled"), applied on both backends.
    byzantine: Dict[int, str] = field(default_factory=dict)
    #: node index -> extra seconds per fit (wire: a sleep; fused: node_speed).
    straggler: Dict[int, float] = field(default_factory=dict)
    #: wire-only seeded chaos drop rate (recoverable loss; 0 disables).
    drop_rate: float = 0.0

    def __post_init__(self) -> None:
        if self.samples_per_node % self.batch_size:
            raise ValueError(
                "samples_per_node must be a multiple of batch_size — a ragged tail would be silently "
                "dropped by one backend's batching and not the other's"
            )
        if len(self.byzantine) > 1 and len(set(self.byzantine.values())) > 1:
            raise ValueError("MeshSimulation applies one attack kind per run — use a single attack for all adversaries")

    @property
    def run_id(self) -> str:
        return f"parity-s{self.seed}-n{self.n_nodes}-r{self.rounds}"

    @property
    def node_names(self) -> List[str]:
        # Lexicographic order == node-index order.
        return [f"parity-{i:03d}" for i in range(self.n_nodes)]

    def data(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Stacked per-node arrays ``(x [N,S,28,28], y [N,S], mask [N,S])``,
        the JAX package's bytes for the same scenario."""
        rng = np.random.default_rng(self.seed)
        n, s = self.n_nodes, self.samples_per_node
        templates = rng.uniform(0.0, 1.0, size=(10, 28, 28)).astype(np.float32)
        y = rng.integers(0, 10, size=(n, s)).astype(np.int32)
        x = templates[y] + rng.normal(0.0, 0.35, size=(n, s, 28, 28)).astype(np.float32)
        x = np.clip(x, 0.0, 1.0).astype(np.float32)
        return x, y, np.ones((n, s), np.float32)

    def template_model(self, device: DeviceLike = "cuda") -> ModelHandle:
        from p2pfl_tpu_torch.models.mlp import mlp_model

        return mlp_model(seed=self.seed, hidden_sizes=self.hidden, device=device)


def round_member_keys(seed: int, round_abs: int, k: int) -> List[torch.Generator]:
    """The fused round's per-member training generators, reproduced exactly:
    member ``pos`` of round ``round_abs`` draws its shuffles (and DP noise)
    from ``member_generator(seed, round_abs, pos)``. Under
    ``canonical_committee`` with the whole population elected, member
    ``pos`` is node ``pos``."""
    from p2pfl_tpu_torch.parallel.simulation import member_generator

    return [member_generator(seed, round_abs, pos) for pos in range(int(k))]


def build_train_fn(apply_fn, lr: float, batch_size: int, epochs: int):
    """One single-node trainer per scenario, shared by every wire-side
    node: :func:`local_train_step` with SGD at ``lr`` (fresh state each fit,
    as the fused round's stateless SGD) and the classification loss.
    Returns ``train(params, x, y, w, gen) -> (new_params, loss)``."""
    from p2pfl_tpu_torch.optim import sgd
    from p2pfl_tpu_torch.parallel.simulation import local_train_step

    optimizer = sgd(lr)

    def batch_loss(p, bx, by, bw):
        return softmax_cross_entropy(apply_fn(p, bx), by, bw)

    def train(params, x, y, w, gen):
        new_params, _opt, loss = local_train_step(
            params, optimizer.init(params), gen, x, y, w, None, c_global=None, epochs=epochs,
            batch_loss=batch_loss, optimizer=optimizer, batch_size=batch_size,
        )
        return new_params, loss

    return train


class ParityLearner(Learner):
    """Wire-side learner of the parity scenario: trains with the fused
    round's step and generator schedule, so node ``i``'s round-``r`` update
    is bit-identical across backends. The scenario's Byzantine node poisons
    its own update; the straggler sleeps."""

    def __init__(
        self,
        model: Optional[ModelHandle] = None,
        data=None,
        self_addr: str = "unknown-node",
        node_idx: int = 0,
        scenario: Optional[ParityScenario] = None,
        arrays: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
        train_fn=None,
        device: DeviceLike = "cuda",
        **_: Any,
    ) -> None:
        super().__init__(model, data, self_addr)
        if scenario is None or arrays is None:
            raise ValueError("ParityLearner needs scenario= and arrays=")
        self.device = resolve_device(device)
        self.node_idx = int(node_idx)
        self.scenario = scenario
        x, y, w = arrays
        # As the fused round holds a node's data: float inputs, long labels.
        self._x = torch.as_tensor(np.asarray(x), device=self.device)
        self._y = torch.as_tensor(np.asarray(y), device=self.device).long()
        self._w = torch.as_tensor(np.asarray(w), dtype=torch.float32, device=self.device)
        self._train_fn = train_fn or build_train_fn(self.get_model().apply, scenario.lr, scenario.batch_size,
                                                    scenario.epochs)
        self._fits = 0
        self._attack = scenario.byzantine.get(self.node_idx)
        self._delay_s = float(scenario.straggler.get(self.node_idx, 0.0))

    def get_framework(self) -> str:
        return "torch"

    def interrupt_fit(self) -> None:  # parity fits are short and atomic
        pass

    def fit(self) -> ModelHandle:
        from p2pfl_tpu_torch.parallel.simulation import poison_delta

        r = self._fits
        self._fits += 1
        if self._delay_s > 0.0:
            time.sleep(self._delay_s)
        scn = self.scenario
        gen = round_member_keys(scn.seed, r, scn.n_nodes)[self.node_idx]
        model = self.get_model()
        start = {n: p.to(self.device) for n, p in model.params.items()}
        new_params, _loss = self._train_fn(start, self._x, self._y, self._w, gen)
        if self._attack:
            new_params = {n: poison_delta(p, start[n], self._attack).to(p.dtype) for n, p in new_params.items()}
        model.set_parameters(new_params)
        model.set_contribution([self._self_addr], int(self._w.sum()))
        return model

    def evaluate(self) -> Dict[str, float]:
        return {}


# --- backend runners ----------------------------------------------------------


def run_wire(
    scn: ParityScenario, ledger_dir: Optional[str] = None, timeout_s: float = 600.0, device: DeviceLike = "cuda",
) -> Dict[str, Any]:
    """The scenario on real port ``Node`` s over the in-memory transport (the
    whole Node / gossip / admission / aggregator stack): node ``i`` is
    ``node_names[i]`` with a :class:`ParityLearner` and a
    :class:`CanonicalFedAvg`, inline fits (``executor=False``), every frame
    dense. Dumps every node's trajectory ledger when ``ledger_dir`` is given
    and returns ``{"ledgers": {addr: path-or-None}, "hashes": {addr: {round:
    hash}}, "events": {addr: [...]}, "params": {addr: final canonical leaves
    (numpy)}}``."""
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
        # Every node lives through the whole run, so a write-off can only be
        # false: beats starved on a loaded host. A member written off
        # mid-round shrinks the fold, a real divergence (as a partial fold
        # would be, below), so the liveness timeout outlasts any such stall.
        Settings.HEARTBEAT_TIMEOUT = 30.0
        Settings.LOG_LEVEL = "WARNING"
        Settings.RESOURCE_MONITOR_PERIOD = 0
        Settings.LEDGER_ENABLED = True
        Settings.TRAIN_SET_SIZE = scn.n_nodes  # full committee (module doc)
        Settings.WIRE_COMPRESSION = "none"  # lossless frames only
        Settings.VOTE_TIMEOUT = 20.0
        Settings.AGGREGATION_TIMEOUT = 120.0
        # The seeded straggler must not trip partial aggregation: a partial
        # fold would be a real divergence.
        Settings.AGGREGATION_STALL_PATIENCE = 60.0
        # CanonicalFedAvg ships raw per-sender models, so diffusion leans on
        # peers' models_aggregated reports; while peers are still fitting
        # that status is frozen, so the gossip loop gets a stalled-status
        # budget that outlasts any fit, and fans out to every candidate.
        Settings.GOSSIP_EXIT_ON_X_EQUAL_ROUNDS = 400
        Settings.GOSSIP_MODELS_PER_ROUND = scn.n_nodes
        CHAOS.reset()
        if scn.drop_rate > 0.0:
            Settings.CHAOS_ENABLED = True
            Settings.CHAOS_SEED = scn.seed
            Settings.CHAOS_DROP_RATE = float(scn.drop_rate)
        LEDGERS.reset()
        LEDGERS.configure(scn.run_id)

        for i, name in enumerate(names):
            nodes.append(Node(
                template.build_copy(), FederatedDataset.from_arrays(x[i], y[i]), addr=name, learner=ParityLearner,
                aggregator=CanonicalFedAvg(), executor=False, device=device, node_idx=i, scenario=scn,
                arrays=(x[i], y[i], w[i]), train_fn=train_fn,
            ))
        for nd in nodes:
            nd.start()
        for i in range(1, len(nodes)):
            nodes[i].connect(nodes[0].addr)
        wait_convergence(nodes, scn.n_nodes - 1, wait=30)
        nodes[0].set_start_learning(rounds=scn.rounds, epochs=scn.epochs)
        deadline = time.time() + timeout_s
        while not all(not nd.learning_in_progress() and nd.learning_workflow is not None for nd in nodes):
            if time.time() >= deadline:
                raise TimeoutError("parity wire federation did not finish")
            time.sleep(0.05)

        out: Dict[str, Any] = {"ledgers": {}, "hashes": {}, "events": {}, "params": {}}
        for name, nd in zip(names, nodes):
            led = LEDGERS.peek(name)
            out["events"][name], out["hashes"][name] = _events(led)
            out["ledgers"][name] = (led.dump(os.path.join(ledger_dir, f"ledger_{name}.jsonl"))
                                    if ledger_dir is not None and led is not None else None)
            out["params"][name] = [t.cpu().numpy() for t in nd.learner.get_model().get_parameters()]
        return out
    finally:
        for nd in nodes:
            try:
                nd.stop()
            except Exception:  # noqa: BLE001 — teardown must not mask results
                pass
        InMemoryRegistry.reset()
        CHAOS.reset()
        Settings.restore(snap)


def _events(led) -> Tuple[List[Dict[str, Any]], Dict[int, str]]:
    events = led.canonical_events() if led is not None else []
    return events, {ev["round"]: ev["hash"] for ev in events if ev["kind"] == "aggregate_committed" and "hash" in ev}


def run_frames(scn: ParityScenario, ledger_dir: Optional[str] = None, device: DeviceLike = "cuda") -> Dict[str, Any]:
    """The scenario through the wire's model plane, without the transport:
    every round, each node's :class:`ParityLearner` fits, ships its model as
    a dense PFLT frame (``encode_parameters()``), a fresh handle adopts the
    frame (``set_parameters(bytes)``) and goes into a
    :class:`CanonicalFedAvg` (``set_nodes_to_aggregate``, ``add_model(round=r)``,
    ``wait_and_get_aggregation``); every node then adopts the aggregate from
    its frame. The ledger of ``node_names[0]`` records the rounds
    (``round_open``, the aggregator's ``contribution_folded``,
    ``aggregate_committed`` with the aggregate's hash, ``round_close``).
    Returns ``{"ledger": path-or-None, "events": [...], "hashes": {round:
    hash}, "params": node 0's final canonical leaves (numpy)}``."""
    from p2pfl_tpu_torch.learning.aggregators import CanonicalFedAvg
    from p2pfl_tpu_torch.telemetry.ledger import LEDGERS, canonical_params_hash

    if scn.drop_rate > 0.0 or scn.straggler:
        raise ValueError("run_frames has no transport: drops and stragglers need run_wire")
    snap = Settings.snapshot()
    names = scn.node_names
    x, y, w = scn.data()
    template = scn.template_model(device)
    train_fn = build_train_fn(template.apply, scn.lr, scn.batch_size, scn.epochs)
    try:
        Settings.LEDGER_ENABLED = True
        Settings.WIRE_COMPRESSION = "none"  # lossless frames only
        LEDGERS.reset()
        LEDGERS.configure(scn.run_id)
        learners = [
            ParityLearner(template.build_copy(), None, name, node_idx=i, scenario=scn, arrays=(x[i], y[i], w[i]),
                          train_fn=train_fn, device=device)
            for i, name in enumerate(names)
        ]
        agg = CanonicalFedAvg()
        agg.set_addr(names[0])
        led = LEDGERS.get(names[0])
        for r in range(scn.rounds):
            led.emit("round_open", round=r, members=sorted(names))
            agg.clear()
            agg.set_nodes_to_aggregate(names, round=r)
            for learner in learners:
                frame = learner.fit().encode_parameters()
                received = template.build_copy()
                received.set_parameters(frame)
                agg.add_model(received, round=r)
            out = agg.wait_and_get_aggregation(timeout=Settings.AGGREGATION_TIMEOUT)
            led.emit("aggregate_committed", round=r, hash=canonical_params_hash(out.get_parameters()),
                     contributors=sorted(out.contributors), num_samples=out.get_num_samples(), origin="train")
            led.emit("round_close", round=r)
            diffused = out.encode_parameters()
            for learner in learners:
                learner.get_model().set_parameters(diffused)
        events, hashes = _events(led)
        path = led.dump(os.path.join(ledger_dir, f"ledger_{names[0]}.jsonl")) if ledger_dir is not None else None
        params = [t.cpu().numpy() for t in learners[0].get_model().get_parameters()]
        return {"ledger": path, "events": events, "hashes": hashes, "params": params}
    finally:
        Settings.restore(snap)


def run_fused(
    scn: ParityScenario, ledger_dir: Optional[str] = None, mesh=None, device: DeviceLike = "cuda",
) -> Dict[str, Any]:
    """The scenario on the fused round (:class:`MeshSimulation`,
    ``canonical_committee=True``, ledger attached with the wire's node
    names, every round's aggregate hash). Returns ``{"ledger":
    path-or-None, "events": [...], "hashes": {round: hash}, "params": node
    0's final canonical leaves (numpy)}``."""
    from p2pfl_tpu_torch.optim import sgd
    from p2pfl_tpu_torch.parallel.simulation import MeshSimulation
    from p2pfl_tpu_torch.telemetry.ledger import LEDGERS

    snap = Settings.snapshot()
    names = scn.node_names
    x, y, w = scn.data()
    byz_mask, attack = None, "signflip"
    if scn.byzantine:
        byz_mask = np.zeros(scn.n_nodes, np.float32)
        for idx, att in scn.byzantine.items():
            byz_mask[int(idx)] = 1.0
            attack = att
    speed = None
    if scn.straggler:
        speed = np.ones(scn.n_nodes, np.float32)
        for idx, delay in scn.straggler.items():
            speed[int(idx)] = 1.0 + float(delay)
    sim = None
    try:
        Settings.LEDGER_ENABLED = True
        LEDGERS.configure(scn.run_id)
        sim = MeshSimulation(
            model=scn.template_model(device), partitions=(x, y, w), test_data=None,
            train_set_size=scn.n_nodes, batch_size=scn.batch_size, lr=scn.lr, optimizer=sgd(scn.lr),
            seed=scn.seed, mesh=mesh, byzantine_mask=byz_mask, byzantine_attack=attack, node_speed=speed,
            canonical_committee=True, device=device,
        )
        led = sim.attach_ledger(node="mesh-sim", node_names=names)
        sim.run(scn.rounds, epochs=scn.epochs, warmup=False, rounds_per_call=1)
        events, hashes = _events(led)
        path = led.dump(os.path.join(ledger_dir, "ledger_mesh-sim.jsonl")) if ledger_dir is not None else None
        params = [t.cpu().numpy() for t in sim.final_model().get_parameters()]
        return {"ledger": path, "events": events, "hashes": hashes, "params": params}
    finally:
        if sim is not None:
            sim.close()
        Settings.restore(snap)


__all__ = ["ParityScenario", "ParityLearner", "build_train_fn", "round_member_keys", "run_wire", "run_frames",
           "run_fused"]
