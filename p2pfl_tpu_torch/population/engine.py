"""PopulationEngine — build and drive a population of up to 100k virtual
nodes on one card (counterpart of ``p2pfl_tpu/population/engine.py``).

The engine composes what the rest of the port already holds:

* a :class:`~p2pfl_tpu_torch.parallel.simulation.MeshSimulation` population,
  padded to the mesh's ``"nodes"`` axis (zero-weight fillers, never
  elected), its spec tree derived by the rules of
  :mod:`p2pfl_tpu_torch.population.sharding`;
* per-round cohort sampling: each :meth:`PopulationEngine.run` compiles the
  engine's :class:`~p2pfl_tpu_torch.population.cohort.CohortPlan` into a
  ``[rounds, K]`` committee schedule at the absolute round cursor, so
  chunked calls and a checkpoint resume replay the cohort stream one long
  call would have used;
* the observability surface: :meth:`~PopulationEngine.snapshot` renders the
  population through ``population_snapshot`` with the cohort-fill column,
  and :meth:`~PopulationEngine.save_to` / :meth:`~PopulationEngine.load_from`
  delegate to the simulation's checkpoint path, so a killed engine resumes
  bit-identically.

Data is synthetic (class templates + noise over a small feature dimension:
~205 MB for 100k nodes at the defaults), with optional Dirichlet label
skew; for one seed it equals the JAX package's bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from p2pfl_tpu_torch.device import DeviceLike
from p2pfl_tpu_torch.parallel.mesh import make_mesh
from p2pfl_tpu_torch.population.cohort import CohortPlan, cohort_size, committee_schedule
from p2pfl_tpu_torch.population.sharding import (
    make_shard_and_gather_fns,
    match_partition_rules,
    population_partition_rules,
)


def vnode_names(n: int) -> List[str]:
    """Virtual-node names, zero-padded so lexicographic order is index
    order (the invariant cohort ranking and canonical committees share);
    the width grows with n from a floor of 5 digits."""
    width = max(5, len(str(max(0, n - 1))))
    return [f"vnode/{i:0{width}d}" for i in range(n)]


def population_data(
    seed: int,
    num_nodes: int,
    samples_per_node: int = 16,
    feature_dim: int = 32,
    num_classes: int = 10,
    dirichlet_alpha: Optional[float] = None,
    eval_samples: int = 256,
) -> Tuple[Tuple[np.ndarray, np.ndarray, np.ndarray], Tuple[np.ndarray, np.ndarray]]:
    """Synthetic population partitions ``((x, y, mask), (x_eval, y_eval))``:
    a class template plus gaussian noise over a flat ``feature_dim`` vector,
    the JAX package's draws in its order. ``dirichlet_alpha`` skews each
    node's label proportions (fixed counts a node, so the stacked shapes do
    not change with the skew)."""
    from p2pfl_tpu_torch.population.scenarios import dirichlet_label_counts

    rng = np.random.default_rng(seed)
    n, s, c = int(num_nodes), int(samples_per_node), int(num_classes)
    templates = rng.uniform(-1.0, 1.0, size=(c, feature_dim)).astype(np.float32)
    if dirichlet_alpha is None:
        y = rng.integers(0, c, size=(n, s)).astype(np.int32)
    else:
        counts = dirichlet_label_counts(rng, n, s, c, dirichlet_alpha)
        y = np.empty((n, s), np.int32)
        base = np.arange(c, dtype=np.int32)
        for i in range(n):
            y[i] = rng.permutation(np.repeat(base, counts[i]))
    x = templates[y] + rng.normal(0.0, 0.35, size=(n, s, feature_dim)).astype(np.float32)
    y_eval = rng.integers(0, c, size=(eval_samples,)).astype(np.int32)
    x_eval = templates[y_eval] + rng.normal(0.0, 0.35, size=(eval_samples, feature_dim)).astype(np.float32)
    return (x.astype(np.float32), y, np.ones((n, s), np.float32)), (x_eval.astype(np.float32), y_eval)


class PopulationEngine:
    """Cohort-sampled population runs over one card.

    The round math lives in ``MeshSimulation``; the engine owns the
    population's concerns: names, the cohort plan, the absolute round
    cursor, committee schedules and the spec tree. The arguments are the
    JAX package's, in its order, with ``device`` last (default ``"cuda"``;
    tests pass ``"cpu"``). ``mesh`` is a
    :func:`~p2pfl_tpu_torch.parallel.mesh.make_mesh` mesh; its ``"nodes"``
    size is the multiple the population is padded to.
    """

    def __init__(
        self,
        num_nodes: int,
        cohort_fraction: float = 1.0,
        cohort_min: int = 1,
        churn_rate: float = 0.0,
        seed: int = 0,
        samples_per_node: int = 16,
        feature_dim: int = 32,
        num_classes: int = 10,
        hidden: Tuple[int, ...] = (32,),
        batch_size: int = 8,
        lr: float = 0.05,
        dirichlet_alpha: Optional[float] = None,
        byzantine_fraction: float = 0.0,
        byzantine_attack: str = "signflip",
        speed_tiers: Tuple[float, ...] = (),
        mesh: Any = None,
        model_parallel: bool = False,
        optimizer: Any = None,
        device: DeviceLike = "cuda",
    ) -> None:
        from p2pfl_tpu_torch.models.mlp import mlp_model
        from p2pfl_tpu_torch.optim import sgd
        from p2pfl_tpu_torch.parallel.simulation import MeshSimulation

        if getattr(mesh, "ranked", False):
            raise NotImplementedError(
                "the population engines over a rank mesh are not ported yet (ROADMAP queue A item A6: sharded "
                "checkpoints and both population engines over ranks); MeshSimulation runs over ranks")
        if num_nodes < 1:
            raise ValueError(f"num_nodes must be >= 1, got {num_nodes}")
        self.num_nodes = int(num_nodes)
        self.seed = int(seed)
        self.names = vnode_names(self.num_nodes)
        self.plan = CohortPlan(
            seed=self.seed, fraction=float(cohort_fraction), min_size=int(cohort_min),
            churn_rate=float(churn_rate), names=tuple(self.names),
        )
        self.cohort_k = cohort_size(self.num_nodes, float(cohort_fraction), int(cohort_min))
        (x, y, w), (x_eval, y_eval) = population_data(
            self.seed, self.num_nodes, samples_per_node=samples_per_node, feature_dim=feature_dim,
            num_classes=num_classes, dirichlet_alpha=dirichlet_alpha,
        )
        byz_mask = None
        if byzantine_fraction > 0.0:
            rng = np.random.default_rng(self.seed + 0x5EED)
            byz_mask = np.zeros(self.num_nodes, np.float32)
            k_byz = int(round(byzantine_fraction * self.num_nodes))
            byz_mask[rng.choice(self.num_nodes, size=k_byz, replace=False)] = 1.0
        node_speed = None
        if speed_tiers:
            rng = np.random.default_rng(self.seed + 0x7153)
            node_speed = np.asarray(speed_tiers, np.float32)[rng.integers(0, len(speed_tiers), size=self.num_nodes)]
        model = mlp_model(seed=self.seed, input_shape=(feature_dim,), hidden_sizes=tuple(hidden),
                          out_channels=num_classes, device=device)
        self.sim = MeshSimulation(
            model=model,
            partitions=(x, y, w),
            test_data=(x_eval, y_eval),
            train_set_size=self.cohort_k,
            batch_size=batch_size,
            lr=lr,
            optimizer=optimizer if optimizer is not None else sgd(lr),
            seed=self.seed,
            mesh=mesh,
            byzantine_mask=byz_mask,
            byzantine_attack=byzantine_attack,
            node_speed=node_speed,
            canonical_committee=True,
            pad_to_multiple=None,  # the mesh's "nodes" axis
            device=device,
        )
        # The spec tree over the stacked population, derived once and reused
        # by gather_params().
        self.partition_specs = match_partition_rules(
            population_partition_rules(model_parallel=model_parallel), self.sim.params_stack)
        self._shard_fns, self._gather_fns = make_shard_and_gather_fns(
            self.partition_specs, mesh=self.sim.mesh if self.sim.mesh is not None else make_mesh(devices=[device]))
        self._participation = np.zeros(self.num_nodes, np.float64)
        self._rounds_run = 0

    # --- driving --------------------------------------------------------------------

    @property
    def completed_rounds(self) -> int:
        return int(self.sim.completed_rounds)

    def schedule(self, rounds: int) -> np.ndarray:
        """The next ``rounds`` committee rows at the absolute round cursor
        (``sim.completed_rounds``): an engine that restored a checkpoint
        derives the rows the dead one would have."""
        return committee_schedule(self.plan, self.names, rounds, start_round=self.completed_rounds)

    def run(self, rounds: int, epochs: int = 1, eval_every: int = 1, warmup: bool = False,
            rounds_per_call: Optional[int] = None):
        """Run ``rounds`` cohort-sampled rounds; returns the simulation's
        ``SimulationResult`` (its committees are the schedule rows)."""
        sched = self.schedule(rounds)
        kw: Dict[str, Any] = {}
        if rounds_per_call is not None:
            kw["rounds_per_call"] = rounds_per_call
        res = self.sim.run(rounds, epochs=epochs, eval_every=eval_every, warmup=warmup,
                           committee_schedule=sched, **kw)
        np.add.at(self._participation, np.asarray(res.committees).reshape(-1), 1.0)
        # A tripwire-parked run ran fewer rounds than asked: count what ran.
        self._rounds_run += int(res.rounds)
        return res

    # --- observability --------------------------------------------------------------

    def cohort_fill(self) -> np.ndarray:
        """Each node's realized solicitation fraction over every round this
        engine ran (converges to the cohort fraction)."""
        return self._participation / float(max(1, self._rounds_run))

    def snapshot(self, result, epochs: int = 1, top_n: int = 16, path: Optional[str] = None) -> Dict[str, Any]:
        """Population snapshot (``scripts/fed_top.py`` renders it) with the
        engine's cumulative cohort fill in place of the single result's."""
        from p2pfl_tpu_torch.telemetry.observatory import population_snapshot, write_snapshot_doc

        health = self.sim.fleet_health(result, epochs=epochs)
        health["cohort_fill"] = self.cohort_fill()
        extras, extra_sketches = self.sim.devobs_summary()
        if getattr(result, "tripped", None) is not None:
            extras["tripped"] = result.tripped.get("kind")
        snap = population_snapshot(
            observer="population-engine", node_names=self.names, metrics=health, top_n=top_n,
            extras=extras or None, extra_sketches=extra_sketches or None,
        )
        if path is not None:
            write_snapshot_doc(path, snap)
        return snap

    def attach_ledger(self, node: str = "population-engine", run_id: Optional[str] = None):
        return self.sim.attach_ledger(node=node, node_names=self.names, run_id=run_id)

    def gather_params(self, node_idx: int = 0) -> Dict[str, np.ndarray]:
        """One node's parameters as host numpy (``{torch name: array}``),
        through the gather functions; ``canonical_params_hash`` takes it."""
        return {k: fn(self.sim.params_stack[k][node_idx]) for k, fn in self._gather_fns.items()}

    # --- recovery -------------------------------------------------------------------

    def save_to(self, checkpointer) -> bool:
        return self.sim.save_to(checkpointer)

    def load_from(self, checkpointer, step: Optional[int] = None) -> int:
        restored = self.sim.load_from(checkpointer, step=step)
        if restored > self._rounds_run:
            # The cohort stream is a pure function of (seed, round): replay
            # the restored rounds' schedule so cohort_fill() after a resume
            # matches an uninterrupted run's.
            sched = committee_schedule(self.plan, self.names, restored)
            self._participation = np.zeros(self.num_nodes, np.float64)
            np.add.at(self._participation, sched.reshape(-1), 1.0)
            self._rounds_run = restored
        return restored

    def close(self) -> None:
        self.sim.close()

    def __enter__(self) -> "PopulationEngine":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


__all__ = ["PopulationEngine", "population_data", "vnode_names"]
