"""Federated-population simulation on one card, or over the ranks of a
rank mesh (counterpart of ``p2pfl_tpu/parallel/simulation.py``): the
classification and causal-LM tasks with the JAX package's round options.

The population lives on the device as stacked ``[N, ...]`` tensors: every
node's parameters and optimizer state (and SCAFFOLD's control variates).
One round is the JAX package's round body: elect a committee (or take a
schedule row), train each member locally (FedProx, DP-SGD and SCAFFOLD's
drift correction inside the step), corrupt the Byzantine members' updates,
clip the updates' norms, aggregate (FedAvg by sample count, any
``aggregate_fn``, or SCAFFOLD's server step; then an optional server
optimizer), diffuse the aggregate to every node (committee members keep
their optimizer state) and evaluate it on the test split.

Where the JAX package ``vmap``s local training over the committee inside one
XLA program, the port loops over the members in Python: each member's
training is independent, and the flash kernels' ``autograd.Function`` is not
run under ``torch.func.vmap`` (DP-SGD's per-example gradients loop over the
examples for flash models for the same reason). Each member's own update
transforms (the Byzantine corruption, the norm clip, SCAFFOLD's variate
step, the devobs update norm) run right after its training, on its own
round-start model.

Over ranks (a :func:`~p2pfl_tpu_torch.parallel.mesh.make_mesh` mesh after
``initialize_multihost``) the population is padded to the ``"nodes"`` axis
and each rank keeps its contiguous slab of it (parameters, optimizer state,
control variates, data); every rank builds the same host data from the same
seed and agrees on the committee. A member trains on the rank that holds it;
one ``all_gather`` gives every rank the K transformed member models (with
their losses, update norms and SCAFFOLD's variate deltas) in committee
order, and every rank then aggregates, evaluates and diffuses into its own
slab. The gathered stack is the one a single process builds, so the
trajectory is bit-identical at every world size. Only rank 0 writes files
(the ledger, the flight recorder's dumps, bundles, traces, snapshots), but
a checkpoint is sharded: each rank writes its own slab (or, over model
ranks, its slices) and rank 0 the replicated leaves and the commit
(:meth:`MeshSimulation.save_to`), and a step restores at any world size.

Over model ranks (``make_mesh((1, W), ("nodes", "model"))``, the JAX
package's tensor-parallel layout) every rank holds the whole population, each
kernel cut to its slice of the output dimension (``stacked_spec``'s rule,
:mod:`p2pfl_tpu_torch.parallel.tensor_parallel`): the parameters, the Adam
moments, SCAFFOLD's variates and the server optimizer's state follow the
leaf, so FedAvg and every other elementwise step stay local. Every rank
trains every member with the column-parallel forward (the activations
gathered whole, attention run in full on every rank), and every reduction
over a whole model (the update-norm clip and the devobs norms, Krum's
distances, the geometric median's norms, DP-SGD's per-example norms,
FedProx's penalty) sums the split leaves' part over the ranks.
``per_node_init`` draws each node's noise at the whole leaf's shape and
keeps the slice, so W = 1 and W > 1 start from the same weights;
``final_model``, ``state_dict`` and the ledger's hashes gather the whole
leaves. A custom ``aggregate_fn`` or server transformation must be
elementwise or built from :mod:`p2pfl_tpu_torch.ops.aggregation`'s rules.

RNG: JAX threefry keys and torch generators give different streams, so the
port's draws are its own, from seeded CPU ``torch.Generator``s keyed by the
absolute round index (the vote: ``(seed, round, 0)``; member ``pos``'s
shuffles and DP noise: ``(seed, round, 1, pos)``; ``per_node_init``: ``(seed,
0, 2, node)``). Parity tests pass the same ``committee_schedule`` to both
and use one batch per node.
"""

from __future__ import annotations

import contextlib
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.device import DeviceLike, resolve_device
from p2pfl_tpu_torch.learning.dataset.dataset import FederatedDataset
from p2pfl_tpu_torch.learning.learner import (
    masked_lm_loss,
    seeded_generator as _generator,
    softmax_cross_entropy,
    train_step,
    uses_flash,
)
from p2pfl_tpu_torch.learning.privacy import dp_sgd_privacy_spent, resolve_seed
from p2pfl_tpu_torch.management.profiler import device_memory_watermark, device_trace_window
from p2pfl_tpu_torch.models.model_handle import ModelHandle
from p2pfl_tpu_torch.ops import aggregation as agg_ops
from p2pfl_tpu_torch.optim import adam, sgd, state_map, yogi
from p2pfl_tpu_torch.parallel import collectives
from p2pfl_tpu_torch.parallel.mesh import Mesh
from p2pfl_tpu_torch.parallel.tensor_parallel import MODEL_AXIS, ModelSplit, whole_sq_sum
from p2pfl_tpu_torch.telemetry.bundle import establish_run
from p2pfl_tpu_torch.telemetry.sketches import device_bucket_spec, device_bucket_stats

Params = Dict[str, torch.Tensor]
Aggregate = Callable[[Params, torch.Tensor], Params]
BatchLoss = Callable[[Params, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]

log = logging.getLogger("p2pfl_tpu_torch")


def poison_delta(new: torch.Tensor, old: torch.Tensor, attack: str, scale: float = 10.0) -> torch.Tensor:
    """Byzantine model poisoning of one leaf's round delta, in f32:
    ``signflip`` (and its alias ``norm_ride``) reflects the trained update
    around the round start (``old - (new - old)``), ``scaled`` multiplies it
    by ``scale``."""
    delta = new.float() - old.float()
    if attack in ("signflip", "norm_ride"):
        return old.float() - delta
    return old.float() + scale * delta


def simulated_barrier_time(committees: np.ndarray, node_speed: Optional[np.ndarray]) -> float:
    """Virtual ticks a synchronous barrier run costs over ``committees``
    rows: every round waits for its slowest member's speed tier (one tick =
    one tier-1.0 round)."""
    comm = np.asarray(committees)
    if comm.ndim != 2:
        raise ValueError(f"committees must be [rounds, k], got {comm.shape}")
    if node_speed is None:
        return float(comm.shape[0])
    speed = np.asarray(node_speed, np.float64)
    return float(speed[comm].max(axis=1).sum())


def member_generator(seed: int, round_idx: int, pos: int) -> torch.Generator:
    """The generator of committee member ``pos`` in round ``round_idx`` (its
    shuffles and DP noise): ``(seed, round, 1, pos)``. The sync round, the
    parity learners and the async windows (``round_idx`` a contribution's
    origin window, ``pos`` its rank in that window's sorted cohort) all draw
    from it, so a zero-lag window trains as the sync round does."""
    return _generator(int(seed), int(round_idx), 1, int(pos))


def vote_committee(gen: torch.Generator, n: int, k: int) -> torch.Tensor:
    """The reference's committee election.

    Each node votes ``floor(randint(0, 1000) / (rank + 1))`` for ``k`` random
    candidates; the top ``k`` nodes by summed weight win, ties broken by the
    lower index. Returns ``[k]`` int64 node indices (on the CPU).
    """
    if not 1 <= k <= n:
        raise ValueError(f"committee size must be in [1, {n}], got {k}")
    tally = torch.zeros(n, dtype=torch.float32)
    ranks = torch.arange(1, k + 1, dtype=torch.float32)
    for _ in range(n):
        cands = torch.randperm(n, generator=gen)[:k]
        weights = torch.floor(torch.randint(0, 1000, (k,), generator=gen).float() / ranks)
        tally.index_add_(0, cands, weights)
    return torch.sort(-tally, stable=True).indices[:k]


#: Columns of a round's packed device-observatory row (after the
#: ``nbins`` update-norm bucket counts).
_AUX_COLS = ("nonfinite", "weight_mass", "participants", "un_zeros", "un_sum", "un_min", "un_max",
             "diverged", "train_loss")


def fold_devobs_chunk(
    aux: Dict[str, Any],
    train_loss: Any,
    *,
    first_round: int,
    node: str,
    spec: Tuple[float, int, int],
    last: Dict[str, Any],
) -> Optional[Dict[str, Any]]:
    """Host-side fold of one chunk's devobs aux stream (the JAX package's,
    on the same aux schema: per-round ``un_counts [rounds, nbins]``,
    ``un_zeros`` / ``un_sum`` / ``un_min`` / ``un_max``, ``weight_mass``,
    ``participants``, ``nonfinite`` and ``diverged``, as host arrays).

    Device bucket counts go into the ``SKETCHES`` registry
    (``update_norm``), per-round cohort losses into the ``train_loss``
    sketch, headline values into the ``p2pfl_mesh_*`` gauges, and the
    freshest values into ``last`` (the engine's ``_devobs_last`` — what
    snapshots graft onto peer rows). Returns the chunk's first tripwire
    trip ``{kind, round}`` or ``None``.
    """
    from p2pfl_tpu_torch.telemetry.observatory import mesh_chunk_telemetry
    from p2pfl_tpu_torch.telemetry.sketches import SKETCHES

    gamma_log, lo_idx, _ = spec
    counts = np.asarray(aux["un_counts"])  # [rounds, nbins]
    tr = np.asarray(train_loss, np.float64)  # [rounds]
    vmin = float(np.asarray(aux["un_min"]).min())
    vmax = float(np.asarray(aux["un_max"]).max())
    SKETCHES.fold_buckets(
        "update_norm", node, gamma_log, lo_idx, counts.sum(axis=0),
        zeros=float(np.asarray(aux["un_zeros"]).sum()),
        vsum=float(np.asarray(aux["un_sum"]).sum()),
        vmin=vmin if np.isfinite(vmin) else None,
        vmax=vmax if np.isfinite(vmax) else None,
    )
    finite_tr = tr[np.isfinite(tr)]
    for v in finite_tr:
        SKETCHES.observe("train_loss", node, float(v))
    last_loss = float(finite_tr[-1]) if finite_tr.size else None
    mesh_chunk_telemetry(
        node,
        round_cursor=first_round + tr.shape[0] - 1,
        train_loss=last_loss,
        weight_mass=float(np.asarray(aux["weight_mass"])[-1]),
        participants=float(np.asarray(aux["participants"]).sum()),
    )
    last["train_loss"] = last_loss
    sk = SKETCHES.get("update_norm", node)
    if sk is not None and sk.count > 0:
        last["update_norm_p90"] = round(sk.quantile(0.9), 6)
    flags = np.stack([np.asarray(aux["nonfinite"], bool), np.asarray(aux["diverged"], bool)], axis=1)
    trip = _first_trip(flags, first_round, 0)
    return None if trip is None else {"kind": trip["kind"], "round": trip["round"]}


def fold_devobs_rows(rows: np.ndarray, *, first_round: int, node: str, spec: Tuple[float, int, int],
                     last: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """:func:`fold_devobs_chunk` over one chunk's packed aux rows, ``[rounds,
    nbins + len(_AUX_COLS)]`` read from the device in one copy: the
    update-norm bucket counts, then ``_AUX_COLS`` (the sync rounds' and the
    async windows' rows share the layout)."""
    nbins = spec[2]
    aux: Dict[str, Any] = {name: rows[:, nbins + j] for j, name in enumerate(_AUX_COLS)}
    aux["un_counts"] = rows[:, :nbins].astype(np.int64)
    return fold_devobs_chunk(aux, aux.pop("train_loss"), first_round=first_round, node=node, spec=spec, last=last)


def devobs_summary_for(node: str, last: Dict[str, Any]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``(extras, extra_sketches)`` for one engine's devobs stream — the
    snapshot graft inputs (:func:`~p2pfl_tpu_torch.telemetry.observatory.
    population_snapshot` ``extras``/``extra_sketches``)."""
    from p2pfl_tpu_torch.telemetry.sketches import SKETCHES

    extras = dict(last)
    extras.setdefault("tripped", None)
    sketches: Dict[str, Any] = {}
    for metric in ("update_norm", "train_loss"):
        sk = SKETCHES.get(metric, node)
        if sk is not None and sk.count > 0:
            sketches[metric] = sk
    return extras, sketches


def local_train_step(
    params: Params,
    opt_state: Any,
    gen: torch.Generator,
    x: torch.Tensor,
    y: torch.Tensor,
    w: torch.Tensor,
    c_i: Optional[Params],
    *,
    c_global: Optional[Params],
    epochs: int,
    batch_loss: BatchLoss,
    optimizer: Any,
    batch_size: int,
    lr: float = 0.0,
    fedprox_mu: float = 0.0,
    dp_clip_norm: float = 0.0,
    dp_noise_multiplier: float = 0.0,
    scaffold: bool = False,
    per_example: str = "vmap",
) -> Tuple[Params, Any, torch.Tensor]:
    """One node's local training: ``epochs`` passes over shuffled fixed-size
    batches (a tail short of ``batch_size`` is dropped), one optimizer step
    per batch. FedProx adds its proximal pull toward the round-start
    ``params``; DP-SGD (``dp_clip_norm > 0``) takes :func:`dp_grads`, with
    FedProx's gradient added after the clip; SCAFFOLD adds ``c_global -
    c_i``. Returns the new params, the new optimizer state and the mean
    loss. The JAX package's arguments in its order (``gen`` for its
    ``key``; ``c_i`` and ``c_global`` are read only under SCAFFOLD); ``lr``
    is accepted and not read, as there: the step size is the optimizer's.
    ``per_example``, the port's own, picks how DP-SGD takes per-example
    gradients."""
    steps = x.shape[0] // batch_size
    if steps < 1:
        raise ValueError(f"batch_size {batch_size} exceeds the {x.shape[0]} samples per node")
    anchor = params  # the round-start model, FedProx's anchor
    epoch_losses = []
    for _ in range(epochs):
        perm = torch.randperm(x.shape[0], generator=gen)[: steps * batch_size].to(x.device)
        losses = []
        for s in range(steps):
            idx = perm[s * batch_size:(s + 1) * batch_size]
            params, opt_state, loss = train_step(
                params, opt_state, x[idx], y[idx], w[idx], gen, anchor=anchor, batch_loss=batch_loss,
                optimizer=optimizer, fedprox_mu=fedprox_mu, dp_clip_norm=dp_clip_norm,
                dp_noise_multiplier=dp_noise_multiplier, c_local=c_i if scaffold else None,
                c_global=c_global if scaffold else None, per_example=per_example,
            )
            losses.append(loss)
        epoch_losses.append(torch.stack(losses).mean())
    return params, opt_state, torch.stack(epoch_losses).mean()


@dataclass
class SimulationResult:
    """Per-round metrics + timing."""

    rounds: int
    seconds_total: float
    seconds_per_round: float
    test_acc: List[float] = field(default_factory=list)
    test_loss: List[float] = field(default_factory=list)
    committees: Optional[np.ndarray] = None  # [rounds, K] node indices
    #: device-observatory tripwire record (None = clean run): {kind:
    #: nonfinite|loss_diverge, round, chunk, action, flightrec, bundle}.
    #: Present only on parked runs — DEVOBS_TRIP_ACTION=abort raises instead.
    tripped: Optional[Dict[str, Any]] = None

    def summary(self) -> Dict[str, float]:
        return {
            "rounds": self.rounds,
            "sec_per_round": self.seconds_per_round,
            "rounds_per_sec": 1.0 / max(self.seconds_per_round, 1e-12),
            "final_test_acc": self.test_acc[-1] if self.test_acc else float("nan"),
        }


class MeshSimulation:
    """Simulate an N-node federation on one device.

    The arguments are the JAX package's, in its order, with ``device`` last.

    Args:
        model: template :class:`ModelHandle`; every node starts from its params.
        partitions: per-node :class:`FederatedDataset` s (their train splits
            are stacked, padded rows masked) or pre-stacked ``(x, y,
            sample_mask)`` with a leading node axis.
        test_data: ``(x_test, y_test)``; default: ``partitions[0]``'s test
            split. ``y_test`` may be ``None`` only for ``task="lm"``.
        train_set_size: committee size per round (``Settings.TRAIN_SET_SIZE``).
        batch_size: per-node local batch size.
        lr: local learning rate (and SCAFFOLD's control-variate scale).
        optimizer: a port transformation (:mod:`p2pfl_tpu_torch.optim`);
            default Adam at ``lr``, SGD at ``lr`` under SCAFFOLD.
        seed: round RNG seed (OS entropy when None; over ranks, rank 0's).
        mesh: a :class:`~p2pfl_tpu_torch.parallel.mesh.Mesh`; its ``"nodes"``
            axis size is the default ``pad_to_multiple``. Over a rank mesh
            each rank keeps its slab of the population (``"nodes"`` spans
            the ranks) or its slice of every split kernel (``"model"``
            does), and the calls that gather (``run``, ``final_model``,
            ``state_dict``) are collective: every rank makes them.
        aggregate_fn: ``(stacked, weights) -> params``; default FedAvg.
        per_node_init: perturb each node's start by 0.01 N(0, 1).
        task: ``"classification"`` (labels in ``y``) or ``"lm"`` (``x`` holds
            token sequences ``[N, S, L]``; next-token loss and accuracy).
        fedprox_mu: FedProx's proximal coefficient.
        dp_clip_norm / dp_noise_multiplier: DP-SGD's per-example clip and
            noise multiplier (see :meth:`privacy_spent`).
        algorithm: ``"fedavg"`` or ``"scaffold"``.
        scaffold_global_lr: SCAFFOLD's server step size.
        byzantine_mask: ``[N]`` 0/1 flags of model-poisoning nodes.
        byzantine_attack: ``"signflip"``, ``"norm_ride"`` or ``"scaled"``.
        server_optimizer: ``"fedavgm"``, ``"fedadam"``, ``"fedyogi"`` or a
            port transformation, applied to the pseudo-gradient ``x_t -
            aggregate`` at ``server_lr``.
        clip_update_norm: clip each member's round delta to this global L2
            norm before aggregation (0: off).
        node_speed: ``[N]`` positive speed tiers (the virtual fleet health
            of :meth:`fleet_health` applies them to the measured step time).
        canonical_committee: sort each voted committee by node index.
        pad_to_multiple: pad the population with zero-weight filler nodes,
            never elected, to a multiple of this.
        device: where the population lives (default ``"cuda"``; raises
            when no card is visible). Over a rank mesh: the mesh's device,
            whose type ``device`` must name.
    """

    def __init__(
        self,
        model: ModelHandle,
        partitions: Union[Sequence[FederatedDataset], Tuple[np.ndarray, np.ndarray, np.ndarray]],
        test_data: Optional[Tuple[np.ndarray, Optional[np.ndarray]]] = None,
        train_set_size: Optional[int] = None,
        batch_size: int = 64,
        lr: float = 1e-3,
        optimizer: Any = None,
        seed: Optional[int] = None,
        mesh: Optional[Mesh] = None,
        aggregate_fn: Optional[Aggregate] = None,
        per_node_init: bool = False,
        task: str = "classification",
        fedprox_mu: float = 0.0,
        dp_clip_norm: float = 0.0,
        dp_noise_multiplier: float = 0.0,
        algorithm: str = "fedavg",
        scaffold_global_lr: float = 1.0,
        byzantine_mask: Optional[np.ndarray] = None,
        byzantine_attack: str = "signflip",
        server_optimizer: Any = None,
        server_lr: float = 1.0,
        clip_update_norm: float = 0.0,
        node_speed: Optional[np.ndarray] = None,
        canonical_committee: bool = False,
        pad_to_multiple: Optional[int] = None,
        device: DeviceLike = "cuda",
    ) -> None:
        if task not in ("classification", "lm"):
            raise ValueError(f"unknown task {task!r}")
        if algorithm not in ("fedavg", "scaffold"):
            raise ValueError(f"unknown algorithm {algorithm!r}")
        if byzantine_mask is not None and byzantine_attack not in ("signflip", "scaled", "norm_ride"):
            raise ValueError(f"unknown byzantine_attack {byzantine_attack!r}")
        if byzantine_mask is not None and algorithm == "scaffold":
            raise ValueError(
                "model-poisoning attacks compose with robust aggregate_fn rules "
                "(krum/trimmed-mean); scaffold's server update has no robust variant here"
            )
        if algorithm == "scaffold" and aggregate_fn is not None:
            raise ValueError("scaffold defines its own aggregation; drop aggregate_fn")
        if algorithm == "scaffold" and per_node_init:
            raise ValueError("scaffold assumes a shared round-start model (per_node_init=False)")
        if algorithm == "scaffold" and optimizer is not None:
            raise ValueError(
                "scaffold manages its own SGD optimizer: the option-II control-variate "
                "scale 1/(steps*lr) is only valid for SGD at exactly lr — pass lr=... "
                "instead of optimizer=..."
            )
        if server_optimizer is not None and algorithm == "scaffold":
            raise ValueError(
                "server_optimizer composes with fedavg-style aggregation; scaffold "
                "defines its own server update"
            )
        if server_optimizer is not None and per_node_init:
            raise ValueError(
                "server_optimizer needs a shared round-start model (per_node_init=False): "
                "the pseudo-gradient is x_t - aggregate"
            )
        # Pinned into checkpoint meta (like the DP parameters): a resume under
        # another server optimizer or lr would run the restored moments
        # through the wrong update rule.
        self._server_opt_name = (
            server_optimizer if isinstance(server_optimizer, str)
            else ("custom" if server_optimizer is not None else None))
        self._server_lr = float(server_lr)
        if isinstance(server_optimizer, str):
            # Reddi et al.'s server settings: adaptivity eps 1e-3.
            makers = {
                "fedavgm": lambda: sgd(server_lr, momentum=0.9),
                "fedadam": lambda: adam(server_lr, b1=0.9, b2=0.99, eps=1e-3),
                "fedyogi": lambda: yogi(server_lr, b1=0.9, b2=0.99, eps=1e-3),
            }
            if server_optimizer not in makers:
                raise ValueError(
                    f"unknown server_optimizer {server_optimizer!r}: pass 'fedavgm' | "
                    "'fedadam' | 'fedyogi' or a transformation"
                )
            server_optimizer = makers[server_optimizer]()
        self.server_tx = server_optimizer
        if clip_update_norm < 0.0:
            raise ValueError("clip_update_norm must be >= 0")
        if clip_update_norm > 0.0 and algorithm == "scaffold":
            raise ValueError(
                "clip_update_norm composes with fedavg-style aggregation; scaffold's "
                "control variates assume unclipped deltas"
            )
        if dp_noise_multiplier > 0.0 and dp_clip_norm <= 0.0:
            raise ValueError(
                "dp_noise_multiplier > 0 requires dp_clip_norm > 0 — without a clip "
                "bound the DP branch never runs and training would be silently non-private"
            )
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a p2pfl_tpu_torch Mesh, got {type(mesh).__name__}")
        self._ranked = mesh is not None and mesh.ranked
        if self._ranked and mesh.rank_axis not in ("nodes", MODEL_AXIS):
            raise ValueError(f"a MeshSimulation over ranks needs the 'nodes' or the 'model' axis to span them, got "
                             f"{mesh!r}")
        self._rank, self._world = (mesh.rank, mesh.world) if self._ranked else (0, 1)
        # Over model ranks: which leaves this rank holds a slice of (None otherwise).
        self._split = (ModelSplit({k: v.shape for k, v in model.params.items()}, mesh)
                       if self._ranked and mesh.rank_axis == MODEL_AXIS else None)
        self._nodes_ranked = self._ranked and self._split is None
        if self._split is not None and any(".moe." in k for k in self._split.dims):
            raise NotImplementedError(
                "the MoE LM in a population over model ranks (its experts split on their feature dimensions) is not "
                "ported yet (ROADMAP queue A item A9)")
        if self._ranked:
            if torch.device(device).type != mesh.device.type:
                raise ValueError(f"device {str(device)!r} does not match the rank mesh's {str(mesh.device)!r}")
            self.device = mesh.device
        else:
            self.device = resolve_device(device)
        self.model = model
        self.task = task
        self.algorithm = algorithm
        self.scaffold_global_lr = float(scaffold_global_lr)
        self.lr = float(lr)
        self.fedprox_mu = float(fedprox_mu)
        self.dp_clip_norm = float(dp_clip_norm)
        self.dp_noise_multiplier = float(dp_noise_multiplier)
        self.clip_update_norm = float(clip_update_norm)
        self.canonical_committee = bool(canonical_committee)
        self.batch_size = int(batch_size)
        if optimizer is not None:
            self.optimizer = optimizer
        elif algorithm == "scaffold":
            # SCAFFOLD's option-II variate update (x - y_i)/(steps * lr)
            # holds only for constant-step SGD.
            self.optimizer = sgd(lr)
        else:
            self.optimizer = adam(lr)
        self.seed = resolve_seed(seed, self.dp_noise_multiplier)
        if self._world > 1:  # the ranks draw their committees and shuffles from rank 0's seed
            self.seed = int(collectives.broadcast(
                torch.tensor([self.seed], dtype=torch.int64, device=self.device), src=0, group=mesh.group).item())
        self.mesh = mesh
        self.aggregate_fn: Aggregate = aggregate_fn if aggregate_fn is not None else agg_ops.fedavg
        self._byz_attack = byzantine_attack
        # The collectives of a split model's layers have no vmap rule either.
        self._per_example = "loop" if uses_flash(model.module) or self._split is not None else "vmap"

        # --- data: [N, S, ...] stacks with validity masks ----------------------
        if isinstance(partitions, tuple):
            x, y, mask = (np.asarray(a) for a in partitions)
        else:
            x, y, mask = _stack_partitions(partitions)
        self.num_nodes = int(x.shape[0])
        if node_speed is not None:
            speeds = np.asarray(node_speed, np.float32)
            if speeds.shape != (self.num_nodes,):
                raise ValueError(
                    f"node_speed has shape {speeds.shape}, expected ({self.num_nodes},) — "
                    "one multiplier per node"
                )
            if not np.all(speeds > 0):
                raise ValueError("node_speed multipliers must be > 0")
            self.node_speed: Optional[np.ndarray] = speeds
        else:
            self.node_speed = None
        self._byz: Optional[torch.Tensor] = None
        self._byz_host: Optional[np.ndarray] = None
        if byzantine_mask is not None:
            byz = np.asarray(byzantine_mask, np.float32)
            if byz.shape != (self.num_nodes,):
                raise ValueError(
                    f"byzantine_mask has shape {byz.shape}, expected ({self.num_nodes},) — "
                    "one flag per node"
                )
            self._byz = torch.as_tensor(byz, device=self.device)
            self._byz_host = byz
        self.train_set_size = int(min(train_set_size or Settings.TRAIN_SET_SIZE, self.num_nodes))
        if test_data is not None:
            x_test, y_test = test_data
            if y_test is None and task == "classification" and x_test is not None:
                raise ValueError(
                    "test_data labels are required for task='classification' "
                    "(y_test=None is only valid for task='lm')"
                )
        elif not isinstance(partitions, tuple):
            x_test, y_test = partitions[0].export_arrays(train=False)
        else:
            x_test = y_test = None

        # Zero-weight filler nodes up to a multiple of pad_to_multiple: never
        # elected (votes and schedules range over the logical population).
        self.logical_num_nodes = self.num_nodes
        mult = int(pad_to_multiple) if pad_to_multiple is not None else (
            mesh.shape.get("nodes", 1) if mesh is not None else 1)
        if mult < 1:
            raise ValueError(f"pad_to_multiple must be >= 1, got {mult}")
        n_pad = (-self.num_nodes) % mult
        if n_pad:
            x, y, mask = (np.concatenate([a, np.zeros((n_pad,) + a.shape[1:], a.dtype)]) for a in (x, y, mask))
            self.num_nodes += n_pad
        # This rank's slab [lo, hi) of the padded population (all of it on
        # one process); the FedAvg weights stay whole on every rank.
        self.slab = mesh.slab(self.num_nodes) if self._nodes_ranked else (0, self.num_nodes)
        lo, hi = self.slab
        mask = np.asarray(mask, np.float32)
        self.x = self._to_device(x[lo:hi])
        self.y = self._to_device(y[lo:hi])
        self.sample_mask = torch.as_tensor(mask[lo:hi], device=self.device)
        self.num_samples = torch.as_tensor(mask.sum(axis=1), device=self.device)  # [N] FedAvg weights
        self.x_test = self._to_device(x_test) if x_test is not None else None
        self.y_test = self._to_device(y_test) if y_test is not None else None

        # --- population state ---------------------------------------------------
        self._per_node_init = bool(per_node_init)
        self.params_stack, self.opt_stack, self.c_stack, self.c_global = self._initial_state()
        # Per-node DP-SGD steps, counted as if every node trained every round
        # (an upper bound on the committee's spend); any non-private step
        # voids the epsilon claim.
        self._dp_steps_per_node = 0
        self._nonprivate_steps_per_node = 0
        self.completed_rounds = 0
        self._closed = False
        self._ledger: Any = None  # attach_ledger: None = no emission
        self._ledger_hashes = False  # attach_ledger was called (on every rank of a model split)
        self._ledger_names: Optional[List[str]] = None
        # Device observatory (config.DEVOBS_*): the static bucket spec of the
        # on-device update-norm statistics, the engine's flight recorder
        # (lazy), and the last chunk's host-folded summary that
        # fleet_snapshot grafts onto the population document.
        self._devobs_spec = device_bucket_spec()
        self._devobs_node = "mesh-sim"
        self._recorder: Any = None
        self._devobs_last: Dict[str, Any] = {}
        #: Per timed round of the last run: the committee members each rank
        #: trained, and the bytes this rank's all_gather received (0 on one
        #: process).
        self.rank_members: List[List[int]] = []
        self.gather_bytes: List[int] = []
        self._round_members: List[int] = []
        # Join the federation-wide run context (telemetry/bundle.py), as the
        # JAX package's engine does: every artifact this engine emits
        # carries the run id.
        establish_run(seed=self.seed, name="engine")

    def _initial_state(self) -> Tuple[Params, Any, Params, Dict[str, Any]]:
        """The population's initial ``(params_stack, opt_stack, c_stack,
        c_global)``: every node at the template model (perturbed under
        ``per_node_init``), the optimizer's initial state stacked, and
        SCAFFOLD's zero variates or the server optimizer's state."""
        lo, hi = self.slab
        n = hi - lo
        template = {k: v.detach().to(self.device, torch.float32) for k, v in self.model.params.items()}
        shapes = {k: v.shape for k, v in template.items()}  # whole leaves, as per_node_init draws them
        if self._split is not None:
            template = self._split.shard(template)
        params: Params = {k: v[None].repeat((n,) + (1,) * v.dim()) for k, v in template.items()}
        if self._per_node_init:
            for i in range(n):
                gen = _generator(self.seed, 0, 2, lo + i)
                for k, v in params.items():
                    noise = 0.01 * torch.randn(shapes[k], generator=gen)
                    if self._split is not None:
                        noise = self._split.local(k, noise)
                    v[i] += noise.to(self.device, v.dtype)
        opt = state_map(lambda a: a[None].repeat((n,) + (1,) * a.dim()), self.optimizer.init(template))
        if self.algorithm == "scaffold":
            return (params, opt, {k: torch.zeros_like(v) for k, v in params.items()},
                    {k: torch.zeros_like(v) for k, v in template.items()})
        if self.server_tx is not None:
            return params, opt, {}, {"server_opt": self.server_tx.init(template)}
        return params, opt, {}, {}

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(a), device=self.device)
        return t.long() if not t.is_floating_point() else t

    # --- one round ------------------------------------------------------------

    def _batch_loss(self, params: Params, bx: torch.Tensor, by: torch.Tensor, bw: torch.Tensor) -> torch.Tensor:
        logits = self.model.apply(params, bx)
        if self.task == "lm":
            return masked_lm_loss(logits, bx, bw)
        return softmax_cross_entropy(logits, by, bw)

    @torch.no_grad()
    def _evaluate(self, agg: Params) -> Tuple[torch.Tensor, torch.Tensor]:
        xt = self.x_test
        logits = self.model.apply(agg, xt)
        if self.task == "lm":  # logits [T, L, V]
            loss = masked_lm_loss(logits, xt, torch.ones(xt.shape[0], device=self.device))
            acc = (torch.argmax(logits[:, :-1], dim=-1) == xt[:, 1:]).float().mean()
        else:
            yt = self.y_test
            loss = softmax_cross_entropy(logits, yt, torch.ones(yt.shape, device=self.device))
            acc = (torch.argmax(logits, dim=-1) == yt).float().mean()
        return loss, acc

    def _round(
        self, st: Dict[str, Any], round_idx: int, epochs: int, committee: Optional[torch.Tensor],
        do_eval: bool, fold_pos: Optional[torch.Tensor] = None, devobs: bool = False,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """Run one round on the state ``st`` (``params``, ``opt``, ``c``,
        ``c_global``: this rank's slab), in place; returns ``(committee,
        train_loss, test_loss, test_acc, aux)`` (NaN test values when
        ``do_eval`` is off). With ``devobs``, ``aux`` is the round's
        device-observatory row, computed on the device and read by nothing
        here: one f64 tensor of the update-norm bucket counts
        (:func:`device_bucket_stats` over the members' round-delta L2 norms)
        and ``_AUX_COLS[:7]`` (``nonfinite``: a member's loss or a leaf of the
        aggregate is not finite); else None. The aux feeds nothing back: the
        parameters are bit-identical with it on or off. Over ranks every
        rank runs it together (:meth:`_gather_members`; over model ranks
        with the split bound)."""
        if self._split is None:
            return self._round_body(st, round_idx, epochs, committee, do_eval, fold_pos, devobs)
        with self._split.bind():
            return self._round_body(st, round_idx, epochs, committee, do_eval, fold_pos, devobs)

    def _round_body(
        self, st: Dict[str, Any], round_idx: int, epochs: int, committee: Optional[torch.Tensor],
        do_eval: bool, fold_pos: Optional[torch.Tensor] = None, devobs: bool = False,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        params, opt, scaffold = st["params"], st["opt"], self.algorithm == "scaffold"
        if committee is None:
            committee = vote_committee(
                _generator(self.seed, round_idx, 0), self.logical_num_nodes, self.train_set_size)
            if self.canonical_committee:
                committee = torch.sort(committee).values
        idx = committee.to(self.device)
        comm = committee.tolist()
        lo, hi = self.slab
        if scaffold:
            anchor = {k: v[0] for k, v in params.items()}  # every node holds the shared round start
            c_scale = 1.0 / ((self.x.shape[1] // self.batch_size) * epochs * self.lr)
        rows: List[Params] = []
        for pos, node in enumerate(comm):
            if not lo <= node < hi:
                continue  # another rank trains it
            i = node - lo
            p_0 = {k: v[i] for k, v in params.items()}  # its round-start model
            c_i = {k: v[i] for k, v in st["c"].items()} if scaffold else None
            p_i, o_i, loss = local_train_step(
                p_0, state_map(lambda a: a[i], opt), member_generator(self.seed, round_idx, pos),
                self.x[i], self.y[i], self.sample_mask[i], c_i,
                c_global=st["c_global"] if scaffold else None,
                epochs=epochs, batch_loss=self._batch_loss, optimizer=self.optimizer,
                batch_size=self.batch_size, fedprox_mu=self.fedprox_mu,
                dp_clip_norm=self.dp_clip_norm, dp_noise_multiplier=self.dp_noise_multiplier,
                scaffold=scaffold, per_example=self._per_example,
            )
            state_map(lambda a, u: a[i].copy_(u), opt, o_i)  # only members write back
            row = self._member_update(node, p_0, p_i, devobs)
            row["loss"] = loss.float()
            if scaffold:
                # Member variate c_i' = c_i - c + (x - y_i) / (steps * lr);
                # the server step folds dc = c_i' - c_i.
                c_new = {k: c_i[k] - st["c_global"][k] - (p_i[k].float() - anchor[k].float()) * c_scale
                         for k in c_i}
                row.update({f"dc/{k}": c_new[k] - c_i[k] for k in c_i})
                for k, v in st["c"].items():
                    v[i] = c_new[k]
            rows.append(row)
        stack = self._gather_members(rows, comm, scaffold, devobs)
        p_k_new = {k[2:]: v for k, v in stack.items() if k.startswith("p/")}
        member_losses = stack["loss"]

        weights = self.num_samples[idx]
        if scaffold:
            # Server step: x <- x + lr_g mean(dy); c <- c + K/N mean(dc).
            dy = {k: new.float() - anchor[k].float()[None] for k, new in p_k_new.items()}
            dc = {k[3:]: v for k, v in stack.items() if k.startswith("dc/")}
            new_global, st["c_global"] = agg_ops.scaffold_update(
                anchor, st["c_global"], dy, dc, self.scaffold_global_lr, float(self.logical_num_nodes))
            agg = {k: g.to(anchor[k].dtype) for k, g in new_global.items()}
        else:
            if fold_pos is not None:  # fold only these committee positions
                fp = fold_pos.to(self.device)
                agg = self.aggregate_fn({k: v[fp] for k, v in p_k_new.items()}, weights[fp])
            else:
                agg = self.aggregate_fn(p_k_new, weights)
            if self.server_tx is not None:
                # FedOpt: the pseudo-gradient x_t - aggregate through the server optimizer.
                anchor = {k: v[0].float() for k, v in params.items()}
                pseudo = {k: anchor[k] - agg[k].float() for k in anchor}
                updates, new_state = self.server_tx.update(pseudo, st["c_global"]["server_opt"], anchor)
                agg = {k: (anchor[k] + updates[k]).to(agg[k].dtype) for k in anchor}
                st["c_global"] = {"server_opt": new_state}
        if int(Settings.DEVOBS_NAN_INJECT_ROUND) >= 0 and round_idx == int(Settings.DEVOBS_NAN_INJECT_ROUND):
            # Seeded fault injection for the tripwire: the aggregate turns
            # NaN at one absolute round index.
            agg = {k: torch.full_like(v, float("nan")) for k, v in agg.items()}
        aux = self._devobs_aux(stack["un_sq"], agg, member_losses, weights, len(comm)) if devobs else None
        del p_k_new, stack
        # Diffusion: every node adopts the aggregate (gossip's fixed point).
        for k, v in params.items():
            v.copy_(agg[k][None].expand_as(v))
        if do_eval and self.x_test is not None:
            test_loss, test_acc = self._evaluate(agg)
        elif self.x_test is None:
            test_loss = test_acc = torch.zeros((), device=self.device)
        else:
            test_loss = test_acc = torch.full((), float("nan"), device=self.device)
        return committee, member_losses.mean(), test_loss, test_acc, aux

    def _member_update(self, node: int, p_0: Params, p_i: Params, devobs: bool) -> Params:
        """One member's trained model after its own update transforms, as
        ``{"p/<name>": leaf}``: a Byzantine node's poisoning, then the clip
        of its round delta to ``clip_update_norm`` (global L2), then (with
        ``devobs``) ``"un_sq"``, the squared L2 norm of its final delta.
        ``p_0`` is its round-start model."""
        if self._byz_host is not None and self._byz_host[node] > 0:
            p_i = {k: poison_delta(new, p_0[k], self._byz_attack).to(new.dtype) for k, new in p_i.items()}
        if self.clip_update_norm > 0.0:
            sq = whole_sq_sum({k: ((new.float() - p_0[k].float()) ** 2).sum() for k, new in p_i.items()})
            scale = torch.clamp(self.clip_update_norm / torch.sqrt(sq + 1e-12), max=1.0)
            p_i = {k: (p_0[k].float() + (new.float() - p_0[k].float()) * scale).to(new.dtype)
                   for k, new in p_i.items()}
        row = {f"p/{k}": v for k, v in p_i.items()}
        if devobs:
            deltas = torch._foreach_sub([v.float() for v in p_i.values()], [p_0[k].float() for k in p_i])
            norms = torch._foreach_norm(deltas)
            row["un_sq"] = (torch.stack(norms).square().sum() if self._split is None
                            else self._split.sq_sum({k: v.square() for k, v in zip(p_i, norms)}))
        return row

    def _gather_members(self, rows: List[Params], comm: List[int], scaffold: bool, devobs: bool) -> Params:
        """The committee's member rows stacked ``[K, ...]`` in committee order.
        On one process that is a stack of ``rows``. Over ranks each rank
        brings the rows of the members it holds, one ``all_gather`` moves
        them all, and the rank-major result is put back in committee order;
        the members per rank and the bytes gathered are kept for the run's
        records."""
        if not self._nodes_ranked:
            self._round_members = [len(rows)]
            return agg_ops.tree_stack(rows)
        per = self.slab[1] - self.slab[0]
        if rows:
            local = agg_ops.tree_stack(rows)
        else:  # this rank holds no member: an empty contribution of the same layout
            f32 = torch.float32
            shapes = {f"p/{k}": (v.shape[1:], v.dtype) for k, v in self.params_stack.items()}
            shapes["loss"] = ((), f32)
            if devobs:
                shapes["un_sq"] = ((), f32)
            if scaffold:
                shapes.update({f"dc/{k}": (v.shape[1:], v.dtype) for k, v in self.c_stack.items()})
            local = {k: torch.empty((0, *shape), dtype=dt, device=self.device) for k, (shape, dt) in shapes.items()}
        stack, self._round_members = collectives.gather_ordered(local, [node // per for node in comm],
                                                                group=self.mesh.group)
        return stack

    def _devobs_aux(self, un_sq, agg, member_losses, weights, members: int) -> torch.Tensor:
        """One round's device-observatory row, computed on the device without
        waiting for it: the bucket counts of the members' update norms
        (``un_sq``: their squares), then the nonfinite flag, the weight mass,
        the member count, and the norms' zeros, sum, min and max (f64, read
        by :func:`fold_devobs_chunk`)."""
        gamma_log, lo_idx, nbins = self._devobs_spec
        stats = device_bucket_stats(torch.sqrt(un_sq + 1e-12), gamma_log=gamma_log, lo_idx=lo_idx, nbins=nbins)
        # A leaf's largest |x| is finite exactly when all of it is: one
        # multi-tensor reduction over the aggregate, then one isfinite.
        amax = torch.stack(torch._foreach_norm(list(agg.values()), float("inf"))).float()
        nonfinite = ~torch.isfinite(torch.cat([member_losses.float(), amax])).all()
        if self._split is not None:  # a NaN in one rank's slices trips every rank
            nonfinite = collectives.all_reduce(nonfinite.double(), "max", self.mesh.group) > 0
        return torch.cat([stats["counts"].double(), torch.stack([
            nonfinite.double(), weights.sum().double(),
            torch.full((), float(members), dtype=torch.float64, device=self.device),
            stats["zeros"].double(), stats["sum"].double(), stats["min"].double(), stats["max"].double(),
        ])])

    # --- public API -------------------------------------------------------------

    def _state(self) -> Dict[str, Any]:
        return {"params": self.params_stack, "opt": self.opt_stack, "c": self.c_stack, "c_global": self.c_global}

    def run(
        self,
        rounds: int,
        epochs: int = 1,
        warmup: bool = True,
        rounds_per_call: int = 1,
        checkpointer: Any = None,
        checkpoint_every: int = 1,
        eval_every: int = 1,
        profile_dir: Optional[str] = None,
        committee_schedule: Optional[np.ndarray] = None,
        fold_schedule: Optional[np.ndarray] = None,
    ) -> SimulationResult:
        """Execute ``rounds`` federated rounds; the arguments are the JAX
        package's, in its order.

        With ``warmup`` one extra round runs first on a copy of the state
        (kernel builds, allocator growth and library setup fall outside the
        timing; a round index the real run never uses) and is thrown away.
        ``rounds_per_call`` is the JAX package's compiled chunk of rounds:
        the port launches every round on its own, in order, with RNG keyed
        by the absolute round index, and reads the rounds' device-observatory
        rows once per chunk. With ``Settings.DEVOBS_ENABLED`` each round
        computes on the device the bucket statistics of its members'
        update norms, its fold weight and a flag for a non-finite member
        loss or aggregate (``"nonfinite"``) or a cohort loss above
        ``DEVOBS_LOSS_DIVERGE_MULT`` times the chunk's best finite one
        (``"loss_diverge"``); each chunk's rows are folded into the
        ``SKETCHES`` registry and the ``p2pfl_mesh_*`` gauges
        (:func:`fold_devobs_chunk`). After a chunk that flagged, no further
        round runs, ``completed_rounds`` counts that chunk's rounds, the trip
        is counted, the flight recorder (its ``chunk_start`` / ``chunk_end``
        events carry the allocator's bytes in use) dumped to
        ``artifacts/flightrec_mesh-sim.json`` and an evidence bundle
        written under ``Settings.DOCTOR_BUNDLE_DIR``; under
        ``DEVOBS_TRIP_ACTION="abort"`` the JAX package's ``RuntimeError``
        ("devobs tripwire: <kind> at round <r> (chunk <c>); flight recorder
        dump: <path>; ...") is raised for the chunk's first flagged round,
        under ``"park"`` the partial result returns with ``tripped`` set.
        ``Settings.DEVOBS_NAN_INJECT_ROUND`` (>= 0) turns that absolute
        round's aggregate NaN. ``profile_dir`` (default
        ``Settings.PERF_TRACE_DIR``; empty disables) captures each of the
        first ``Settings.DEVOBS_PROFILE_CHUNKS`` timed chunks as a
        ``torch.profiler`` trace, ``<profile_dir>/mesh_round_chunk<i>/trace.json``.
        ``eval_every=k`` evaluates every k-th round (absolute index) and
        always the final one; ``test_acc`` / ``test_loss`` hold only the
        evaluated rounds. ``committee_schedule`` (``[rounds, K]`` node
        indices in the logical population) replaces the per-round vote; row
        ``i`` drives round ``completed_rounds + i``. ``fold_schedule``
        (``[rounds, K_f]`` positions into the same round's committee row)
        aggregates only those members; the others still train. The timed
        region ends in ``torch.cuda.synchronize()`` when the population is
        on a card. With a ledger attached (:meth:`attach_ledger`) every round
        emits its events. With a ``checkpointer``
        (:class:`~p2pfl_tpu_torch.management.checkpoint.FLCheckpointer`) the
        population is saved (:meth:`save_to`) after every
        ``checkpoint_every``-th chunk and after the last one, unless the
        tripwire stopped the run; a later :meth:`load_from` and ``run``
        resume bit-identically (round draws are keyed by the absolute round
        index). The save's host copy is taken before the next round starts;
        its files are written while the rounds go on. The rounds update the
        state in place: a chunk that fails part-way drops it (``None``,
        ``completed_rounds`` at the last save) and raises a ``RuntimeError``
        that says to restore with :meth:`load_from`; an interrupt is
        re-raised as it is.

        Over ranks every rank calls ``run`` with the same arguments; each
        returns rank 0's test values. ``rank_members`` and ``gather_bytes``
        then hold, per timed round, the members each rank trained and the
        bytes this rank's ``all_gather`` received. A checkpoint over ranks
        is sharded (:meth:`save_to`).
        """
        if self._closed:
            raise RuntimeError("simulation is closed — construct a new MeshSimulation")
        if self.params_stack is None:
            raise RuntimeError(
                "population state lost in a failed chunk — load_from(checkpointer) to restore before running again")
        if int(rounds) != rounds or rounds < 1:
            raise ValueError(f"rounds must be a positive integer, got {rounds!r}")
        for name, val in (("rounds_per_call", rounds_per_call), ("eval_every", eval_every)):
            if int(val) != val or val < 1:
                raise ValueError(f"{name} must be a positive integer, got {val!r}")
        checkpoint_every = max(1, int(checkpoint_every))  # clamped, as the JAX package does
        sched: Optional[np.ndarray] = None
        if committee_schedule is not None:
            sched = np.asarray(committee_schedule, np.int64)
            if sched.ndim != 2 or sched.shape[0] != rounds or sched.shape[1] < 1:
                raise ValueError(
                    f"committee_schedule has shape {sched.shape}, expected ({rounds}, K>=1)"
                )
            if sched.min() < 0 or sched.max() >= self.logical_num_nodes:
                raise ValueError(
                    f"committee_schedule indices must be in [0, {self.logical_num_nodes}) — the "
                    "logical population (filler nodes are not electable)"
                )
        fsched: Optional[np.ndarray] = None
        if fold_schedule is not None:
            if sched is None:
                raise ValueError("fold_schedule positions index a committee row — pass committee_schedule too")
            if self.algorithm == "scaffold":
                raise ValueError("fold_schedule narrows the FedAvg fold; scaffold has no narrowed variant")
            fsched = np.asarray(fold_schedule, np.int64)
            if fsched.ndim != 2 or fsched.shape[0] != rounds or not 1 <= fsched.shape[1] <= sched.shape[1]:
                raise ValueError(
                    f"fold_schedule has shape {fsched.shape}, expected ({rounds}, 1<=K_f<={sched.shape[1]})"
                )
            if fsched.min() < 0 or fsched.max() >= sched.shape[1]:
                raise ValueError(f"fold_schedule entries are positions in [0, {sched.shape[1]})")
        start = self.completed_rounds

        def row(a: Optional[np.ndarray], i: int) -> Optional[torch.Tensor]:
            return None if a is None else torch.from_numpy(a[i])

        if warmup:
            copy = state_map(torch.clone, self._state())
            self._round(copy, start + rounds + 1, epochs, row(sched, 0), True, row(fsched, 0))
            del copy
            self._sync()

        devobs = bool(Settings.DEVOBS_ENABLED)  # read once per run, as the JAX package does
        if profile_dir is None:
            profile_dir = Settings.PERF_TRACE_DIR
        writes = self._rank == 0  # only rank 0 writes files: traces, the flight recorder's dumps
        profile_chunks = int(Settings.DEVOBS_PROFILE_CHUNKS) if writes else 0
        rec = (self._devobs_recorder() if devobs else self._recorder) if writes else None
        self.rank_members, self.gather_bytes = [], []
        steps_per_round = epochs * (self.x.shape[1] // self.batch_size)
        rounds_per_call = min(rounds_per_call, rounds)
        chunks = [rounds_per_call] * (rounds // rounds_per_call)
        if rounds % rounds_per_call:
            chunks.append(rounds % rounds_per_call)
        diverge_mult = float(Settings.DEVOBS_LOSS_DIVERGE_MULT)
        committees, test_loss, test_acc = [], [], []
        trip: Optional[Dict[str, Any]] = None
        st = self._state()
        done = 0
        t0 = time.monotonic()
        try:
            for c, chunk in enumerate(chunks):
                # The leading DEVOBS_PROFILE_CHUNKS timed chunks each get a
                # windowed device trace (distinct labels cooperate with the
                # window's capture-once-per-label contract).
                window = (device_trace_window(profile_dir, label=f"mesh_round_chunk{c}")
                          if c < profile_chunks else contextlib.nullcontext())
                t_chunk = time.monotonic()
                if rec is not None:
                    rec.record("chunk_start", chunk=c, rounds=chunk, first_round=start + done,
                               bytes_in_use=device_memory_watermark()["bytes_in_use"])
                aux_rows: List[torch.Tensor] = []  # the chunk's devobs rows, on the device
                floor = torch.full((), float("inf"), device=self.device)  # the chunk's best finite cohort loss
                with window:
                    for i in range(done, done + chunk):
                        r = start + i
                        do_eval = (r + 1) % eval_every == 0 or i == rounds - 1
                        gathered = collectives.STATS["all_gather_bytes"]
                        comm, tr, tl, ta, aux = self._round(st, r, epochs, row(sched, i), do_eval, row(fsched, i),
                                                            devobs)
                        self.rank_members.append(list(self._round_members))
                        self.gather_bytes.append(collectives.STATS["all_gather_bytes"] - gathered)
                        if self._ranked:
                            log.info("round %d: members per rank %s, %d bytes all-gathered", r,
                                     self._round_members, self.gather_bytes[-1])
                        last = i == done + chunk - 1
                        # Over model ranks every rank gathers the hashed node whole.
                        whole = (self._split.gather({k: v[0] for k, v in st["params"].items()})
                                 if self._split is not None and self._ledger_hashes and last else None)
                        if self._ledger is not None:
                            self._ledger_emit_round(r, comm, row(fsched, i), last, whole)
                        committees.append(comm)
                        test_loss.append(tl)
                        test_acc.append(ta)
                        if devobs:
                            finite = torch.isfinite(tr)
                            diverged = finite & torch.isfinite(floor) & (tr > diverge_mult * floor)
                            floor = torch.where(finite, torch.minimum(floor, tr), floor)
                            aux_rows.append(torch.cat([aux, torch.stack([diverged.double(), tr.double()])]))
                done += chunk
                # Per chunk, as the JAX package counts: a checkpoint taken after
                # this chunk carries its privacy spend.
                if self.dp_clip_norm > 0.0:
                    self._dp_steps_per_node += chunk * steps_per_round
                else:
                    self._nonprivate_steps_per_node += chunk * steps_per_round
                if devobs:
                    # One read of the chunk's aux rows, as the JAX package fetches
                    # its aux once a chunk: sketch buckets into SKETCHES, headline
                    # gauges into p2pfl_mesh_*, tripwire flags into a trip record.
                    trip = fold_devobs_rows(torch.stack(aux_rows).cpu().numpy(), first_round=start + done - chunk,
                                            node=self._devobs_node, spec=self._devobs_spec, last=self._devobs_last)
                wm = device_memory_watermark()
                self._devobs_last["mem_bytes"] = wm["peak_bytes_in_use"]
                if rec is not None:
                    rec.record("chunk_end", chunk=c, rounds=chunk, wall_s=round(time.monotonic() - t_chunk, 4),
                               bytes_in_use=wm["bytes_in_use"], peak_bytes=wm["peak_bytes_in_use"])
                if trip is not None:
                    trip["chunk"] = c
                    break
                # Save on the cadence, and always after the last chunk, so the
                # end-of-run state is never memory-only.
                if checkpointer is not None and ((c + 1) % checkpoint_every == 0 or c == len(chunks) - 1):
                    self.opt_stack, self.c_global = st["opt"], st["c_global"]
                    self.completed_rounds = start + done
                    self.save_to(checkpointer)
        except BaseException as e:
            # The rounds update the state in place: a chunk that failed
            # part-way leaves it part-written. Drop it, as the JAX package
            # drops its donated buffers; completed_rounds stays at the last
            # save, so load_from() and run() resume cleanly.
            self.params_stack = self.opt_stack = None
            self.c_stack = self.c_global = None
            if not isinstance(e, Exception):  # an interrupt or exit stays what it is
                raise
            raise RuntimeError(
                "simulation chunk failed with the population state part-written; restore with "
                "load_from(checkpointer) before running again"
            ) from e
        self._sync()
        self.opt_stack, self.c_global = st["opt"], st["c_global"]
        self.completed_rounds = start + done
        if trip is not None:
            self._devobs_trip(trip, rec)
        dt = time.monotonic() - t0
        tested = torch.stack([torch.stack(test_loss), torch.stack(test_acc)]).float()
        if self._world > 1:  # every rank evaluated the same aggregate; all report rank 0's values
            collectives.broadcast(tested, src=0, group=self.mesh.group)
        loss_all, acc_all = tested.cpu().numpy()
        evaluated = ~np.isnan(acc_all)
        result = SimulationResult(
            rounds=done,
            seconds_total=dt,
            seconds_per_round=dt / max(1, done),
            test_acc=[float(a) for a in acc_all[evaluated]],
            test_loss=[float(v) for v in loss_all[evaluated]],
            committees=torch.stack(committees).numpy(),
            tripped=trip,
        )
        if trip is not None and trip["action"] == "abort":
            # The population state is parked (completed_rounds at the end of
            # the tripped chunk): the raise is the abort contract.
            raise RuntimeError(
                f"devobs tripwire: {trip['kind']} at round {trip['round']} (chunk {trip['chunk']}); flight "
                f"recorder dump: {trip.get('flightrec')}; state parked at round {self.completed_rounds} — set "
                "P2PFL_TPU_DEVOBS_TRIP_ACTION=park to receive partial results instead"
            )
        return result

    def _devobs_trip(self, trip: Dict[str, Any], rec: Any) -> None:
        """A trip is postmortem-worthy, as in the JAX package: count it
        (``p2pfl_mesh_trips_total``), record it in the flight recorder and
        dump the recorder, emit a ``membership`` ledger event and write an
        evidence bundle (``trip["flightrec"]`` / ``trip["bundle"]``: their
        paths, None where a write failed)."""
        from p2pfl_tpu_torch.telemetry.bundle import write_bundle
        from p2pfl_tpu_torch.telemetry.observatory import mesh_trip

        trip["action"] = str(Settings.DEVOBS_TRIP_ACTION)
        mesh_trip(self._devobs_node, trip["kind"])
        self._devobs_last["tripped"] = trip["kind"]
        if rec is not None:
            rec.record("devobs_trip", trip_kind=trip["kind"], round=trip["round"], chunk=trip["chunk"],
                       action=trip["action"])
            trip["flightrec"] = rec.dump("devobs_trip")
        if self._ledger is not None:
            self._ledger.emit("membership", event="devobs_trip", peer=self._devobs_node)
        trip["bundle"] = (write_bundle("devobs_trip", context={k: trip.get(k) for k in ("kind", "round", "chunk",
                                                                                          "action")})
                          if self._rank == 0 else None)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def privacy_spent(self, delta: float = 1e-5) -> Dict[str, Any]:
        """Conservative per-node (epsilon, delta) of the DP-SGD run so far
        (:mod:`p2pfl_tpu_torch.learning.privacy`), counting every node as
        training in every completed round."""
        return dp_sgd_privacy_spent(
            self.dp_noise_multiplier, self.dp_clip_norm, self._dp_steps_per_node, delta,
            nonprivate_steps=self._nonprivate_steps_per_node,
        )

    def final_model(self, node: int = 0) -> ModelHandle:
        """One node's model (all equal after diffusion), as a new handle.
        Over ranks a collective: the rank that holds ``node`` broadcasts it
        (:func:`~p2pfl_tpu_torch.population.sharding.gather_node`), or over
        model ranks every rank gathers its whole leaves."""
        from p2pfl_tpu_torch.population.sharding import gather_node

        if self._closed:
            raise RuntimeError("simulation closed — extract the model before close()")
        if self.params_stack is None:
            raise RuntimeError("population state lost in a failed chunk; load_from(checkpointer) to restore")
        if self._split is not None:
            return ModelHandle(self._split.gather({k: v[node] for k, v in self.params_stack.items()}),
                               self.model.module)
        if not self._ranked:
            return ModelHandle({k: v[node].clone() for k, v in self.params_stack.items()}, self.model.module)
        return ModelHandle(gather_node(self.params_stack, node, self.mesh, self.num_nodes), self.model.module)

    def state_dict(self) -> Dict[str, Any]:
        """The population state: stacked params and optimizer state, plus
        SCAFFOLD's variates and the server optimizer's state where used.
        Over more than one rank a collective: the full ``[N, ...]`` stacks,
        gathered from every rank's slab
        (:func:`~p2pfl_tpu_torch.population.sharding.gather_population`) or,
        over model ranks, the whole leaves from every rank's slices."""
        from p2pfl_tpu_torch.population.sharding import gather_population

        stacks = self.shard_state()
        c_global = stacks.pop("c_global", None)
        if self._split is not None:
            state = self._split.gather(stacks, lead=1)
        else:
            state = gather_population(stacks, self.mesh) if self._world > 1 else stacks
        if c_global is not None:
            state["c_global"] = c_global if self._split is None else self._split.gather(c_global)
        return state

    def shard_state(self) -> Dict[str, Any]:
        """This rank's own part of :meth:`state_dict`, under the same keys and
        with nothing gathered: its slab of the stacks (over ``nodes``
        ranks), its slices of every split leaf (over ``model`` ranks), the
        whole state on one process. :meth:`state_shards` describes it."""
        if self._closed:
            raise RuntimeError("simulation is closed — snapshot state before close()")
        state: Dict[str, Any] = {"params_stack": self.params_stack, "opt_stack": self.opt_stack}
        if self.algorithm == "scaffold":
            state["c_stack"] = self.c_stack
        if self.algorithm == "scaffold" or self.server_tx is not None:
            state["c_global"] = self.c_global
        return state

    def state_shards(self) -> Any:
        """How :meth:`shard_state` splits over the ranks
        (:class:`~p2pfl_tpu_torch.population.sharding.StateShards`): over
        ``nodes`` ranks the stacks' leading axis, ``c_global`` whole; over
        ``model`` ranks every split leaf on its output dimension (after the
        stacks' node axis). None on one process."""
        from p2pfl_tpu_torch.population.sharding import population_shards

        if not self._ranked:
            return None
        state = self.shard_state()
        if self._split is not None:
            return self._split.state_shards(state, {k: 0 if k == "c_global" else 1 for k in state})
        return population_shards(state, self.mesh, whole=("c_global",))

    def close(self) -> None:
        """Release the population's device tensors."""
        self.params_stack = self.opt_stack = self.c_stack = self.c_global = None
        self.x = self.y = self.sample_mask = self.num_samples = self.x_test = self.y_test = None
        self._closed = True

    def __enter__(self) -> "MeshSimulation":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # --- trajectory ledger (sim<->real parity) -------------------------------------

    def attach_ledger(
        self, node: str = "mesh-sim", node_names: Optional[Sequence[str]] = None, run_id: Optional[str] = None,
    ) -> Any:
        """Emit the canonical trajectory-ledger event stream
        (:mod:`p2pfl_tpu_torch.telemetry.ledger`) from this simulation's
        rounds, as the JAX package's ``attach_ledger`` does: per round
        ``round_open`` (the sorted committee), one ``contribution_folded``
        per folded member, ``aggregate_committed`` (contributors, samples and,
        for the last round of each ``rounds_per_call`` chunk, the content hash
        of node 0's parameters after diffusion) and ``round_close``; the
        Byzantine nodes as ``chaos_fault`` events now. ``node_names`` maps
        node indices to names (default ``vnode/<i>``). Returns the ledger.
        Over ranks only rank 0 keeps one: elsewhere nothing is attached and
        None returns (over model ranks every rank still gathers node 0's
        whole leaves for each hash: attach on every rank)."""
        from p2pfl_tpu_torch.telemetry.ledger import LEDGERS

        self._ledger_hashes = True
        if self._rank != 0:
            return None

        if node_names is not None:
            names = [str(n) for n in node_names]
            if len(names) != self.logical_num_nodes:
                raise ValueError(f"node_names has {len(names)} entries for {self.logical_num_nodes} virtual nodes")
        else:
            names = [f"vnode/{i:05d}" for i in range(self.logical_num_nodes)]
        if run_id is not None:
            LEDGERS.configure(run_id)
        self._ledger = LEDGERS.get(node)
        self._ledger_names = names
        if self._byz is not None:
            for i in np.flatnonzero(self._byz.cpu().numpy() > 0):
                self._ledger.emit("chaos_fault", fault="byzantine", peer=names[int(i)], attack=self._byz_attack)
        return self._ledger

    def _ledger_emit_round(
        self, r: int, committee: torch.Tensor, fold_pos: Optional[torch.Tensor], with_hash: bool,
        whole: Optional[Params] = None,
    ) -> None:
        """Emit one completed round's events (see :meth:`attach_ledger`);
        ``whole``: node 0's gathered leaves over model ranks."""
        from p2pfl_tpu_torch.telemetry.ledger import canonical_params_hash

        led, names = self._ledger, self._ledger_names
        comm = [int(i) for i in committee.tolist()]
        samples = self.num_samples.cpu().numpy()
        led.emit("round_open", round=r, members=sorted(names[i] for i in comm))
        folded = comm if fold_pos is None else [comm[int(p)] for p in fold_pos.tolist()]
        total = 0
        for i in folded:
            n_i = int(samples[i])
            total += n_i
            led.emit("contribution_folded", round=r, sender=names[i], lag=0, num_samples=n_i)
        commit: Dict[str, Any] = {"contributors": sorted(names[i] for i in folded), "num_samples": total,
                                  "origin": "mesh"}
        if with_hash:
            commit["hash"] = canonical_params_hash(whole if whole is not None else
                                                   {k: v[0] for k, v in self.params_stack.items()})
        led.emit("aggregate_committed", round=r, **commit)
        led.emit("round_close", round=r)

    # --- device observatory ----------------------------------------------------------

    def _devobs_recorder(self) -> Any:
        """The simulation's flight recorder (lazy): chunk boundary events
        and tripwire dumps share the wire nodes' recorder machinery."""
        if self._recorder is None:
            from p2pfl_tpu_torch.telemetry.flight_recorder import FlightRecorder

            self._recorder = FlightRecorder(self._devobs_node)
        return self._recorder

    def devobs_summary(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """``(extras, extra_sketches)`` from the last run's device-
        observatory stream — what :meth:`fleet_snapshot` grafts onto its
        snapshot document (fed_top's LOSS / GNORM / HBM / TRIP columns and
        the fleet quantile rows)."""
        return devobs_summary_for(self._devobs_node, self._devobs_last)

    def fleet_health(self, result: SimulationResult, epochs: int = 1) -> Dict[str, np.ndarray]:
        """Per-virtual-node health arrays for the completed ``result``, as
        the JAX package computes them: ``participation`` (committee
        appearances) and ``rejections`` (Byzantine nodes' poisoned
        appearances) from the run's committees; ``step_time`` and
        ``round_lag`` apply the ``node_speed`` tiers to the measured mean
        step time (the fused round is lockstep, so per-node wall clocks are
        a model); ``cohort_fill`` is the share of rounds a node was
        solicited in. Plain numpy over ``[N]`` arrays."""
        if result.committees is None:
            raise ValueError("result carries no committee history")
        n = self.logical_num_nodes  # filler nodes are not fleet members
        rounds = int(result.committees.shape[0])
        steps_per_round = max(1, (int(self.x.shape[1]) // self.batch_size) * epochs)
        base_step_s = result.seconds_per_round / steps_per_round
        speed = np.asarray(self.node_speed, np.float32) if self.node_speed is not None else np.ones(n, np.float32)
        byz = self._byz.cpu().numpy()[:n] if self._byz is not None else np.zeros(n, np.float32)
        comm = np.asarray(result.committees).reshape(-1)
        participation = np.zeros(n, np.float32)
        np.add.at(participation, comm, 1.0)
        step_time = np.float32(base_step_s) * speed
        # A tier-s node's virtual clock covers rounds/s rounds in the time the
        # fleet covers `rounds`; faster tiers clamp to zero lag.
        round_lag = np.maximum(0.0, np.floor(rounds * (1.0 - 1.0 / speed)))
        return {
            "participation": participation,
            "step_time": step_time,
            "round_lag": round_lag.astype(np.float32),
            "round": (rounds - round_lag).astype(np.float32),
            "rejections": byz * participation,
            "cohort_fill": participation / np.float32(max(1, rounds)),
        }

    def fleet_snapshot(
        self, result: SimulationResult, epochs: int = 1, top_n: int = 16, path: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Observatory snapshot for the virtual fleet: the :meth:`fleet_health`
        arrays folded into quantile sketches plus a top-N straggler table,
        the devobs summary grafted on — the document shape the wire
        observatory writes (``scripts/fed_top.py`` renders it). ``path``
        additionally writes it atomically (over ranks, rank 0 alone)."""
        from p2pfl_tpu_torch.telemetry.observatory import population_snapshot, write_snapshot_doc

        health = self.fleet_health(result, epochs=epochs)
        names = [f"vnode/{i:05d}" for i in range(self.logical_num_nodes)]
        extras, extra_sketches = self.devobs_summary()
        if result.tripped is not None:
            extras["tripped"] = result.tripped.get("kind")
        snap = population_snapshot(
            observer="mesh-sim", node_names=names, metrics=health, top_n=top_n, extras=extras or None,
            extra_sketches=extra_sketches or None,
        )
        if path is not None and self._rank == 0:
            write_snapshot_doc(path, snap)
        return snap

    # --- cost analysis --------------------------------------------------------------

    def round_cost_analysis(
        self, epochs: int = 1, rounds_per_call: int = 1, eval_every: int = 1, devobs: Optional[bool] = None,
    ) -> Optional[Dict[str, float]]:
        """The work of one ``rounds_per_call``-round call at the simulation's
        current shapes, with the JAX package's keys: ``flops``,
        ``flops_per_round``, ``bytes_accessed``, ``bytes_accessed_per_round``,
        and ``attention_flops_per_round``, the flash calls' share.

        XLA's cost model has no torch twin, so the port counts what a call
        executes (:func:`p2pfl_tpu_torch.ops.cost.count_cost_of`): the FLOPs of
        every matrix product and convolution (``torch.utils.flop_counter``'s
        formulas), every flash call as one operation of its analytic work
        (:func:`~p2pfl_tpu_torch.ops.attention.attention_cost`: the causal
        triangle's products, the same on the card and the CPU), and as
        bytes the sizes of every counted op's tensor inputs and outputs. The
        rounds run on a copy of the population state at the next round
        indices (committees voted as ``run`` would), with the global
        generators saved and restored, so ``completed_rounds`` and a later
        ``run``'s trajectory are unchanged; the card's launch counters do
        count the call's kernels. ``devobs`` (default
        ``Settings.DEVOBS_ENABLED``) counts the device-observatory aux too.
        Returns ``None`` when the count fails. Over more than one rank it
        raises ``NotImplementedError`` (ROADMAP queue A item A7)."""
        if self._closed or self.params_stack is None:
            raise RuntimeError("simulation has no live population state")
        if self._world > 1:
            raise NotImplementedError("the cost analysis of a round over ranks is not ported yet (ROADMAP queue A "
                                      "item A7: dryrun_multichip and the round's counts over real ranks)")
        from p2pfl_tpu_torch.ops.cost import count_cost_of

        devobs = bool(Settings.DEVOBS_ENABLED) if devobs is None else bool(devobs)
        start = self.completed_rounds
        st = state_map(torch.clone, self._state())

        def rounds() -> None:
            for i in range(rounds_per_call):
                r = start + i
                do_eval = (r + 1) % eval_every == 0 or i == rounds_per_call - 1
                self._round(st, r, epochs, None, do_eval, None, devobs)
            self._sync()

        counter = count_cost_of(rounds)
        del st
        if counter is None:
            return None
        return {
            "flops": float(counter.flops),
            "flops_per_round": counter.flops / rounds_per_call,
            "bytes_accessed": float(counter.bytes),
            "bytes_accessed_per_round": counter.bytes / rounds_per_call,
            "attention_flops_per_round": counter.opaque_flops / rounds_per_call,
        }

    # --- checkpoint / resume ------------------------------------------------------

    def save_to(self, checkpointer) -> bool:
        """Snapshot the population state at the current completed-round
        count, with the meta record the JAX package writes: the round
        cursor, the seed, the DP step counters and parameters, and the
        server optimizer's name and lr; and the padded population size.
        Over ranks a collective and a sharded step: each rank writes
        :meth:`shard_state` (its slab, or its slices), rank 0 the
        replicated leaves and the commit; nothing is gathered."""
        return checkpointer.save(
            self.completed_rounds,
            self.shard_state(),
            {
                "completed_rounds": self.completed_rounds,
                "seed": self.seed,
                "padded_nodes": self.num_nodes,
                # The privacy spend survives a resume; the DP parameters are
                # pinned so a resume cannot re-price the restored steps.
                "dp_steps_per_node": self._dp_steps_per_node,
                "nonprivate_steps_per_node": self._nonprivate_steps_per_node,
                "dp_noise_multiplier": self.dp_noise_multiplier,
                "dp_clip_norm": self.dp_clip_norm,
                # FedOpt pin: adam and yogi share a state structure, so a
                # mismatch would restore cleanly and silently diverge.
                "server_opt": self._server_opt_name,
                "server_lr": self._server_lr,
            },
            shards=self.state_shards(),
        )

    def load_from(self, checkpointer, step: Optional[int] = None) -> int:
        """Restore the population state (the newest restorable step by
        default) onto this simulation's device; returns the restored round
        count.

        The meta's configuration pins are checked before the state is read
        (:meth:`_check_restore_pins`), and meta and state come from one step
        (``restore_coherent``). The checkpointed seed is adopted: round
        draws are keyed by ``(seed, round)``. The DP step counters become
        the larger of the restored and the live values. Either layout
        restores at any world size: over ranks (a collective) each rank
        reads the saved parts that overlap its own and every rank restores
        the same step; a step whose population was padded to another size
        raises.
        """
        if self._closed:
            raise RuntimeError(
                "simulation is closed (close() also released its training data, which checkpoints do not "
                "carry) — construct a new MeshSimulation and load_from() that"
            )
        if self.params_stack is None:
            # A chunk failed and the state was dropped: restore into a fresh
            # initial state of the same structure.
            self.params_stack, self.opt_stack, self.c_stack, self.c_global = self._initial_state()
        state, meta = checkpointer.restore_coherent(self.shard_state(), step, check_meta=self._check_restore_pins,
                                                    shards=self.state_shards())
        self.params_stack = state["params_stack"]
        self.opt_stack = state["opt_stack"]
        if self.algorithm == "scaffold":
            self.c_stack = state["c_stack"]
        if self.algorithm == "scaffold" or self.server_tx is not None:
            self.c_global = state["c_global"]
        self.completed_rounds = int(meta.get("completed_rounds", 0))
        self._dp_steps_per_node = max(self._dp_steps_per_node, int(meta.get("dp_steps_per_node", 0)))
        self._nonprivate_steps_per_node = max(
            self._nonprivate_steps_per_node, int(meta.get("nonprivate_steps_per_node", 0)))
        if self.dp_clip_norm > 0.0 and "dp_noise_multiplier" not in meta:
            # A checkpoint without DP parameters: the restored weights embed
            # training of unknown (non-private) provenance.
            self._nonprivate_steps_per_node = max(self._nonprivate_steps_per_node, 1)
        if "seed" in meta and int(meta["seed"]) != self.seed:
            self.seed = int(meta["seed"])
        return self.completed_rounds

    def _check_restore_pins(self, meta: dict) -> None:
        """Raise ValueError when ``meta`` pins a configuration this
        simulation does not match (run before the structural restore)."""
        if "padded_nodes" in meta and int(meta["padded_nodes"]) != self.num_nodes:
            raise ValueError(
                f"checkpoint holds a population padded to {meta['padded_nodes']} nodes; this simulation pads its "
                f"{self.logical_num_nodes} nodes to {self.num_nodes}: a restore neither drops nor invents rows"
            )
        if (self.dp_clip_norm > 0.0 and "dp_noise_multiplier" in meta
                and (float(meta["dp_noise_multiplier"]) != self.dp_noise_multiplier
                     or float(meta.get("dp_clip_norm", 0.0)) != self.dp_clip_norm)):
            raise ValueError(
                f"checkpoint was written with DP parameters (sigma={meta['dp_noise_multiplier']}, "
                f"clip={meta.get('dp_clip_norm')}) that differ from this simulation's "
                f"(sigma={self.dp_noise_multiplier}, clip={self.dp_clip_norm}); resuming would re-price the "
                "restored steps and invalidate privacy_spent()"
            )
        saved_opt = meta.get("server_opt")
        if saved_opt != self._server_opt_name or (
                saved_opt not in (None, "custom") and float(meta.get("server_lr", 0.0)) != self._server_lr):
            raise ValueError(
                f"checkpoint was written with server_optimizer={saved_opt!r} (lr={meta.get('server_lr')}) but "
                f"this simulation uses {self._server_opt_name!r} (lr={self._server_lr}); resuming would apply the "
                "restored server moments through a different update rule ('custom' transforms are matched by "
                "label only)"
            )


def _first_trip(flags: np.ndarray, first_round: int, chunk: int) -> Optional[Dict[str, Any]]:
    """The first trip of a chunk from its ``[rounds, 2]`` (nonfinite,
    diverged) flags, as the JAX package picks it: the earlier round, and
    ``"nonfinite"`` before ``"loss_diverge"`` in the same round; None if
    no round flagged."""
    trips = [(kind, first_round + int(np.flatnonzero(col)[0]))
             for kind, col in (("nonfinite", flags[:, 0]), ("loss_diverge", flags[:, 1])) if col.any()]
    if not trips:
        return None
    kind, rnd = min(trips, key=lambda kv: kv[1])
    return {"kind": kind, "round": rnd, "chunk": chunk}


def _stack_partitions(partitions: Sequence[FederatedDataset]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stack per-node train splits into ``[N, S_max, ...]`` with validity
    masks (padding rows are masked out of the loss)."""
    xs, ys = zip(*(p.export_arrays(train=True) for p in partitions))
    s_max = max(x.shape[0] for x in xs)
    n = len(xs)
    x_stack = np.zeros((n, s_max) + xs[0].shape[1:], xs[0].dtype)
    y_stack = np.zeros((n, s_max), np.int32)
    m_stack = np.zeros((n, s_max), np.float32)
    for i, (x, y) in enumerate(zip(xs, ys)):
        x_stack[i, : x.shape[0]] = x
        y_stack[i, : y.shape[0]] = y
        m_stack[i, : y.shape[0]] = 1.0
    return x_stack, y_stack, m_stack
