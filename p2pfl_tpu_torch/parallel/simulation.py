"""Federated-population simulation on one card (counterpart of
``p2pfl_tpu/parallel/simulation.py``): the classification and causal-LM
tasks with the JAX package's round options.

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
examples for flash models for the same reason).

RNG: JAX threefry keys and torch generators give different streams, so the
port's draws are its own, from seeded CPU ``torch.Generator``s keyed by the
absolute round index (the vote: ``(seed, round, 0)``; member ``pos``'s
shuffles and DP noise: ``(seed, round, 1, pos)``; ``per_node_init``: ``(seed,
0, 2, node)``). Parity tests pass the same ``committee_schedule`` to both
and use one batch per node.
"""

from __future__ import annotations

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
from p2pfl_tpu_torch.models.model_handle import ModelHandle
from p2pfl_tpu_torch.ops import aggregation as agg_ops
from p2pfl_tpu_torch.optim import adam, sgd, state_map, yogi
from p2pfl_tpu_torch.parallel.mesh import Mesh

Params = Dict[str, torch.Tensor]
Aggregate = Callable[[Params, torch.Tensor], Params]
BatchLoss = Callable[[Params, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def _not_ported(what: str, plane: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (it comes with {plane})")


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


def local_train_step(
    params: Params,
    opt_state: Any,
    gen: torch.Generator,
    x: torch.Tensor,
    y: torch.Tensor,
    w: torch.Tensor,
    c_i: Optional[Params] = None,
    *,
    c_global: Optional[Params] = None,
    epochs: int,
    batch_loss: BatchLoss,
    optimizer: Any,
    batch_size: int,
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
    loss."""
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
        seed: round RNG seed (OS entropy when None).
        mesh: a one-device :class:`~p2pfl_tpu_torch.parallel.mesh.Mesh`; its
            ``"nodes"`` axis size is the default ``pad_to_multiple``.
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
        node_speed: ``[N]`` positive speed tiers (validated and kept; the
            virtual fleet health that reads them is not ported yet).
        canonical_committee: sort each voted committee by node index.
        pad_to_multiple: pad the population with zero-weight filler nodes,
            never elected, to a multiple of this.
        device: where the population lives (default ``"cuda"``; raises
            when no card is visible).
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
        self.mesh = mesh
        self.aggregate_fn: Aggregate = aggregate_fn if aggregate_fn is not None else agg_ops.fedavg
        self._byz_attack = byzantine_attack
        self._per_example = "loop" if uses_flash(model.module) else "vmap"

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
        if byzantine_mask is not None:
            byz = np.asarray(byzantine_mask, np.float32)
            if byz.shape != (self.num_nodes,):
                raise ValueError(
                    f"byzantine_mask has shape {byz.shape}, expected ({self.num_nodes},) — "
                    "one flag per node"
                )
            self._byz = torch.as_tensor(byz, device=self.device)
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
        self.x = self._to_device(x)
        self.y = self._to_device(y)
        self.sample_mask = torch.as_tensor(mask, dtype=torch.float32, device=self.device)
        self.num_samples = self.sample_mask.sum(dim=1)  # [N] FedAvg weights
        self.x_test = self._to_device(x_test) if x_test is not None else None
        self.y_test = self._to_device(y_test) if y_test is not None else None

        # --- population state ---------------------------------------------------
        n = self.num_nodes
        template = {k: v.detach().to(self.device, torch.float32) for k, v in model.params.items()}
        self.params_stack: Params = {k: v[None].repeat((n,) + (1,) * v.dim()) for k, v in template.items()}
        if per_node_init:
            for i in range(n):
                gen = _generator(self.seed, 0, 2, i)
                for k, v in self.params_stack.items():
                    v[i] += (0.01 * torch.randn(v.shape[1:], generator=gen)).to(self.device, v.dtype)
        self.opt_stack = state_map(lambda a: a[None].repeat((n,) + (1,) * a.dim()), self.optimizer.init(template))
        if algorithm == "scaffold":
            self.c_stack: Params = {k: torch.zeros_like(v) for k, v in self.params_stack.items()}
            self.c_global: Dict[str, Any] = {k: torch.zeros_like(v) for k, v in template.items()}
        elif self.server_tx is not None:
            self.c_stack = {}
            self.c_global = {"server_opt": self.server_tx.init(template)}
        else:
            self.c_stack, self.c_global = {}, {}
        # Per-node DP-SGD steps, counted as if every node trained every round
        # (an upper bound on the committee's spend); any non-private step
        # voids the epsilon claim.
        self._dp_steps_per_node = 0
        self._nonprivate_steps_per_node = 0
        self.completed_rounds = 0
        self._closed = False
        self._ledger: Any = None  # attach_ledger: None = no emission
        self._ledger_names: Optional[List[str]] = None

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
        do_eval: bool, fold_pos: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Run one round on the state ``st`` (``params``, ``opt``, ``c``,
        ``c_global``), in place; returns ``(committee, train_loss,
        test_loss, test_acc)`` (NaN test values when ``do_eval`` is off)."""
        params, opt, scaffold = st["params"], st["opt"], self.algorithm == "scaffold"
        if committee is None:
            committee = vote_committee(
                _generator(self.seed, round_idx, 0), self.logical_num_nodes, self.train_set_size)
            if self.canonical_committee:
                committee = torch.sort(committee).values
        idx = committee.to(self.device)
        # The members' round-start models, for the update transforms below.
        p_k = {k: v[idx] for k, v in params.items()} if self._byz is not None or self.clip_update_norm else {}
        members: List[Params] = []
        losses = []
        for pos, node in enumerate(committee.tolist()):
            p_i, o_i, loss = local_train_step(
                {k: v[node] for k, v in params.items()}, state_map(lambda a: a[node], opt),
                _generator(self.seed, round_idx, 1, pos),
                self.x[node], self.y[node], self.sample_mask[node],
                {k: v[node] for k, v in st["c"].items()} if scaffold else None,
                c_global=st["c_global"] if scaffold else None,
                epochs=epochs, batch_loss=self._batch_loss, optimizer=self.optimizer,
                batch_size=self.batch_size, fedprox_mu=self.fedprox_mu,
                dp_clip_norm=self.dp_clip_norm, dp_noise_multiplier=self.dp_noise_multiplier,
                scaffold=scaffold, per_example=self._per_example,
            )
            state_map(lambda a, u: a[node].copy_(u), opt, o_i)  # only members write back
            members.append(p_i)
            losses.append(loss)
        p_k_new = agg_ops.tree_stack(members)
        del members

        def per_member(v: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
            return v.reshape((-1,) + (1,) * (ref.dim() - 1))

        if self._byz is not None:
            bz = self._byz[idx]
            p_k_new = {
                k: torch.where(per_member(bz, new) > 0, poison_delta(new, p_k[k], self._byz_attack),
                               new.float()).to(new.dtype)
                for k, new in p_k_new.items()
            }
        if self.clip_update_norm > 0.0:
            sq = sum(((new.float() - p_k[k].float()) ** 2).reshape(new.shape[0], -1).sum(dim=1)
                     for k, new in p_k_new.items())
            scale = torch.clamp(self.clip_update_norm / torch.sqrt(sq + 1e-12), max=1.0)
            p_k_new = {
                k: (p_k[k].float() + (new.float() - p_k[k].float()) * per_member(scale, new)).to(new.dtype)
                for k, new in p_k_new.items()
            }

        weights = self.num_samples[idx]
        if scaffold:
            # Server step: x <- x + lr_g mean(dy); c <- c + K/N mean(dc);
            # member variates c_i' = c_i - c + (x - y_i) / (steps * lr).
            anchor = {k: v[0] for k, v in params.items()}  # the shared round start
            scale = 1.0 / ((self.x.shape[1] // self.batch_size) * epochs * self.lr)
            dy = {k: new.float() - anchor[k].float()[None] for k, new in p_k_new.items()}
            c_k = {k: v[idx] for k, v in st["c"].items()}
            c_k_new = {k: c_k[k] - st["c_global"][k][None] - dy[k] * scale for k in c_k}
            dc = {k: c_k_new[k] - c_k[k] for k in c_k}
            new_global, st["c_global"] = agg_ops.scaffold_update(
                anchor, st["c_global"], dy, dc, self.scaffold_global_lr, float(self.logical_num_nodes))
            agg = {k: g.to(anchor[k].dtype) for k, g in new_global.items()}
            for k, v in st["c"].items():
                v[idx] = c_k_new[k]
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
        del p_k_new, p_k
        # Diffusion: every node adopts the aggregate (gossip's fixed point).
        for k, v in params.items():
            v.copy_(agg[k][None].expand_as(v))
        if do_eval and self.x_test is not None:
            test_loss, test_acc = self._evaluate(agg)
        elif self.x_test is None:
            test_loss = test_acc = torch.zeros((), device=self.device)
        else:
            test_loss = test_acc = torch.full((), float("nan"), device=self.device)
        return committee, torch.stack(losses).mean(), test_loss, test_acc

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
        ``rounds_per_call`` (the JAX package's compiled chunk of rounds) is
        validated; the port launches every round on its own, in order, with
        RNG keyed by the absolute round index, so it changes nothing else.
        ``eval_every=k`` evaluates every k-th round (absolute index) and
        always the final one; ``test_acc`` / ``test_loss`` hold only the
        evaluated rounds. ``committee_schedule`` (``[rounds, K]`` node
        indices in the logical population) replaces the per-round vote; row
        ``i`` drives round ``completed_rounds + i``. ``fold_schedule``
        (``[rounds, K_f]`` positions into the same round's committee row)
        aggregates only those members; the others still train. The timed
        region ends in ``torch.cuda.synchronize()`` when the population is
        on a card. With a ledger attached (:meth:`attach_ledger`) every round
        emits its events. ``checkpointer`` and a non-empty ``profile_dir`` are
        not ported yet and raise ``NotImplementedError``.
        """
        if self._closed:
            raise RuntimeError("simulation is closed — construct a new MeshSimulation")
        if checkpointer is not None:
            raise _not_ported("run(checkpointer=...)", "management/checkpoint.py")
        if profile_dir:
            raise _not_ported("run(profile_dir=...)", "management/profiler.py")
        if int(rounds) != rounds or rounds < 1:
            raise ValueError(f"rounds must be a positive integer, got {rounds!r}")
        for name, val in (("rounds_per_call", rounds_per_call), ("eval_every", eval_every),
                          ("checkpoint_every", checkpoint_every)):
            if int(val) != val or val < 1:
                raise ValueError(f"{name} must be a positive integer, got {val!r}")
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

        committees, test_loss, test_acc = [], [], []
        st = self._state()
        t0 = time.monotonic()
        for i in range(rounds):
            r = start + i
            do_eval = (r + 1) % eval_every == 0 or i == rounds - 1
            comm, _, tl, ta = self._round(st, r, epochs, row(sched, i), do_eval, row(fsched, i))
            if self._ledger is not None:
                self._ledger_emit_round(r, comm, row(fsched, i),
                                        (i + 1) % rounds_per_call == 0 or i == rounds - 1)
            committees.append(comm)
            test_loss.append(tl)
            test_acc.append(ta)
        self._sync()
        dt = time.monotonic() - t0
        self.opt_stack, self.c_global = st["opt"], st["c_global"]
        self.completed_rounds = start + rounds
        steps = rounds * epochs * (self.x.shape[1] // self.batch_size)
        if self.dp_clip_norm > 0.0:
            self._dp_steps_per_node += steps
        else:
            self._nonprivate_steps_per_node += steps
        loss_all = torch.stack(test_loss).cpu().numpy()
        acc_all = torch.stack(test_acc).cpu().numpy()
        evaluated = ~np.isnan(acc_all)
        return SimulationResult(
            rounds=rounds,
            seconds_total=dt,
            seconds_per_round=dt / rounds,
            test_acc=[float(a) for a in acc_all[evaluated]],
            test_loss=[float(v) for v in loss_all[evaluated]],
            committees=torch.stack(committees).numpy(),
        )

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
        """One node's model (all equal after diffusion), as a new handle."""
        if self._closed:
            raise RuntimeError("simulation closed — extract the model before close()")
        return ModelHandle({k: v[node].clone() for k, v in self.params_stack.items()}, self.model.module)

    def state_dict(self) -> Dict[str, Any]:
        """The population state: stacked params and optimizer state, plus
        SCAFFOLD's variates and the server optimizer's state where used."""
        if self._closed:
            raise RuntimeError("simulation is closed — snapshot state before close()")
        state: Dict[str, Any] = {"params_stack": self.params_stack, "opt_stack": self.opt_stack}
        if self.algorithm == "scaffold":
            state["c_stack"] = self.c_stack
        if self.algorithm == "scaffold" or self.server_tx is not None:
            state["c_global"] = self.c_global
        return state

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
        node indices to names (default ``vnode/<i>``). Returns the ledger."""
        from p2pfl_tpu_torch.telemetry.ledger import LEDGERS

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
    ) -> None:
        """Emit one completed round's events (see :meth:`attach_ledger`)."""
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
            commit["hash"] = canonical_params_hash({k: v[0] for k, v in self.params_stack.items()})
        led.emit("aggregate_committed", round=r, **commit)
        led.emit("round_close", round=r)

    # --- planes not ported yet ----------------------------------------------------

    def save_to(self, checkpointer) -> bool:
        raise _not_ported("MeshSimulation.save_to", "management/checkpoint.py")

    def load_from(self, checkpointer, step: Optional[int] = None) -> int:
        raise _not_ported("MeshSimulation.load_from", "management/checkpoint.py")

    def round_cost_analysis(self, *args, **kwargs):
        raise _not_ported("MeshSimulation.round_cost_analysis", "management/profiler.py")


    def devobs_summary(self):
        raise _not_ported("MeshSimulation.devobs_summary (the device observatory)", "telemetry/sketches.py")

    def fleet_health(self, result: SimulationResult, epochs: int = 1):
        raise _not_ported("MeshSimulation.fleet_health", "the observatory (telemetry/)")

    def fleet_snapshot(self, result: SimulationResult, *args, **kwargs):
        raise _not_ported("MeshSimulation.fleet_snapshot", "the observatory (telemetry/)")


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
