"""Federated-population simulation on one card (counterpart of
``p2pfl_tpu/parallel/simulation.py``; this slice ports the causal-LM task).

The population lives on the device as stacked ``[N, ...]`` tensors: every
node's parameters and Adam state. One round is the JAX package's round
body: elect a committee (or take a schedule row), train each member
locally, FedAvg the members' models weighted by their sample counts,
diffuse the aggregate to every node (committee members keep their updated
optimizer state), and evaluate the aggregate on the test split.

Where the JAX package ``vmap``s local training over the committee inside one
XLA program, the port loops over the members in Python: each member's
training is independent, and the flash kernels' ``autograd.Function`` is not
run under ``torch.func.vmap``.

RNG: JAX threefry keys and torch generators give different streams, so the
port's elections and shuffles are its own (same rule, a seeded
``torch.Generator`` per round). Parity tests pass the same
``committee_schedule`` to both and use one batch per node.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from p2pfl_tpu_torch.device import DeviceLike, resolve_device
from p2pfl_tpu_torch.learning.learner import masked_lm_loss
from p2pfl_tpu_torch.models.model_handle import ModelHandle
from p2pfl_tpu_torch.ops.aggregation import fedavg
from p2pfl_tpu_torch.optim import AdamState, adam_init, adam_step

Params = Dict[str, torch.Tensor]
TRAIN_SET_SIZE = 4  # the JAX package's Settings.TRAIN_SET_SIZE default


def _generator(*words: int) -> torch.Generator:
    """A CPU generator seeded from a tuple of ints (the port's ``fold_in``)."""
    seed = int(np.random.SeedSequence([int(w) for w in words]).generate_state(1, np.uint64)[0])
    return torch.Generator().manual_seed(seed)


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
    opt_state: AdamState,
    gen: torch.Generator,
    x: torch.Tensor,
    y: torch.Tensor,
    w: torch.Tensor,
    *,
    epochs: int,
    batch_loss: Callable[[Params, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
    lr: float,
    batch_size: int,
) -> Tuple[Params, AdamState, torch.Tensor]:
    """One node's local training: ``epochs`` passes over shuffled fixed-size
    batches (a tail short of ``batch_size`` is dropped), one Adam step per
    batch. Returns the new params, the new state and the mean loss."""
    steps = x.shape[0] // batch_size
    if steps < 1:
        raise ValueError(f"batch_size {batch_size} exceeds the {x.shape[0]} samples per node")
    epoch_losses = []
    for _ in range(epochs):
        perm = torch.randperm(x.shape[0], generator=gen)[: steps * batch_size].to(x.device)
        losses = []
        for s in range(steps):
            idx = perm[s * batch_size:(s + 1) * batch_size]
            leaves = {n: p.detach().requires_grad_(True) for n, p in params.items()}
            loss = batch_loss(leaves, x[idx], y[idx], w[idx])
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            params, opt_state = adam_step(params, grads, opt_state, lr)
            losses.append(loss.detach())
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


class MeshSimulation:
    """Simulate an N-node federation on one device.

    Args:
        model: template :class:`ModelHandle`; every node starts from its params.
        partitions: pre-stacked ``(x, y, sample_mask)`` with a leading node
            axis: ``x`` tokens ``[N, S, L]``, ``y`` unused by the LM task,
            ``sample_mask`` ``[N, S]`` (0 marks a padded sequence).
        test_data: ``(x_test, y_test)``; the LM task reads ``x_test [T, L]``.
        train_set_size: committee size per round.
        batch_size: per-node local batch size.
        lr: Adam learning rate.
        seed: round RNG seed (OS entropy when None).
        task: ``"lm"`` (the only task of this slice).
        device: where the population lives (default ``"cuda"``; raises
            when no card is visible).
    """

    def __init__(
        self,
        model: ModelHandle,
        partitions: Tuple[np.ndarray, np.ndarray, np.ndarray],
        test_data: Optional[Tuple[np.ndarray, Optional[np.ndarray]]] = None,
        train_set_size: Optional[int] = None,
        batch_size: int = 64,
        lr: float = 1e-3,
        seed: Optional[int] = None,
        task: str = "lm",
        device: DeviceLike = "cuda",
    ) -> None:
        if task != "lm":
            raise ValueError(f"task {task!r} is not ported yet (only 'lm')")
        self.device = resolve_device(device)
        self.model = model
        self.batch_size = int(batch_size)
        self.lr = float(lr)
        self.seed = int(seed) if seed is not None else int(np.random.SeedSequence().entropy % 2**63)
        x, y, mask = partitions
        self.x = torch.as_tensor(np.asarray(x), dtype=torch.long, device=self.device)
        self.y = torch.as_tensor(np.asarray(y), device=self.device)
        self.sample_mask = torch.as_tensor(np.asarray(mask), dtype=torch.float32, device=self.device)
        self.num_nodes = int(self.x.shape[0])
        self.num_samples = self.sample_mask.sum(dim=1)  # [N] FedAvg weights
        self.train_set_size = int(min(train_set_size or TRAIN_SET_SIZE, self.num_nodes))
        self.x_test = (
            torch.as_tensor(np.asarray(test_data[0]), dtype=torch.long, device=self.device)
            if test_data is not None and test_data[0] is not None
            else None
        )
        n = self.num_nodes
        self.params_stack: Params = {
            k: v.detach().to(self.device, torch.float32)[None].repeat((n,) + (1,) * v.dim())
            for k, v in model.params.items()
        }
        self.opt_stack: AdamState = adam_init(self.params_stack, (n,))
        self.completed_rounds = 0

    # --- one round ------------------------------------------------------------

    def _batch_loss(self, params: Params, bx: torch.Tensor, by: torch.Tensor, bw: torch.Tensor) -> torch.Tensor:
        return masked_lm_loss(self.model.apply(params, bx), bx, bw)

    @torch.no_grad()
    def _evaluate(self, agg: Params) -> Tuple[torch.Tensor, torch.Tensor]:
        xt = self.x_test
        logits = self.model.apply(agg, xt)  # [T, L, V]
        loss = masked_lm_loss(logits, xt, torch.ones(xt.shape[0], device=self.device))
        pred = torch.argmax(logits[:, :-1], dim=-1)
        acc = (pred == xt[:, 1:]).float().mean()
        return loss, acc

    def _round(
        self, params_stack: Params, opt_stack: AdamState, round_idx: int, epochs: int,
        committee: Optional[torch.Tensor],
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Run one round in place on the stacks; returns
        ``(committee, train_loss, test_loss, test_acc)``."""
        if committee is None:
            committee = vote_committee(
                _generator(self.seed, round_idx, 0), self.num_nodes, self.train_set_size
            )
        members: List[Params] = []
        losses = []
        for pos, node in enumerate(committee.tolist()):
            p_i = {k: v[node] for k, v in params_stack.items()}
            o_i = AdamState(
                mu={k: v[node] for k, v in opt_stack.mu.items()},
                nu={k: v[node] for k, v in opt_stack.nu.items()},
                count=opt_stack.count[node],
            )
            p_i, o_i, loss = local_train_step(
                p_i, o_i, _generator(self.seed, round_idx, 1, pos),
                self.x[node], self.y[node], self.sample_mask[node],
                epochs=epochs, batch_loss=self._batch_loss, lr=self.lr,
                batch_size=self.batch_size,
            )
            # Only committee members write back their optimizer state.
            for k in opt_stack.mu:
                opt_stack.mu[k][node] = o_i.mu[k]
                opt_stack.nu[k][node] = o_i.nu[k]
            opt_stack.count[node] = o_i.count
            members.append(p_i)
            losses.append(loss)
        stacked = {k: torch.stack([m[k] for m in members]) for k in params_stack}
        del members
        idx = committee.to(self.device)
        agg = fedavg(stacked, self.num_samples[idx])
        del stacked
        # Diffusion: every node adopts the aggregate (gossip's fixed point).
        for k, v in params_stack.items():
            v.copy_(agg[k][None].expand_as(v))
        if self.x_test is not None:
            test_loss, test_acc = self._evaluate(agg)
        else:
            test_loss = test_acc = torch.zeros((), device=self.device)
        return committee, torch.stack(losses).mean(), test_loss, test_acc

    # --- public API -------------------------------------------------------------

    def run(
        self,
        rounds: int,
        epochs: int = 1,
        warmup: bool = True,
        committee_schedule: Optional[np.ndarray] = None,
    ) -> SimulationResult:
        """Execute ``rounds`` federated rounds.

        With ``warmup`` one extra round runs first on a copy of the state
        (kernel builds, allocator growth and library setup fall outside the
        timing) and is thrown away. ``committee_schedule`` (``[rounds, K]``
        node indices) replaces the per-round vote; row ``i`` drives round
        ``completed_rounds + i``. The timed region ends in
        ``torch.cuda.synchronize()`` when the population is on a card.
        """
        if rounds < 1:
            raise ValueError(f"rounds must be >= 1, got {rounds}")
        sched: Optional[np.ndarray] = None
        if committee_schedule is not None:
            sched = np.asarray(committee_schedule, np.int64)
            if sched.ndim != 2 or sched.shape[0] != rounds or sched.shape[1] < 1:
                raise ValueError(
                    f"committee_schedule has shape {sched.shape}, expected ({rounds}, K>=1)"
                )
            if sched.min() < 0 or sched.max() >= self.num_nodes:
                raise ValueError(f"committee_schedule indices must be in [0, {self.num_nodes})")
        start = self.completed_rounds

        def row(i: int) -> Optional[torch.Tensor]:
            return None if sched is None else torch.from_numpy(sched[i])

        if warmup:
            # A round index the real run never uses, as in the JAX package.
            wp = {k: v.clone() for k, v in self.params_stack.items()}
            wo = AdamState(
                mu={k: v.clone() for k, v in self.opt_stack.mu.items()},
                nu={k: v.clone() for k, v in self.opt_stack.nu.items()},
                count=self.opt_stack.count.clone(),
            )
            self._round(wp, wo, start + rounds + 1, epochs, row(0))
            del wp, wo
            self._sync()

        committees, test_loss, test_acc = [], [], []
        t0 = time.monotonic()
        for i in range(rounds):
            comm, _, tl, ta = self._round(self.params_stack, self.opt_stack, start + i, epochs, row(i))
            committees.append(comm)
            test_loss.append(tl)
            test_acc.append(ta)
        self._sync()
        dt = time.monotonic() - t0
        self.completed_rounds = start + rounds
        return SimulationResult(
            rounds=rounds,
            seconds_total=dt,
            seconds_per_round=dt / rounds,
            test_acc=[float(a) for a in torch.stack(test_acc).cpu()],
            test_loss=[float(v) for v in torch.stack(test_loss).cpu()],
            committees=torch.stack(committees).numpy(),
        )

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
