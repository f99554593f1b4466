"""AsyncPopulationEngine — FedBuff windows over a population on one card
(counterpart of ``p2pfl_tpu/population/async_engine.py``).

The sync population engine runs *rounds*: every round trains a committee
and waits for all of it, so one tier-5 device in the cohort sets the round's
virtual clock. This engine runs *windows* (Papaya / FedBuff, arxiv
2111.04877): the streaming scheduler of
:mod:`p2pfl_tpu_torch.population.arrivals` decides on the host which cohort
members' contributions land in each window; each window trains exactly those
members against the HISTORICAL global they were solicited with, folds them
with the ``num_samples * staleness_discount(lag)`` weight
(:func:`~p2pfl_tpu_torch.learning.aggregators.async_buffer.staleness_discount`,
the function the wire buffer multiplies through) and closes by fill, timeout
or stall patience.

Where the JAX package scans a window program with static shapes inside one
XLA program, the port loops over windows and, inside a window, over the
folded members in Python, as the sync round loops over its committee. The
members of a window are a prefix of its schedule row, so absent slots are
not trained at all (the JAX package trains a throwaway idle vnode there to
keep its shapes static; a zero-weight term changes nothing but the fold's
summation order). Window fills, close codes and lag sums follow from the
host schedule; the device holds the state, the training, the fold and the
evaluation, and nothing waits for it inside a chunk.

Why this is bit-exact inside the port:

* **vs the sync engine** — at zero delay (all speed tiers 1.0, uniform
  trace) every window folds its full cohort fresh: the same sorted members,
  the same :func:`~p2pfl_tpu_torch.parallel.simulation.member_generator`
  (origin window, rank) as the sync round's (round, position), a discount
  of exactly 1.0 and the same ``fedavg`` call, so the window IS the sync
  round;
* **vs the wire async buffer** — :func:`wire_window_replay` drives the real
  :class:`~p2pfl_tpu_torch.learning.aggregators.async_buffer.AsyncBufferedAggregator`
  through the same schedule (same anchors, generators, fold order and f32
  weight product), and ``scripts/parity_diff.py`` aligns the two ledgers
  event for event, aggregate hashes included.

Memory: there is no per-vnode parameter stack. Every vnode trains from a
global, so the engine holds a ``[max_lag + 1]``-deep *history ring* of
globals (a member folding with lag ``l`` anchors at ``history[l]``), updated
in place, plus the ``[N]`` optimizer stack (empty for the default SGD): the
per-vnode data is the only O(N) state. ``state_dtype="bfloat16"`` halves the
ring for ceiling probes (not bit-comparable to the f32 wire path).

Tracing: each part of a window runs inside a ``torch.profiler``
``record_function`` range named in :data:`TRACE_RANGES`, so a device trace
of a chunk (``run``'s ``profile_dir``) splits the window's host time by part
(``scripts/torch_asyncpop_breakdown.py`` reads it). Outside a profiler the
ranges cost a few microseconds a window.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.device import DeviceLike, resolve_device
from p2pfl_tpu_torch.learning.aggregators.async_buffer import staleness_discount
from p2pfl_tpu_torch.learning.learner import softmax_cross_entropy
from p2pfl_tpu_torch.ops import aggregation as agg_ops
from p2pfl_tpu_torch.optim import state_map
from p2pfl_tpu_torch.parallel.mesh import make_mesh
from p2pfl_tpu_torch.parallel.simulation import (
    devobs_summary_for,
    fold_devobs_rows,
    local_train_step,
    member_generator,
)
from p2pfl_tpu_torch.population.arrivals import (
    CLOSE_FILL,
    CLOSE_REASONS,
    CLOSE_STALL,
    CLOSE_TIMEOUT,
    AsyncWindowPlan,
    WindowSchedule,
    compile_window_schedule,
)
from p2pfl_tpu_torch.population.cohort import cohort_size
from p2pfl_tpu_torch.population.engine import population_data, vnode_names
from p2pfl_tpu_torch.telemetry.bundle import establish_run
from p2pfl_tpu_torch.telemetry.sketches import device_bucket_spec, device_bucket_stats

Params = Dict[str, torch.Tensor]

#: The ``record_function`` ranges of a window's parts, in the order they
#: run: the members' training, the fold, the devobs row, the ring shift, the
#: evaluation, then once a chunk the ledger's events and the devobs rows'
#: read-back.
TRACE_RANGES = ("asyncpop/members", "asyncpop/fold", "asyncpop/devobs", "asyncpop/ring", "asyncpop/eval",
                "asyncpop/ledger", "asyncpop/readback")


@dataclass
class AsyncRunResult:
    """Per-window metrics for one :meth:`AsyncPopulationEngine.run` call."""

    windows: int
    seconds_total: float
    seconds_per_window: float
    #: virtual ticks the whole call cost (sum of per-window durations — the
    #: number the sync comparison divides by; see ``simulated_barrier_time``).
    sim_time_ticks: float
    fills: np.ndarray  #: [W] folded contributions per window
    close_codes: np.ndarray  #: [W] CLOSE_FILL / CLOSE_TIMEOUT / CLOSE_STALL
    durations: np.ndarray  #: [W] virtual ticks per window
    lag_sums: np.ndarray  #: [W] summed fold lag (mean lag = lag_sum/fill)
    test_acc: List[float] = field(default_factory=list)
    test_loss: List[float] = field(default_factory=list)
    schedule: Optional[WindowSchedule] = None
    #: Device-observatory tripwire record ``{kind, round, chunk, action,
    #: flightrec, bundle}`` — present only on parked runs (``kind`` is
    #: nonfinite | loss_diverge); DEVOBS_TRIP_ACTION=abort raises instead.
    tripped: Optional[Dict[str, Any]] = None

    def summary(self) -> Dict[str, Any]:
        contribs = int(self.fills.sum())
        closes = {name: int((self.close_codes == code).sum()) for code, name in CLOSE_REASONS.items()}
        return {
            "windows": self.windows,
            "contributions": contribs,
            "mean_fill": float(self.fills.mean()) if self.windows else 0.0,
            "sim_time_ticks": self.sim_time_ticks,
            "contribs_per_tick": contribs / max(self.sim_time_ticks, 1e-12),
            "sec_per_window": self.seconds_per_window,
            "mean_lag": float(self.lag_sums.sum()) / max(1, contribs),
            "close_reasons": closes,
            "final_test_acc": self.test_acc[-1] if self.test_acc else float("nan"),
        }


@dataclass
class _WindowInputs:
    """One window's inputs: the folded members (a prefix of the schedule
    row), their lags, generators and f32 discounts."""

    members: List[int]
    lags: List[int]
    gens: List[torch.Generator]
    discount: Optional[torch.Tensor]  # [fill] f32 on the engine's device, None when empty


class AsyncPopulationEngine:
    """Cohort-streamed async windows over one card.

    Mirrors :class:`~p2pfl_tpu_torch.population.engine.PopulationEngine`'s
    population concerns (names, plan, absolute cursor, checkpoint replay)
    but owns its window loop — the round machinery in ``MeshSimulation``
    stays sync-only. The arguments are the JAX package's, in its order,
    with ``device`` last (default ``"cuda"``; tests pass ``"cpu"``);
    ``mesh`` is a :func:`~p2pfl_tpu_torch.parallel.mesh.make_mesh` mesh
    whose ``"nodes"`` size the data is padded to.
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
        speed_tiers: Tuple[float, ...] = (),
        trace: Optional[str] = None,
        trace_period: Optional[int] = None,
        flash_mult: Optional[float] = None,
        fill_fraction: Optional[float] = None,
        timeout_ticks: Optional[int] = None,
        stall_patience: Optional[int] = None,
        max_lag: Optional[int] = None,
        mesh: Any = None,
        state_dtype: Optional[str] = None,
        optimizer: Any = None,
        device: DeviceLike = "cuda",
    ) -> None:
        from p2pfl_tpu_torch.models.mlp import mlp_model
        from p2pfl_tpu_torch.optim import sgd

        if getattr(mesh, "ranked", False):
            raise NotImplementedError(
                "the population engines over a rank mesh are not ported yet (ROADMAP queue A item A6: sharded "
                "checkpoints and both population engines over ranks); MeshSimulation runs over ranks")
        if num_nodes < 1:
            raise ValueError(f"num_nodes must be >= 1, got {num_nodes}")
        self.device = resolve_device(device)
        self.num_nodes = int(num_nodes)
        self.seed = int(seed)
        # Join the federation-wide run context (see MeshSimulation): a
        # scenario pin in LEDGERS is adopted, else a seed-deterministic id
        # is minted under the shared "engine" name.
        establish_run(seed=self.seed, name="engine")
        self.names = vnode_names(self.num_nodes)
        self.plan = AsyncWindowPlan(
            seed=self.seed,
            fraction=float(cohort_fraction),
            min_size=int(cohort_min),
            churn_rate=float(churn_rate),
            names=tuple(self.names),
            trace=trace if trace is not None else Settings.ASYNCPOP_ARRIVAL_TRACE,
            period=trace_period,
            flash_mult=flash_mult,
            fill_fraction=fill_fraction,
            timeout_ticks=timeout_ticks,
            stall_patience=stall_patience,
            max_lag=max_lag,
        )
        self.cohort_k = cohort_size(self.num_nodes, float(cohort_fraction), int(cohort_min))
        (_, self._timeout_ticks, _, self.max_lag) = self.plan.resolved()
        # Config pins the wire replay rebuilds its inputs from (pure
        # functions of the seed — no host array copies are kept).
        self.config: Dict[str, Any] = dict(
            samples_per_node=int(samples_per_node),
            feature_dim=int(feature_dim),
            num_classes=int(num_classes),
            hidden=tuple(hidden),
            batch_size=int(batch_size),
            lr=float(lr),
            dirichlet_alpha=dirichlet_alpha,
            speed_tiers=tuple(speed_tiers),
        )
        (x, y, w), (x_eval, y_eval) = population_data(
            self.seed, self.num_nodes, samples_per_node=samples_per_node, feature_dim=feature_dim,
            num_classes=num_classes, dirichlet_alpha=dirichlet_alpha,
        )
        # Same tier derivation as PopulationEngine (seed + 0x7153), so a
        # sync baseline at the same seed shares this fleet's speed tiers.
        if speed_tiers:
            rng = np.random.default_rng(self.seed + 0x7153)
            self.node_speed = np.asarray(speed_tiers, np.float32)[
                rng.integers(0, len(speed_tiers), size=self.num_nodes)]
        else:
            self.node_speed = np.ones(self.num_nodes, np.float32)
        self.batch_size = int(batch_size)
        self.optimizer = optimizer if optimizer is not None else sgd(lr)
        self.model = mlp_model(seed=self.seed, input_shape=(feature_dim,), hidden_sizes=tuple(hidden),
                               out_channels=num_classes, device=self.device)
        self.mesh = mesh if mesh is not None else make_mesh(devices=[self.device])

        # --- [N] data, padded to the mesh's nodes axis ---------------------------
        self.logical_num_nodes = self.num_nodes
        n_pad = (-self.num_nodes) % int(self.mesh.shape.get("nodes", 1))
        if n_pad:
            x, y, w = (np.concatenate([a, np.zeros((n_pad,) + a.shape[1:], a.dtype)]) for a in (x, y, w))
        self._n_padded = self.num_nodes + n_pad
        self.x = torch.as_tensor(x, device=self.device)
        self.y = torch.as_tensor(y, device=self.device).long()
        self.sample_mask = torch.as_tensor(w, dtype=torch.float32, device=self.device)
        self.num_samples = self.sample_mask.sum(dim=1)  # [Np] f32
        self.x_test = torch.as_tensor(x_eval, device=self.device)
        self.y_test = torch.as_tensor(y_eval, device=self.device).long()

        # --- state: history ring [H, ...] + [N] optimizer stack -------------------
        dt = state_dtype if state_dtype is not None else Settings.ASYNCPOP_STATE_DTYPE
        if dt not in ("float32", "bfloat16"):
            raise ValueError(f"state_dtype must be float32|bfloat16, got {dt!r}")
        self.state_dtype = torch.bfloat16 if dt == "bfloat16" else torch.float32
        self._template: Optional[Params] = {
            k: v.detach().to(self.device, self.state_dtype) for k, v in self.model.params.items()}
        self.history_depth = self.max_lag + 1
        self.history: Optional[Params] = None
        self.opt_stack: Any = None
        self._reinit_population()

        self._ledger: Any = None
        # Device observatory (config.DEVOBS_*): the sync engine's static
        # bucket spec and host fold, under this engine's own node label.
        self._devobs_spec = device_bucket_spec()
        self._devobs_node = "asyncpop-engine"
        self._recorder: Any = None
        self._devobs_last: Dict[str, Any] = {}
        self._stall = 0
        self.completed_windows = 0
        self._fold_counts = np.zeros(self.num_nodes, np.float64)
        self._last_fold_window = np.full(self.num_nodes, -1, np.float64)
        self._lag_totals = np.zeros(self.num_nodes, np.float64)
        self._closed = False

    def _reinit_population(self) -> None:
        t = self._template
        self.history = {k: v[None].repeat((self.history_depth,) + (1,) * v.dim()) for k, v in t.items()}
        # Every vnode starts from the template, so the stack is the one
        # state broadcast (an empty state for SGD).
        n = self._n_padded
        self.opt_stack = state_map(lambda a: a[None].repeat((n,) + (1,) * a.dim()), self.optimizer.init(t))

    # --- schedule ------------------------------------------------------------

    def schedule(self, windows: int, start_window: Optional[int] = None) -> WindowSchedule:
        """The next ``windows`` fold rows at the absolute window cursor —
        resume-safe exactly like ``PopulationEngine.schedule``: a rebuilt
        engine that restored a checkpoint re-streams the identical
        window/arrival stream the dead one would have used."""
        start = self.completed_windows if start_window is None else int(start_window)
        return compile_window_schedule(self.plan, self.names, windows, start_window=start, speeds=self.node_speed)

    def _chunk_inputs(self, sched: WindowSchedule) -> List[_WindowInputs]:
        """Schedule rows -> one :class:`_WindowInputs` a window: the present
        members (a prefix of the row), their lags, their generators (the
        origin window's rank generator, the sync committee's derivation, so
        zero-lag windows reuse the sync generators) and their discounts,
        computed on the CPU as the wire buffer computes them."""
        alpha = float(Settings.ASYNC_STALENESS_ALPHA)
        out = []
        for wi in range(sched.windows):
            fill = int(sched.present[wi].sum())
            if not sched.present[wi, :fill].all():
                raise ValueError(f"window {sched.start_window + wi}: present slots are not a prefix of the row")
            lags = [int(v) for v in sched.lag[wi, :fill]]
            out.append(_WindowInputs(
                members=[int(v) for v in sched.members[wi, :fill]],
                lags=lags,
                gens=[member_generator(self.seed, int(o), int(r))
                      for o, r in zip(sched.origin[wi, :fill], sched.rank[wi, :fill])],
                discount=staleness_discount(lags, alpha).to(self.device) if fill else None,
            ))
        return out

    # --- one window -----------------------------------------------------------

    def _batch_loss(self, params: Params, bx: torch.Tensor, by: torch.Tensor, bw: torch.Tensor) -> torch.Tensor:
        return softmax_cross_entropy(self.model.apply(params, bx), by, bw)

    @torch.no_grad()
    def _evaluate(self, params: Params) -> Tuple[torch.Tensor, torch.Tensor]:
        logits = self.model.apply(params, self.x_test)
        loss = softmax_cross_entropy(logits, self.y_test, torch.ones(self.y_test.shape, device=self.device))
        acc = (torch.argmax(logits, dim=-1) == self.y_test).float().mean()
        return loss, acc

    def _window(
        self, history: Params, opt_stack: Any, inp: _WindowInputs, w_idx: int, epochs: int, do_eval: bool,
        devobs: bool,
    ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
        """Run one window on ``history`` / ``opt_stack`` in place: train the
        folded members against their anchors, fold them, shift the ring.
        Returns ``(test_loss, test_acc, aux)`` (NaN test values when
        ``do_eval`` is off; ``aux`` the devobs row and the folded members'
        mean loss, NaN for an empty window, or None)."""
        cur = {k: h[0] for k, h in history.items()}
        members, losses = [], []
        with record_function("asyncpop/members"):
            for node, lag, gen in zip(inp.members, inp.lags, inp.gens):
                anchor = {k: h[lag] for k, h in history.items()}
                p_i, o_i, loss = local_train_step(
                    anchor, state_map(lambda a: a[node], opt_stack), gen,
                    self.x[node], self.y[node], self.sample_mask[node], None,
                    c_global=None, epochs=epochs, batch_loss=self._batch_loss, optimizer=self.optimizer,
                    batch_size=self.batch_size,
                )
                state_map(lambda a, u: a[node].copy_(u), opt_stack, o_i)  # only folded members write back
                members.append(p_i)
                losses.append(loss)
        fill = len(members)
        wgt = None
        with record_function("asyncpop/fold"):
            if fill:
                # The wire weight product: f32 sample counts times ONE f32
                # multiply by the discount (exactly 1.0 at lag 0).
                idx = torch.as_tensor(inp.members, device=self.device)
                wgt = self.num_samples[idx] * inp.discount
                stacked = agg_ops.tree_stack(members)
                new_global = {k: v.to(cur[k].dtype) for k, v in agg_ops.fedavg(stacked, wgt).items()}
            else:
                new_global = {k: v.clone() for k, v in cur.items()}
            if int(Settings.DEVOBS_NAN_INJECT_ROUND) >= 0 and w_idx == int(Settings.DEVOBS_NAN_INJECT_ROUND):
                # Seeded fault injection (the sync rounds' knob, in absolute
                # WINDOW indices here).
                new_global = {k: torch.full_like(v, float("nan")) for k, v in new_global.items()}
        aux = None
        if devobs:
            with record_function("asyncpop/devobs"):
                anchors = [{k: history[k][lag] for k in history} for lag in inp.lags]
                win_loss = (torch.stack(losses).sum() / fill if fill
                            else torch.full((), float("nan"), device=self.device))
                aux = (self._devobs_aux(stacked if fill else None, anchors, new_global, losses, wgt), win_loss)
        # The ring shifts EVERY window (empty ones too): slot l always holds
        # the global l windows back.
        with record_function("asyncpop/ring"):
            for k, h in history.items():
                h[1:] = h[:-1].clone()
                h[0] = new_global[k]
        if do_eval:
            with record_function("asyncpop/eval"):
                test_loss, test_acc = self._evaluate({k: h[0] for k, h in history.items()})
        else:
            test_loss = test_acc = torch.full((), float("nan"), device=self.device)
        return test_loss, test_acc, aux

    def _devobs_aux(self, stacked: Optional[Params], anchors: List[Params], new_global: Params,
                    losses: List[torch.Tensor], wgt: Optional[torch.Tensor]) -> torch.Tensor:
        """One window's devobs row (the sync round's layout, computed on the
        device without waiting for it): bucket counts of the K slots' update
        norms — the folded members' ``||new - anchor||``, zeros for the empty
        slots as the JAX package masks them — then the nonfinite flag, the
        weight mass, the fill, and the norms' zeros, sum, min and max."""
        k = self.cohort_k
        fill = len(anchors)
        norms = torch.zeros(k, dtype=torch.float32, device=self.device)
        if fill:
            anchor = agg_ops.tree_stack(anchors)
            sq = sum(((new.float() - anchor[n].float()) ** 2).reshape(fill, -1).sum(dim=1)
                     for n, new in stacked.items())
            norms[:fill] = torch.sqrt(sq + 1e-12)
        gamma_log, lo_idx, nbins = self._devobs_spec
        stats = device_bucket_stats(norms, gamma_log=gamma_log, lo_idx=lo_idx, nbins=nbins)
        amax = torch.stack(torch._foreach_norm([v.float() for v in new_global.values()], float("inf")))
        checks = torch.cat([torch.stack(losses).float(), amax]) if fill else amax
        nonfinite = ~torch.isfinite(checks).all()
        mass = wgt.sum().double() if fill else torch.zeros((), dtype=torch.float64, device=self.device)
        return torch.cat([stats["counts"].double(), torch.stack([
            nonfinite.double(), mass,
            torch.full((), float(fill), dtype=torch.float64, device=self.device),
            stats["zeros"].double(), stats["sum"].double(), stats["min"].double(), stats["max"].double(),
        ])])

    # --- driving -------------------------------------------------------------

    def run(
        self,
        windows: int,
        epochs: int = 1,
        eval_every: int = 1,
        warmup: bool = False,
        windows_per_call: Optional[int] = None,
        profile_dir: Optional[str] = None,
    ) -> AsyncRunResult:
        """Execute ``windows`` async windows.

        ``windows_per_call`` is the JAX package's compiled chunk: the port
        runs the chunk's windows one after another and reads their devobs
        rows once a chunk, at which boundary the tripwire, the ledger and
        the flight recorder act, as in ``MeshSimulation.run``. With
        ``warmup`` one chunk runs first on a copy of the state at window
        indices past the run (kernel builds and allocator growth fall
        outside the timing) and is thrown away. The history ring is updated
        in place: a chunk that fails part-way leaves it part-written, so the
        state is dropped (``None``) and a ``RuntimeError`` says to restore
        with :meth:`load_from`.
        """
        if self._closed:
            raise RuntimeError("engine is closed — construct a new AsyncPopulationEngine")
        if self.history is None:
            raise RuntimeError(
                "population state lost in a failed chunk — load_from(checkpointer) to restore before running again")
        windows = int(windows)
        per_call = max(1, min(windows_per_call or windows, windows))
        chunks = [per_call] * (windows // per_call)
        if windows % per_call:
            chunks.append(windows % per_call)
        start = self.completed_windows
        sched = self.schedule(windows)
        devobs = bool(Settings.DEVOBS_ENABLED)  # read once per run, as the JAX package does
        eval_every = max(1, int(eval_every))
        final_window = start + windows - 1

        if warmup:
            # Warm-up cursor past the real run, on a copy of the state.
            w0 = start + windows + 1
            wsched = self.schedule(chunks[0], start_window=w0)
            wh = {k: v.clone() for k, v in self.history.items()}
            wo = state_map(torch.clone, self.opt_stack)
            for wi, inp in enumerate(self._chunk_inputs(wsched)):
                self._window(wh, wo, inp, w0 + wi, epochs, (w0 + wi + 1) % eval_every == 0, devobs)
            del wh, wo
            self._sync()

        from p2pfl_tpu_torch.management.profiler import device_memory_watermark, device_trace_window

        if profile_dir is None:
            profile_dir = Settings.PERF_TRACE_DIR
        profile_chunks = int(Settings.DEVOBS_PROFILE_CHUNKS)
        rec = self._devobs_recorder() if devobs else self._recorder
        diverge_mult = float(Settings.DEVOBS_LOSS_DIVERGE_MULT)
        history, opt_stack = self.history, self.opt_stack
        stall = self._stall
        fills, codes, lag_sums, test_loss, test_acc = [], [], [], [], []
        trip: Optional[Dict[str, Any]] = None
        t0 = time.monotonic()
        done = 0
        try:
            for i, chunk in enumerate(chunks):
                sub = _sub_schedule(sched, start, done, chunk)
                # The leading DEVOBS_PROFILE_CHUNKS timed chunks each get a
                # device trace of their windows, ledger and read-back
                # (labels distinct from the sync engine's).
                window = (device_trace_window(profile_dir, label=f"asyncpop_window_chunk{i}")
                          if i < profile_chunks else contextlib.nullcontext())
                t_chunk = time.monotonic()
                if rec is not None:
                    rec.record("chunk_start", chunk=i, windows=chunk, first_window=start + done,
                               bytes_in_use=device_memory_watermark()["bytes_in_use"])
                aux_rows: List[torch.Tensor] = []  # the chunk's devobs rows, on the device
                floor = torch.full((), float("inf"), device=self.device)  # the chunk's best finite window loss
                with window:
                    for wi, inp in enumerate(self._chunk_inputs(sub)):
                        w_abs = start + done + wi
                        do_eval = (w_abs + 1) % eval_every == 0 or w_abs == final_window
                        tl, ta, aux = self._window(history, opt_stack, inp, w_abs, epochs, do_eval, devobs)
                        test_loss.append(tl)
                        test_acc.append(ta)
                        if devobs:
                            # Loss-divergence tripwire on the folded-window
                            # loss (an empty window's NaN leaves the floor).
                            row, wl = aux
                            finite = torch.isfinite(wl)
                            diverged = finite & torch.isfinite(floor) & (wl > diverge_mult * floor)
                            floor = torch.where(finite, torch.minimum(floor, wl), floor)
                            aux_rows.append(torch.cat([row, torch.stack([diverged.double(), wl.double()])]))
                    if self._ledger is not None:
                        with record_function("asyncpop/ledger"):
                            self._ledger_emit_chunk(sub, history)
                    if devobs:
                        # One read of the chunk's rows (it also retires the
                        # chunk, so chunk_end is honest).
                        with record_function("asyncpop/readback"):
                            rows = torch.stack(aux_rows).cpu().numpy()
                # Window close from the schedule: fill target met -> FILL;
                # empty -> STALL (patience counter carried); else TIMEOUT.
                fill = sub.fill()
                for wi in range(chunk):
                    stall = stall + 1 if fill[wi] == 0 else 0
                    codes.append(CLOSE_FILL if fill[wi] >= sub.target[wi]
                                 else CLOSE_STALL if fill[wi] == 0 else CLOSE_TIMEOUT)
                fills.append(fill)
                lag_sums.append((sub.lag * sub.present).sum(axis=1))
                if devobs:
                    trip = fold_devobs_rows(rows, first_round=start + done, node=self._devobs_node,
                                            spec=self._devobs_spec, last=self._devobs_last)
                done += chunk
                wm = device_memory_watermark()
                self._devobs_last["mem_bytes"] = wm["peak_bytes_in_use"]
                if rec is not None:
                    rec.record("chunk_end", chunk=i, windows=chunk, wall_s=round(time.monotonic() - t_chunk, 4),
                               bytes_in_use=wm["bytes_in_use"], peak_bytes=wm["peak_bytes_in_use"])
                if trip is not None:
                    trip["chunk"] = i
                    break
        except BaseException as e:
            self.history = self.opt_stack = None
            if not isinstance(e, Exception):  # an interrupt or exit stays what it is
                raise
            raise RuntimeError(
                "async window chunk failed with the population state part-written; restore with "
                "load_from(checkpointer) before running again"
            ) from e
        self._sync()
        if trip is not None:
            self._devobs_trip(trip, rec)
        dt = time.monotonic() - t0
        # On a tripwire trip `done` < `windows`: the result (and every
        # cursor/accounting update below) covers only the executed chunks.
        total_windows = done
        self._stall = int(stall)
        self.completed_windows = start + total_windows
        fills_np = np.concatenate(fills).astype(np.int64)
        # Cumulative per-vnode fold accounting (fed_top's WINDOW / FILL
        # columns), from the compiled schedule.
        self._account(sched, total_windows, start)
        acc_all = torch.stack(test_acc).cpu().numpy()
        loss_all = torch.stack(test_loss).cpu().numpy()
        evaluated = ~np.isnan(acc_all)
        durs = np.ones(total_windows, np.float64)
        result = AsyncRunResult(
            windows=total_windows,
            seconds_total=dt,
            seconds_per_window=dt / max(1, total_windows),
            # The async clock is fixed-cadence, one tick a window however it
            # closed: a tier-s member's cost is its lag, while the sync
            # barrier stretches every round to its slowest member
            # (``simulated_barrier_time``).
            sim_time_ticks=float(durs.sum()),
            fills=fills_np,
            close_codes=np.asarray(codes, np.int64),
            durations=durs,
            lag_sums=np.concatenate(lag_sums).astype(np.float64),
            test_acc=[float(a) for a in acc_all[evaluated]],
            test_loss=[float(v) for v in loss_all[evaluated]],
            schedule=sched,
            tripped=trip,
        )
        if trip is not None and trip.get("action") == "abort":
            # The state is parked (valid): the raise is the abort contract.
            raise RuntimeError(
                f"devobs tripwire: {trip['kind']} at window {trip['round']} (chunk {trip['chunk']}); flight "
                f"recorder dump: {trip.get('flightrec')}; state parked at window {self.completed_windows} — set "
                "P2PFL_TPU_DEVOBS_TRIP_ACTION=park to receive partial results instead"
            )
        return result

    def _account(self, sched: WindowSchedule, windows: int, first: int) -> None:
        for wi in range(windows):
            folded = sched.members[wi][sched.present[wi]]
            np.add.at(self._fold_counts, folded, 1.0)
            self._last_fold_window[folded] = float(first + wi)
            np.add.at(self._lag_totals, folded, sched.lag[wi][sched.present[wi]].astype(np.float64))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _devobs_trip(self, trip: Dict[str, Any], rec: Any) -> None:
        """A trip is postmortem-worthy, as in ``MeshSimulation``: count it,
        dump the flight recorder, emit a ``membership`` ledger event and
        write an evidence bundle."""
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
        trip["bundle"] = write_bundle(
            "devobs_trip", context={k: trip.get(k) for k in ("kind", "round", "chunk", "action")})

    # --- observability -------------------------------------------------------

    def attach_ledger(self, node: str = "asyncpop-engine", run_id: Optional[str] = None):
        """Emit the canonical window event stream (window_open /
        contribution_folded(lag=...) / aggregate_committed / window_close)
        — the same schema the wire buffer path emits, so
        ``scripts/parity_diff.py`` aligns fused-async against wire-async."""
        from p2pfl_tpu_torch.telemetry.ledger import LEDGERS

        if run_id is not None:
            LEDGERS.configure(run_id)
        self._ledger = LEDGERS.get(node)
        return self._ledger

    def _ledger_emit_chunk(self, sched: WindowSchedule, history: Params) -> None:
        from p2pfl_tpu_torch.telemetry.ledger import canonical_params_hash

        led = self._ledger
        samples = self.num_samples.cpu().numpy()
        # The post-chunk hash describes the global after the chunk's LAST
        # fold — attach it to the last non-empty window (trailing empty
        # windows leave the global untouched, so it still matches).
        fills = sched.fill()
        hash_at = int(np.max(np.flatnonzero(fills > 0))) if (fills > 0).any() else -1
        for wi in range(sched.windows):
            w = sched.start_window + wi
            slots = np.flatnonzero(sched.present[wi])
            names = [self.names[int(sched.members[wi, s])] for s in slots]
            led.emit("window_open", round=w, members=sorted(names))
            total = 0
            for s, name in zip(slots, names):
                n_i = int(samples[int(sched.members[wi, s])])
                total += n_i
                led.emit("contribution_folded", round=w, sender=name, lag=int(sched.lag[wi, s]), num_samples=n_i)
            if len(slots):
                commit: Dict[str, Any] = {"contributors": sorted(names), "num_samples": total, "origin": "mesh"}
                if wi == hash_at:
                    commit["hash"] = canonical_params_hash(self.global_params(history))
                led.emit("aggregate_committed", round=w, **commit)
            led.emit("window_close", round=w)

    def global_params(self, history: Optional[Params] = None) -> Dict[str, np.ndarray]:
        """The current global model (history slot 0) as host numpy copies,
        ``{torch name: f32 array}`` (bf16 state widened exactly);
        ``canonical_params_hash`` takes it."""
        h = self.history if history is None else history
        if h is None:
            raise RuntimeError("population state lost — load_from() to restore")
        return {k: v[0].detach().float().cpu().numpy().copy() for k, v in h.items()}

    def window_fill(self) -> np.ndarray:
        """Realized per-vnode fold fraction across every window this engine
        ran (the async analogue of ``PopulationEngine.cohort_fill``)."""
        return self._fold_counts / float(max(1, self.completed_windows))

    def _devobs_recorder(self) -> Any:
        """The engine's flight recorder (lazy): chunk boundary events and
        tripwire dumps share the wire nodes' recorder machinery."""
        if self._recorder is None:
            from p2pfl_tpu_torch.telemetry.flight_recorder import FlightRecorder

            self._recorder = FlightRecorder(self._devobs_node)
        return self._recorder

    def devobs_summary(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """``(extras, extra_sketches)`` from the last run's device-
        observatory stream (fed_top's LOSS / GNORM / HBM / TRIP columns
        and the fleet quantile rows)."""
        return devobs_summary_for(self._devobs_node, self._devobs_last)

    def snapshot(self, result: AsyncRunResult, top_n: int = 16, path: Optional[str] = None) -> Dict[str, Any]:
        """fed_top-renderable population snapshot with the async columns:
        per-peer ``window`` (last fold) and ``window_fill`` (realized fold
        fraction), straggler ordering by mean fold lag + speed tier."""
        from p2pfl_tpu_torch.telemetry.observatory import population_snapshot, write_snapshot_doc

        n = self.num_nodes
        mean_lag = self._lag_totals / np.maximum(1.0, self._fold_counts)
        metrics = {
            "participation": self._fold_counts,
            "step_time": self.node_speed * float(result.seconds_per_window),
            "round_lag": mean_lag,
            "round": self._last_fold_window,
            "rejections": np.zeros(n),
            "window": self._last_fold_window,
            "window_fill": self.window_fill(),
        }
        extras, extra_sketches = self.devobs_summary()
        if getattr(result, "tripped", None) is not None:
            extras["tripped"] = result.tripped.get("kind")
        snap = population_snapshot(
            observer="asyncpop-engine", node_names=self.names, metrics=metrics, top_n=top_n,
            extras=extras or None, extra_sketches=extra_sketches or None,
        )
        if path is not None:
            write_snapshot_doc(path, snap)
        return snap

    # --- recovery ------------------------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        if self._closed:
            raise RuntimeError("engine is closed — snapshot state before close()")
        return {"history": self.history, "opt_stack": self.opt_stack}

    def save_to(self, checkpointer) -> bool:
        """Snapshot the ring and the optimizer stack at the window cursor.
        The checkpointer copies them to the host before it returns (the ring
        is updated in place by the next window)."""
        return checkpointer.save(
            self.completed_windows,
            self.state_dict(),
            {"completed_windows": self.completed_windows, "seed": self.seed, "stall": self._stall},
        )

    def load_from(self, checkpointer, step: Optional[int] = None) -> int:
        """Restore state; the window/arrival stream then resumes at the
        restored ABSOLUTE cursor — :meth:`schedule` re-streams from window
        0, so the healed engine replays the exact stream an uninterrupted
        run would have produced. Meta and state come from one step, and a
        torn newest step falls back wholesale to the one before."""
        if self._closed:
            raise RuntimeError("engine is closed — construct a new one")

        def _check_seed(meta: dict) -> None:
            if meta and int(meta.get("seed", self.seed)) != self.seed:
                raise ValueError(
                    f"checkpoint seed {meta.get('seed')} != engine seed {self.seed} — the window stream would diverge")

        if self.history is None:
            self._reinit_population()  # a template of the state's structure
        state, meta = checkpointer.restore_coherent(self.state_dict(), step, check_meta=_check_seed)
        if not meta:
            return 0
        self.history = state["history"]
        self.opt_stack = state["opt_stack"]
        restored = int(meta.get("completed_windows", 0))
        self._stall = int(meta.get("stall", 0))
        self.completed_windows = restored
        # Fold accounting is a pure function of the stream: replay it.
        self._fold_counts = np.zeros(self.num_nodes, np.float64)
        self._last_fold_window = np.full(self.num_nodes, -1, np.float64)
        self._lag_totals = np.zeros(self.num_nodes, np.float64)
        if restored:
            self._account(self.schedule(restored, start_window=0), restored, 0)
        return restored

    def close(self) -> None:
        """Release the engine's device tensors."""
        self.history = self.opt_stack = None
        self.x = self.y = self.sample_mask = self.num_samples = None
        self.x_test = self.y_test = None
        self._template = None
        self._closed = True

    def __enter__(self) -> "AsyncPopulationEngine":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def _sub_schedule(sched: WindowSchedule, start: int, done: int, chunk: int) -> WindowSchedule:
    """Rows ``[done, done + chunk)`` of ``sched`` as a schedule of their own."""
    row = slice(done, done + chunk)
    return WindowSchedule(
        start_window=start + done, cohort_k=sched.cohort_k, members=sched.members[row],
        present=sched.present[row], origin=sched.origin[row], lag=sched.lag[row], rank=sched.rank[row],
        target=sched.target[row], solicited=sched.solicited[row], queue_depth=sched.queue_depth[row],
        dropped=sched.dropped[row],
    )


# --- wire replay (the parity arm's other half) --------------------------------


def wire_window_replay(
    engine: AsyncPopulationEngine,
    windows: int,
    epochs: int = 1,
    node: str = "wire-async",
    run_id: Optional[str] = None,
) -> Dict[str, Any]:
    """Drive the REAL wire async buffer through the engine's compiled
    window stream — the parity gate's wire half.

    Rebuilds the engine's data/model from its seed (pure functions — no
    shared tensors), then for each window: opens the buffer window, trains
    each scheduled contribution with the SAME anchor (the historical
    global), the SAME generator and the same single
    :func:`~p2pfl_tpu_torch.parallel.simulation.local_train_step` the engine
    runs, folds it into an
    :class:`~p2pfl_tpu_torch.learning.aggregators.async_buffer.AsyncBufferedAggregator`
    in slot order, and drains the window through the buffer's own
    staleness-weighted aggregation. Emits the canonical ledger stream
    (window_open / contribution_folded — from the buffer itself /
    aggregate_committed with a hash every folded window / window_close),
    on the engine's device.

    Returns ``{"events": [...], "hashes": [...], "fills": [...],
    "final_params": {torch name: numpy}}``. Meant for SMALL n (every
    contribution is a separate train call).
    """
    from p2pfl_tpu_torch.learning.aggregators.async_buffer import AsyncBufferedAggregator
    from p2pfl_tpu_torch.models.mlp import mlp_model
    from p2pfl_tpu_torch.telemetry.ledger import LEDGERS, canonical_params_hash

    cfg = engine.config
    dev = engine.device
    (x, y, w), _ = population_data(
        engine.seed, engine.num_nodes, samples_per_node=cfg["samples_per_node"], feature_dim=cfg["feature_dim"],
        num_classes=cfg["num_classes"], dirichlet_alpha=cfg["dirichlet_alpha"],
    )
    ns = w.sum(axis=1).astype(np.int64)
    model = mlp_model(seed=engine.seed, input_shape=(cfg["feature_dim"],), hidden_sizes=cfg["hidden"],
                      out_channels=cfg["num_classes"], device=dev)
    optimizer = engine.optimizer

    def batch_loss(params, bx, by, bw):
        return softmax_cross_entropy(model.apply(params, bx), by, bw)

    sched = engine.schedule(windows, start_window=0)
    if run_id is not None:
        LEDGERS.configure(run_id)
    led = LEDGERS.get(node)
    buf = AsyncBufferedAggregator(node)
    template = {k: v.detach().to(dev, torch.float32) for k, v in model.params.items()}
    #: hist[w] = the global entering window w.
    hist: List[Params] = [template]
    opt_states: Dict[int, Any] = {}
    hashes: List[Optional[str]] = []
    fills: List[int] = []
    for wi in range(windows):
        buf.open_window(wi)
        slots = np.flatnonzero(sched.present[wi])
        names = [engine.names[int(sched.members[wi, s])] for s in slots]
        led.emit("window_open", round=wi, members=sorted(names))
        for s, name in zip(slots, names):
            i = int(sched.members[wi, s])
            org = int(sched.origin[wi, s])
            o_st = opt_states.get(i)
            if o_st is None:
                o_st = optimizer.init(template)
            p_new, o_new, _loss = local_train_step(
                hist[org], o_st, member_generator(engine.seed, org, int(sched.rank[wi, s])),
                torch.as_tensor(x[i], device=dev), torch.as_tensor(y[i], device=dev).long(),
                torch.as_tensor(w[i], device=dev), None, c_global=None, epochs=epochs, batch_loss=batch_loss,
                optimizer=optimizer, batch_size=cfg["batch_size"],
            )
            opt_states[i] = o_new
            handle = model.build_copy(params=p_new, contributors=[name], num_samples=int(ns[i]))
            buf.fold(handle, origin_window=org, sender=name)
        if len(slots):
            agg = buf.wait_window(target_fn=lambda: buf.fill(), timeout=60.0)
            g = {k: v.to(torch.float32) for k, v in agg.params.items()}
            h = canonical_params_hash(g)
            led.emit("aggregate_committed", round=wi, contributors=sorted(names),
                     num_samples=int(agg.get_num_samples()), hash=h, origin="wire")
            hashes.append(h)
            hist.append(g)
        else:
            hashes.append(None)
            hist.append(hist[-1])
        fills.append(len(slots))
        led.emit("window_close", round=wi)
    return {
        "events": led.events(),
        "hashes": hashes,
        "fills": fills,
        "final_params": {k: v.detach().cpu().numpy().copy() for k, v in hist[-1].items()},
    }


__all__ = ["AsyncPopulationEngine", "AsyncRunResult", "wire_window_replay"]
