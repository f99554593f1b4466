"""The learner (counterpart of ``p2pfl_tpu/learning/learner.py``): the
``Learner`` interface, :class:`TorchLearner` (the counterpart of
``JaxLearner``: a node's local trainer on the card), :class:`LearnerFactory`,
and the learner's math shared with the fused round
(:mod:`p2pfl_tpu_torch.parallel.simulation`): the masked classification and
LM losses, FedProx's proximal term and its gradient, DP-SGD's private
gradient and one optimizer step (:func:`train_step`).

Where ``JaxLearner`` scans a jitted epoch, :class:`TorchLearner` loops over
the batches in Python: flash-attention models run the flash kernels
(``csrc/``) in every forward and backward, and DP-SGD takes per-example
gradients with ``torch.func.vmap`` or, for flash models, one backward per
example.
"""

from __future__ import annotations

import abc
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.device import DeviceLike, resolve_device
from p2pfl_tpu_torch.models.transformer import causal_lm_loss
from p2pfl_tpu_torch.optim import adam, apply_updates
from p2pfl_tpu_torch.parallel.tensor_parallel import local_slice, whole_shape, whole_sq_sum
from p2pfl_tpu_torch.telemetry import REGISTRY

Params = Dict[str, torch.Tensor]
BatchLoss = Callable[[Params, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean cross entropy in f32 (``mask`` zeroes padded rows)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels[:, None].long())[:, 0]
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def masked_lm_loss(logits: torch.Tensor, tokens: torch.Tensor, seq_mask: torch.Tensor) -> torch.Tensor:
    """Next-token CE over ``logits [B, L, V]`` / ``tokens [B, L]`` with a
    per-sequence validity mask ``[B]`` (padded rows contribute zero)."""
    mask = seq_mask[:, None].expand(tokens.shape)
    return causal_lm_loss(logits, tokens, mask)


def fedprox_penalty(params: Params, anchor: Params, mu: float) -> torch.Tensor:
    """FedProx's proximal term ``mu/2 * ||w - w_anchor||^2`` in f32."""
    sq = whole_sq_sum({name: ((p.float() - anchor[name].float()) ** 2).sum() for name, p in params.items()})
    return 0.5 * mu * sq


def fedprox_grad(grads: Params, params: Params, anchor: Params, mu: float) -> Params:
    """``grads`` plus the proximal term's gradient ``mu * (w - w_anchor)``,
    added after DP's per-example clip so the regularizer is never clipped."""
    return {
        name: g + mu * (params[name].to(g.dtype) - anchor[name].to(g.dtype))
        for name, g in grads.items()
    }


def _per_example_vmap(batch_loss_fn: BatchLoss, params: Params, x, y) -> Tuple[torch.Tensor, Params]:
    """Per-example ``(losses [B], grads {name: [B, ...]})`` from one
    ``torch.func.vmap`` of ``grad`` over single-example batches."""

    def example_loss(p, xi, yi):
        return batch_loss_fn(p, xi[None], yi[None], torch.ones(1, device=xi.device))

    grads, losses = vmap(grad_and_value(example_loss), in_dims=(None, 0, 0))(params, x, y)
    return losses, grads


def _per_example_loop(batch_loss_fn: BatchLoss, params: Params, x, y) -> Tuple[torch.Tensor, Params]:
    """The same as :func:`_per_example_vmap`, one example at a time: for
    models whose ``autograd.Function`` (the flash kernels) has no vmap rule."""
    names = list(params)
    losses, per = [], {name: [] for name in names}
    for i in range(x.shape[0]):
        leaves = {name: p.detach().requires_grad_(True) for name, p in params.items()}
        with torch.enable_grad():
            loss = batch_loss_fn(leaves, x[i:i + 1], y[i:i + 1], torch.ones(1, device=x.device))
            gs = torch.autograd.grad(loss, [leaves[n] for n in names])
        losses.append(loss.detach())
        for name, g in zip(names, gs):
            per[name].append(g)
    return torch.stack(losses), {name: torch.stack(gs) for name, gs in per.items()}


def dp_grads(
    batch_loss_fn: BatchLoss,
    params: Params,
    x: torch.Tensor,
    y: torch.Tensor,
    w: torch.Tensor,
    gen: torch.Generator,
    clip_norm: float,
    noise_multiplier: float,
    per_example: str = "vmap",
) -> Tuple[torch.Tensor, Params]:
    """DP-SGD ``(loss, grads)``: per-example gradients clipped to global L2
    ``clip_norm``, their masked mean, plus Gaussian noise of std
    ``clip_norm * noise_multiplier / batch`` drawn from ``gen`` (one draw per
    parameter, in the dict's order; on the CPU, then moved to the
    parameters' device) — Abadi et al. 2016.

    ``per_example``: ``"vmap"`` (one ``torch.func.vmap`` over the batch) or
    ``"loop"`` (one backward per example, for the flash kernels and for
    kernels split over model ranks); the same arithmetic. ``w`` is the
    ``[B]`` 0/1 validity mask. Returns the masked mean per-example loss and
    the private gradient. Under a bound
    :class:`~p2pfl_tpu_torch.parallel.tensor_parallel.ModelSplit` the
    per-example norms are whole-model norms and each split leaf's noise is
    its slice of a whole-leaf draw.
    """
    per = {"vmap": _per_example_vmap, "loop": _per_example_loop}[per_example]
    losses, grads = per(batch_loss_fn, params, x, y)
    denom = torch.clamp(w.sum(), min=1.0)
    loss = (losses.float() * w).sum() / denom
    sq = whole_sq_sum({name: g.reshape(g.shape[0], -1).float().pow(2).sum(dim=1) for name, g in grads.items()})
    norms = torch.sqrt(sq)  # [B] per-example global norm
    scale = torch.clamp(clip_norm / torch.clamp(norms, min=1e-12), max=1.0) * w
    noise_std = clip_norm * noise_multiplier / denom
    out = {}
    for name, g in grads.items():
        mean = torch.tensordot(scale, g.float(), dims=1) / denom
        if noise_multiplier > 0.0:
            # Drawn at the leaf's whole shape, then this rank's slice of it (a
            # kernel split over model ranks): the draws of one process.
            noise = torch.randn(whole_shape(name, mean.shape), generator=gen, dtype=torch.float32)
            noise = local_slice(name, noise).to(mean.device)
            mean = mean + noise_std * noise
        out[name] = mean.detach()
    return loss.detach(), out


def uses_flash(module: torch.nn.Module) -> bool:
    """Whether a model runs the flash kernels (their ``autograd.Function``
    has no vmap rule, so DP-SGD loops over the examples)."""
    return any(getattr(m, "attention_kind", None) in ("flash", "ring_flash") for m in module.modules())


def train_step(
    params: Params,
    opt_state: Any,
    bx: torch.Tensor,
    by: torch.Tensor,
    bw: torch.Tensor,
    gen: torch.Generator,
    *,
    anchor: Params,
    batch_loss: BatchLoss,
    optimizer: Any,
    fedprox_mu: float = 0.0,
    dp_clip_norm: float = 0.0,
    dp_noise_multiplier: float = 0.0,
    c_local: Optional[Params] = None,
    c_global: Optional[Params] = None,
    per_example: str = "vmap",
) -> Tuple[Params, Any, torch.Tensor]:
    """One optimizer step on one batch, shared by the fused round and the
    node learner (the JAX package's ``step`` of ``JaxLearner._train_epoch``
    and of the mesh round body): the batch loss (plus FedProx's pull toward
    ``anchor``) and its gradient, or with ``dp_clip_norm > 0`` the DP-SGD
    gradient (:func:`dp_grads`, noise from ``gen``) with FedProx's gradient
    added after the clip; with ``c_global`` SCAFFOLD's correction ``g + c -
    c_i``. Returns ``(params, opt_state, loss)``."""
    if dp_clip_norm > 0.0:
        plain = {n: p.detach() for n, p in params.items()}
        loss, grads = dp_grads(batch_loss, plain, bx, by, bw, gen, dp_clip_norm, dp_noise_multiplier, per_example)
        if fedprox_mu > 0.0:
            loss = loss + fedprox_penalty(plain, anchor, fedprox_mu)
            grads = fedprox_grad(grads, plain, anchor, fedprox_mu)
    else:
        leaves = {n: p.detach().requires_grad_(True) for n, p in params.items()}
        loss = batch_loss(leaves, bx, by, bw)
        if fedprox_mu > 0.0:
            loss = loss + fedprox_penalty(leaves, anchor, fedprox_mu)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        loss = loss.detach()
    if c_global is not None:  # SCAFFOLD drift correction: g + c - c_i
        grads = {n: g + c_global[n].to(g.dtype) - c_local[n].to(g.dtype) for n, g in grads.items()}
    updates, opt_state = optimizer.update(grads, opt_state, params)
    return apply_updates(params, updates), opt_state, loss


def seeded_generator(*words: int) -> torch.Generator:
    """A CPU generator seeded from a tuple of ints (the port's ``fold_in``)."""
    seed = int(np.random.SeedSequence([int(w) for w in words]).generate_state(1, np.uint64)[0])
    return torch.Generator().manual_seed(seed)


_STEP_S = REGISTRY.gauge(
    "p2pfl_learner_step_seconds",
    "Steady-state seconds per training step (post-compile calls only)",
    labels=("node",),
)
_STEPS_PER_S = REGISTRY.gauge(
    "p2pfl_learner_steps_per_second",
    "Steady-state training steps per second",
    labels=("node",),
)
_FIRST_FIT_S = REGISTRY.gauge(
    "p2pfl_learner_first_segment_seconds",
    "Wall-clock of the learner's first training segment (kernel builds and "
    "allocator growth included) — compare against steady-state step time",
    labels=("node",),
)


class Learner(abc.ABC):
    """Template: owns a model + data, trains and evaluates on request."""

    def __init__(self, model: Any = None, data: Any = None, self_addr: str = "unknown-node") -> None:
        self._model = model
        self._data = data
        self._self_addr = self_addr
        self.epochs = 1
        self.metric_reporter: Optional[Callable[[str, float, Optional[int]], None]] = None

    def set_model(self, model: Any) -> None:
        self._model = model

    def get_model(self) -> Any:
        if self._model is None:
            raise ValueError("learner has no model")
        return self._model

    def set_data(self, data: Any) -> None:
        self._data = data

    def get_data(self) -> Any:
        if self._data is None:
            raise ValueError("learner has no data")
        return self._data

    def set_addr(self, addr: str) -> None:
        self._self_addr = addr

    def set_epochs(self, epochs: int) -> None:
        self.epochs = epochs

    def report(self, name: str, value: float, step: Optional[int] = None) -> None:
        if self.metric_reporter is not None:
            self.metric_reporter(name, value, step)

    @abc.abstractmethod
    def fit(self) -> Any: ...

    @abc.abstractmethod
    def interrupt_fit(self) -> None: ...

    @abc.abstractmethod
    def evaluate(self) -> Dict[str, float]: ...

    @abc.abstractmethod
    def get_framework(self) -> str: ...


class TorchLearner(Learner):
    """A node's local trainer on the card (counterpart of ``JaxLearner``).

    Args are ``JaxLearner``'s, then ``task`` and ``device``:
        optimizer: a port transformation (:mod:`p2pfl_tpu_torch.optim`;
            default Adam at ``lr``).
        lr: learning rate (and SCAFFOLD's control-variate scale).
        batch_size: local batch size (the last partial batch is padded and
            masked, as in the JAX package).
        fedprox_mu: FedProx's proximal coefficient.
        dp_clip_norm / dp_noise_multiplier: DP-SGD (default: the privacy
            plane's ``Settings.PRIVACY_DP_CLIP`` / ``PRIVACY_DP_SIGMA``).
        seed: base seed of the batch shuffles (the JAX package's: the same
            permutations for the same seed) and of the DP noise (the port's
            own generator); OS entropy when None (:func:`resolve_seed`).
        callbacks: ``"scaffold"`` (SCAFFOLD's drift correction and control
            variates, exchanged through ``additional_info``) and any name
            registered in the callback factory for ``"torch"``.
        interrupt_every: check :meth:`interrupt_fit` every this many steps
            (default: between epochs only).
        task: ``"classification"`` (labels) or ``"lm"`` (token sequences,
            next-token loss through :func:`masked_lm_loss`).
        device: where training runs (default ``"cuda"``; raises when no card
            is visible). The model's parameters move there at each fit.
    """

    SUPPORTED_CALLBACKS = ("scaffold",)

    def __init__(
        self,
        model: Any = None,
        data: Any = None,
        self_addr: str = "unknown-node",
        optimizer: Any = None,
        lr: float = 1e-3,
        batch_size: int = 64,
        fedprox_mu: float = 0.0,
        dp_clip_norm: Optional[float] = None,
        dp_noise_multiplier: Optional[float] = None,
        seed: Optional[int] = None,
        callbacks: Optional[List[str]] = None,
        interrupt_every: Optional[int] = None,
        task: str = "classification",
        device: DeviceLike = "cuda",
    ) -> None:
        super().__init__(model, data, self_addr)
        if interrupt_every is not None and interrupt_every < 1:
            raise ValueError(f"interrupt_every must be >= 1, got {interrupt_every}")
        if task not in ("classification", "lm"):
            raise ValueError(f"unknown task {task!r}")
        self.device = resolve_device(device)
        self.task = task
        self.interrupt_every = interrupt_every
        self.lr = float(lr)
        self.optimizer = optimizer if optimizer is not None else adam(self.lr)
        self.batch_size = int(batch_size)
        self.fedprox_mu = float(fedprox_mu)
        self.dp_clip_norm = float(Settings.PRIVACY_DP_CLIP if dp_clip_norm is None else dp_clip_norm)
        self.dp_noise_multiplier = float(
            Settings.PRIVACY_DP_SIGMA if dp_noise_multiplier is None else dp_noise_multiplier)
        if self.dp_noise_multiplier > 0.0 and self.dp_clip_norm <= 0.0:
            raise ValueError(
                "dp_noise_multiplier > 0 requires dp_clip_norm > 0 — without a clip bound the DP "
                "branch never runs and training would be silently non-private"
            )
        from p2pfl_tpu_torch.learning.callbacks import CallbackFactory
        from p2pfl_tpu_torch.learning.privacy import resolve_seed

        self.seed = resolve_seed(seed, self.dp_noise_multiplier)
        self.callbacks = list(callbacks or [])
        self._callback_objs = CallbackFactory.create(
            self.get_framework(), [cb for cb in self.callbacks if cb not in self.SUPPORTED_CALLBACKS])
        self._interrupt = threading.Event()
        self._timed_first = False
        self._fit_count = 0
        self._dp_total_steps = 0
        self._nonprivate_steps = 0
        self._opt_state: Any = None
        self._scaffold_c_i: Optional[Params] = None
        self._scaffold = "scaffold" in self.callbacks

    def get_framework(self) -> str:
        return "torch"

    def interrupt_fit(self) -> None:
        self._interrupt.set()

    def _batch_loss(self, params: Params, bx: torch.Tensor, by: torch.Tensor, bw: torch.Tensor) -> torch.Tensor:
        logits = self.get_model().apply(params, bx)
        if self.task == "lm":
            return masked_lm_loss(logits, bx, bw)
        return softmax_cross_entropy(logits, by, bw)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(a), device=self.device)
        return t if t.is_floating_point() else t.long()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def fit(self) -> Any:
        """Run ``self.epochs`` of local training; returns the model handle,
        updated with the new parameters, the node's address as contributor
        and the local sample count (and SCAFFOLD's deltas in
        ``additional_info``)."""
        from p2pfl_tpu_torch.models.convert import from_canonical, to_canonical
        from p2pfl_tpu_torch.ops.compression import as_tensor

        model = self.get_model()
        self._interrupt.clear()
        for cb in self._callback_objs:
            cb.on_fit_start(self)
        t0 = time.monotonic()
        fit_idx = self._fit_count
        self._fit_count += 1
        params = {n: p.detach().to(self.device) for n, p in model.params.items()}
        if self._opt_state is None:
            self._opt_state = self.optimizer.init(params)
        opt_state = self._opt_state
        anchor = params
        c_local = c_global = None
        if self._scaffold:
            zeros = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
            if self._scaffold_c_i is None:
                self._scaffold_c_i = zeros
            c_local, c_global = self._scaffold_c_i, zeros
            server = model.get_info("scaffold_server", {})
            if "global_c" in server:
                c_global = from_canonical(
                    params, [as_tensor(a, device=self.device, dtype=torch.float32) for a in server["global_c"]])
        per_example = "loop" if uses_flash(model.module) else "vmap"
        total_steps, steady_time, steady_steps = 0, 0.0, 0
        for epoch in range(self.epochs):
            if self._interrupt.is_set():
                break
            xb, yb, wb = self.get_data().export_batches(self.batch_size, train=True, seed=(self.seed, fit_idx, epoch))
            # The node's DP noise stream: the base seed, the fit, the epoch and
            # the node's address (nodes sharing a pinned seed must not inject
            # identical noise).
            gen = seeded_generator(self.seed, fit_idx, epoch, zlib.crc32(self._self_addr.encode()))
            xb, yb, wb = self._to_device(xb), self._to_device(yb), self._to_device(wb)
            steps = xb.shape[0]
            seg = self.interrupt_every or steps
            seg_losses = []
            for start in range(0, steps, seg):
                if start > 0 and self._interrupt.is_set():
                    break
                stop = min(start + seg, steps)
                t_seg = time.perf_counter()
                losses = []
                for s in range(start, stop):
                    params, opt_state, loss = train_step(
                        params, opt_state, xb[s], yb[s], wb[s], gen, anchor=anchor, batch_loss=self._batch_loss,
                        optimizer=self.optimizer, fedprox_mu=self.fedprox_mu, dp_clip_norm=self.dp_clip_norm,
                        dp_noise_multiplier=self.dp_noise_multiplier, c_local=c_local, c_global=c_global,
                        per_example=per_example,
                    )
                    losses.append(loss)
                loss_f = float(torch.stack(losses).mean())  # waits for the segment's steps
                seg_dur = time.perf_counter() - t_seg
                total_steps += stop - start
                if not self._timed_first:
                    self._timed_first = True
                    _FIRST_FIT_S.labels(self._self_addr).set(seg_dur)
                else:
                    steady_time += seg_dur
                    steady_steps += stop - start
                seg_losses.append((stop - start, loss_f))
            last_loss = sum(n * l for n, l in seg_losses) / max(sum(n for n, _ in seg_losses), 1)
            self.report("train_loss", last_loss, step=epoch)
        if steady_steps > 0 and steady_time > 0:
            _STEP_S.labels(self._self_addr).set(steady_time / steady_steps)
            _STEPS_PER_S.labels(self._self_addr).set(steady_steps / steady_time)

        self._opt_state = opt_state
        model.params = params
        model.set_contribution([self._self_addr], self.get_data().get_num_samples(True))
        # L2 norm of this fit's update: what the sparse delta wire path ships.
        upd = sum(float(((params[n].float() - anchor[n].float()) ** 2).sum()) for n in params)
        self.report("update_norm", upd**0.5)
        # Per-node privacy-budget ledger (p2pfl_tpu_torch/privacy/budget.py):
        # the cumulative epsilon rides the health digest, so the fleet sees
        # each node's spend — not just the node itself.
        from p2pfl_tpu_torch.privacy.budget import BUDGETS

        if self.dp_clip_norm <= 0.0:
            self._nonprivate_steps += total_steps
            BUDGETS.record(self._self_addr, clip_norm=0.0, noise_multiplier=0.0, nonprivate_steps=total_steps)
        else:
            self._dp_total_steps += total_steps
            BUDGETS.record(self._self_addr, clip_norm=self.dp_clip_norm, noise_multiplier=self.dp_noise_multiplier,
                           dp_steps=total_steps)
            # Reported as a metric, NOT stamped into model.additional_info:
            # aggregation merges peers' additional_info into the local model,
            # so a stamped entry could be overwritten by another node's
            # (smaller) epsilon — a privacy claim must never travel that way.
            self.report("dp_epsilon", self.privacy_spent()["epsilon"])
        if self._scaffold and total_steps > 0:
            # c_i' = c_i - c + (x - y) / (K lr); the deltas ride additional_info
            # as canonical leaves, as the JAX learner ships them.
            scale = 1.0 / (total_steps * self.lr)
            delta_y = {n: params[n].float() - anchor[n].float() for n in params}
            c_i_new = {n: c_local[n] - c_global[n] - delta_y[n] * scale for n in params}
            delta_c = {n: c_i_new[n] - c_local[n] for n in params}
            self._scaffold_c_i = c_i_new
            model.add_info("scaffold", {"delta_y_i": to_canonical(delta_y), "delta_c_i": to_canonical(delta_c)})
        for cb in self._callback_objs:
            cb.on_fit_end(self)
        self.report("fit_time_s", time.monotonic() - t0)
        return model

    def privacy_spent(self, delta: float = 1e-5) -> Dict[str, Any]:
        """Conservative (epsilon, delta) spent by all training so far;
        epsilon is ``inf`` when any step ran without the DP mechanism."""
        from p2pfl_tpu_torch.learning.privacy import dp_sgd_privacy_spent

        return dp_sgd_privacy_spent(self.dp_noise_multiplier, self.dp_clip_norm, self._dp_total_steps, delta,
                                    nonprivate_steps=self._nonprivate_steps)

    def cost_analysis(self) -> Optional[Dict[str, float]]:
        """The work of ONE train epoch at this learner's current shapes, with
        the JAX package's keys: ``flops_per_epoch``,
        ``bytes_accessed_per_epoch``, ``flops_per_step`` and
        ``steps_per_epoch``. Counted over an executed epoch
        (:func:`p2pfl_tpu_torch.ops.cost.count_cost_of`, as
        ``MeshSimulation.round_cost_analysis`` counts a round: matrix
        products by ``torch.utils.flop_counter``'s formulas, each flash call
        as its analytic work, bytes as every counted op's tensor inputs and
        outputs) on copies of the parameters and optimizer state, the
        batches of ``seed=0`` and zero SCAFFOLD variates; the model, the
        optimizer state and the global generators are left as they were.
        Returns ``None`` without a train split or when the count fails."""
        from p2pfl_tpu_torch.ops.cost import count_cost_of
        from p2pfl_tpu_torch.optim import state_map

        model = self.get_model()
        try:
            xb, yb, wb = self.get_data().export_batches(self.batch_size, train=True, seed=0)
        except Exception:  # noqa: BLE001 — no train split, no cost model
            return None
        params = {n: p.detach().to(self.device).clone() for n, p in model.params.items()}
        opt_state = (state_map(torch.clone, self._opt_state) if self._opt_state is not None
                     else self.optimizer.init(params))
        zeros = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()} if self._scaffold else None
        per_example = "loop" if uses_flash(model.module) else "vmap"
        xb, yb, wb = self._to_device(xb), self._to_device(yb), self._to_device(wb)
        gen = seeded_generator(0)

        def epoch() -> None:
            p, o = params, opt_state
            for s in range(xb.shape[0]):
                p, o, _ = train_step(
                    p, o, xb[s], yb[s], wb[s], gen, anchor=params, batch_loss=self._batch_loss,
                    optimizer=self.optimizer, fedprox_mu=self.fedprox_mu, dp_clip_norm=self.dp_clip_norm,
                    dp_noise_multiplier=self.dp_noise_multiplier, c_local=zeros, c_global=zeros,
                    per_example=per_example,
                )
            self._sync()

        counter = count_cost_of(epoch)
        if counter is None:
            return None
        steps = int(xb.shape[0])
        return {
            "flops_per_epoch": float(counter.flops),
            "bytes_accessed_per_epoch": float(counter.bytes),
            "flops_per_step": counter.flops / max(steps, 1),
            "steps_per_epoch": steps,
        }

    @torch.no_grad()
    def evaluate(self) -> Dict[str, float]:
        """Masked test loss and accuracy (token accuracy for ``"lm"``) over
        the test split in batches of ``batch_size``; ``{}`` without one."""
        model = self.get_model()
        try:
            xb, yb, wb = self.get_data().export_batches(self.batch_size, train=False, seed=0)
        except KeyError:
            return {}
        params = {n: p.to(self.device) for n, p in model.params.items()}
        loss_sum = correct = count = 0.0
        for x, y, w in zip(self._to_device(xb), self._to_device(yb), self._to_device(wb)):
            logits = model.apply(params, x)
            if self.task == "lm":
                loss_sum += masked_lm_loss(logits, x, w) * torch.clamp(w.sum(), min=1.0)
                hit = (torch.argmax(logits[:, :-1], dim=-1) == x[:, 1:]).float().mean(dim=-1)
            else:
                loss_sum += softmax_cross_entropy(logits, y, w) * torch.clamp(w.sum(), min=1.0)
                hit = (torch.argmax(logits, dim=-1) == y).float()
            correct += (hit * w).sum()
            count += w.sum()
        total = max(float(count), 1.0)
        metrics = {"test_loss": float(loss_sum) / total, "test_acc": float(correct) / total}
        for k, v in metrics.items():
            self.report(k, v)
        return metrics


class LearnerFactory:
    """framework tag -> learner class."""

    _registry: Dict[str, type] = {"torch": TorchLearner}

    @classmethod
    def register(cls, framework: str, learner_cls: type) -> None:
        cls._registry[framework] = learner_cls

    @classmethod
    def create_learner(cls, model: Any) -> type:
        fw = model.get_framework()
        if fw not in cls._registry:
            raise ValueError(f"no learner registered for framework {fw!r}")
        return cls._registry[fw]
