"""PyTorch interop: a handle and a learner around a user's own
``torch.nn.Module`` (the port's copy of
``p2pfl_tpu/learning/interop/torch_backend.py``).

Parity with the reference's PyTorch backend (p2pfl/learning/frameworks/
pytorch/lightning_model.py:37-116 state_dict<->numpy, lightning_learner.py:
43-137 fit/evaluate): the module's ``state_dict`` is the parameter set, so
the gossip and aggregation machinery is shared with every other Node. The
port's :class:`TorchModelHandle` keeps the state as tensors on its device
and :class:`TorchLearner` trains there (default ``"cuda"``; ``"cpu"`` only
when asked for), with the JAX package's interop learner's algorithm: Adam,
mean cross-entropy, batches from a seeded ``DataLoader``
(:class:`~p2pfl_tpu_torch.learning.dataset.export_strategies.TorchExportStrategy`).

Two learners named "torch" live in the port. This module's
:class:`TorchLearner` trains any module the user brings and registers in
:class:`~p2pfl_tpu_torch.learning.learner.LearnerFactory` under
``"pytorch"`` (the handle's framework tag), as the JAX package's interop
learner does. The port's own zoo learner,
:class:`p2pfl_tpu_torch.learning.learner.TorchLearner`, trains the port's
models (``ModelHandle``, flax-named parameters, the hand-written kernels)
and stays under ``"torch"``.

Also provides exact weight translation between the torch MLP twin and the
flax MLP of the model zoo (``Linear.weight`` is ``[out, in]``; flax
``Dense`` kernels are ``[in, out]``): with ``canonical=True`` a handle shows
and ships the flax layout, so it federates with the port's zoo MLP Nodes and
the JAX package's.
"""

from __future__ import annotations

import copy
import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from p2pfl_tpu_torch.device import DeviceLike, resolve_device
from p2pfl_tpu_torch.exceptions import ModelNotMatchingError
from p2pfl_tpu_torch.learning.dataset.dataset import FederatedDataset
from p2pfl_tpu_torch.learning.dataset.export_strategies import TorchExportStrategy
from p2pfl_tpu_torch.learning.interop.wire import CanonicalWireMixin
from p2pfl_tpu_torch.learning.learner import Learner, LearnerFactory
from p2pfl_tpu_torch.models.model_handle import ModelHandle, _apply_lock
from p2pfl_tpu_torch.ops.compression import as_tensor

State = Dict[str, torch.Tensor]


def _tensor(a: Any) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a, copy=True))


class TorchModelHandle(CanonicalWireMixin, ModelHandle):
    """ModelHandle whose parameters are a torch module's ``state_dict``.

    ``params`` is ``{state_dict name: tensor}`` on the handle's device (the
    module lives there too). The native leaves are the state_dict's values
    in sorted-name order (the JAX package's ``jax.tree.leaves`` of its numpy
    dict); ``to_wire`` / ``from_wire`` optionally translate them to and from
    a canonical cross-framework layout (:func:`torch_mlp_model` wires the
    flax MLP's in with ``canonical=True``).
    """

    framework = "pytorch"

    def __init__(
        self,
        module: nn.Module,
        to_wire: Optional[Any] = None,
        from_wire: Optional[Any] = None,
        num_samples: int = 1,
        contributors: Optional[List[str]] = None,
        additional_info: Optional[Dict[str, Any]] = None,
        device: DeviceLike = "cuda",
    ) -> None:
        dev = resolve_device(device)
        self.module = module.to(dev)
        self._to_wire = to_wire
        self._from_wire = from_wire
        self.params: State = {k: v.detach().clone() for k, v in self.module.state_dict().items()}
        self.num_samples = int(num_samples)
        self.contributors: List[str] = list(contributors or [])
        self.additional_info: Dict[str, Any] = dict(additional_info or {})

    @property
    def device(self) -> torch.device:
        return next(iter(self.params.values())).device if self.params else torch.device("cpu")

    def to(self, device: DeviceLike) -> "TorchModelHandle":
        """Move the module and the parameters to ``device`` (in place)."""
        dev = resolve_device(device)
        self.module.to(dev)
        self.params = {k: v.to(dev) for k, v in self.params.items()}
        return self

    def apply(self, params: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        """Run the module on ``x`` with ``params`` (thread-safe, as
        :meth:`ModelHandle.apply`)."""
        with _apply_lock(self.module):
            return functional_call(self.module, dict(params), (x,))

    def _load(self) -> None:
        """Push the handle's parameters into the live module."""
        self.module.load_state_dict(self.params)

    def pull_from_module(self) -> None:
        """Refresh the handle's parameters from the live module."""
        self.params = {k: v.detach().clone() for k, v in self.module.state_dict().items()}

    def _native_tree(self) -> State:
        return self.params

    def _native_leaves(self) -> List[torch.Tensor]:
        return [self.params[k] for k in sorted(self.params)]

    def _set_native(self, leaves: Any) -> None:
        if isinstance(leaves, Mapping):
            state = dict(leaves)
            if set(state) != set(self.params):
                raise ModelNotMatchingError(
                    f"state_dict names differ: missing {sorted(set(self.params) - set(state))}, "
                    f"unexpected {sorted(set(state) - set(self.params))}")
        else:
            leaves = list(leaves)
            names = sorted(self.params)
            if len(leaves) != len(names):
                raise ModelNotMatchingError(f"expected {len(names)} tensors, got {len(leaves)}")
            state = dict(zip(names, leaves))
        for k, t in self.params.items():
            if tuple(state[k].shape) != tuple(t.shape):
                raise ModelNotMatchingError(f"{k}: shape {tuple(state[k].shape)} != {tuple(t.shape)}")
        self.params = {k: as_tensor(_tensor(state[k]), device=t.device, dtype=t.dtype) for k, t in self.params.items()}

    def set_parameters(self, params) -> None:
        """Adopt a state dict (``{name: tensor or array}``), leaves (canonical
        ones on a canonical handle, else the native sorted-name order) or a
        wire frame (either package's)."""
        if isinstance(params, Mapping):
            self._set_native(params)
        else:
            super().set_parameters(params)

    def build_copy(self, params=None, contributors=None, num_samples=None) -> "TorchModelHandle":
        # Each copy gets its own module: _load pushes the handle's parameters
        # into its module, so sharing one would let copies clobber each
        # other (and a learner mid-fit).
        out = TorchModelHandle(
            copy.deepcopy(self.module), to_wire=self._to_wire, from_wire=self._from_wire,
            num_samples=num_samples if num_samples is not None else self.num_samples,
            contributors=contributors if contributors is not None else list(self.contributors),
            additional_info=dict(self.additional_info), device=self.device,
        )
        out.set_parameters(dict(self.params) if params is None else params)
        return out

    def __repr__(self) -> str:
        n = sum(int(t.numel()) for t in self.params.values())
        return (f"TorchModelHandle(leaves={len(self.params)}, params={n}, canonical={self._to_wire is not None}, "
                f"contributors={len(self.contributors)}, num_samples={self.num_samples})")


class TorchLearner(Learner):
    """Trainer of a user's module in a :class:`TorchModelHandle`, with the
    reference learner's contract (fit updates the handle in place with
    parameters and contribution metadata; interrupt_fit takes effect between
    batches and epochs) and the JAX package's interop learner's algorithm.

    Supports the ``scaffold`` callback on native-layout handles: per-step
    gradient correction ``g + c - c_i`` and ``delta_y_i`` / ``delta_c_i``
    (sorted state_dict order, f32 tensors) in ``additional_info``.

    ``device``: where training runs (default ``"cuda"``; raises when no card
    is visible). The handle moves there at each fit and evaluation.
    """

    SUPPORTED_CALLBACKS: Sequence[str] = ("scaffold",)

    def __init__(
        self,
        model: Optional[TorchModelHandle] = None,
        data: Optional[FederatedDataset] = None,
        self_addr: str = "unknown-node",
        lr: float = 1e-3,
        batch_size: int = 64,
        seed: int = 0,
        callbacks: Optional[List[str]] = None,
        device: DeviceLike = "cuda",
    ) -> None:
        super().__init__(model, data, self_addr)
        self.device = resolve_device(device)
        self.lr = float(lr)
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.callbacks = list(callbacks or [])
        from p2pfl_tpu_torch.learning.callbacks import CallbackFactory

        self._callback_objs = CallbackFactory.create(
            self.get_framework(), [cb for cb in self.callbacks if cb not in self.SUPPORTED_CALLBACKS])
        self._scaffold = "scaffold" in self.callbacks
        self._scaffold_c_i: Optional[State] = None
        self._interrupt = threading.Event()
        self._fit_count = 0

    def get_framework(self) -> str:
        return "pytorch"

    def interrupt_fit(self) -> None:
        self._interrupt.set()

    def _handle(self) -> TorchModelHandle:
        model = self.get_model()
        if not isinstance(model, TorchModelHandle):
            raise TypeError("the interop TorchLearner requires a TorchModelHandle")
        if model.device != self.device:
            model.to(self.device)
        return model

    def fit(self) -> TorchModelHandle:
        model = self._handle()
        self._interrupt.clear()
        for cb in self._callback_objs:
            cb.on_fit_start(self)
        t0 = time.monotonic()
        torch.manual_seed(self.seed + self._fit_count)
        fit_idx = self._fit_count
        self._fit_count += 1

        model._load()
        module = model.module
        module.train()
        opt = torch.optim.Adam(module.parameters(), lr=self.lr)
        loss_fn = nn.CrossEntropyLoss(reduction="none")

        # SCAFFOLD state covers the full state_dict (sorted names, the
        # native leaf order); the per-step correction only touches entries
        # that get gradients.
        corrections: State = {}
        if self._scaffold:
            if model._to_wire is not None:
                raise ValueError(
                    "SCAFFOLD is not supported on canonical-wire (heterogeneous federation) handles: "
                    "control-variate payloads are framework-layout specific")
            anchor = {k: v.float().clone() for k, v in model.params.items()}
            c_global = {k: torch.zeros_like(a) for k, a in anchor.items()}
            if self._scaffold_c_i is None:
                self._scaffold_c_i = {k: torch.zeros_like(a) for k, a in anchor.items()}
            server = model.get_info("scaffold_server", {}) or {}
            if "global_c" in server:
                c_global = {k: as_tensor(_tensor(a), device=self.device, dtype=torch.float32)
                            for k, a in zip(sorted(anchor), server["global_c"])}
            corrections = {k: c_global[k] - self._scaffold_c_i[k] for k in anchor}

        total_steps = 0
        for epoch in range(self.epochs):
            if self._interrupt.is_set():
                break
            # A seeded DataLoader, ragged final batch and all; the tuple seed
            # feeds numpy's SeedSequence, as the JAX package's learners do.
            loader = self.get_data().export(TorchExportStrategy, train=True, batch_size=self.batch_size,
                                            seed=(self.seed, fit_idx, epoch))
            losses = []
            for xt, yt in loader:
                if self._interrupt.is_set():
                    break
                xt, yt = xt.to(self.device), yt.to(self.device)
                opt.zero_grad()
                loss = loss_fn(module(xt), yt).mean()
                loss.backward()
                if self._scaffold:  # drift correction: g + c - c_i
                    for name, p in module.named_parameters():
                        if p.grad is not None:
                            p.grad.add_(corrections[name])
                opt.step()
                losses.append(loss.detach())
                total_steps += 1
            if losses:  # interrupt can land before the first batch
                self.report("train_loss", float(torch.stack(losses).mean()), step=epoch)

        model.pull_from_module()
        model.set_contribution([self._self_addr], self.get_data().get_num_samples(True))

        if self._scaffold and total_steps > 0:
            # c_i' = c_i - c + (x - y)/(K*lr); deltas ride in additional_info.
            scale = 1.0 / (total_steps * self.lr)
            keys = sorted(anchor)
            delta_y = {k: model.params[k].float() - anchor[k] for k in keys}
            c_i_new = {k: self._scaffold_c_i[k] - c_global[k] - delta_y[k] * scale for k in keys}
            delta_c = {k: c_i_new[k] - self._scaffold_c_i[k] for k in keys}
            self._scaffold_c_i = c_i_new
            model.add_info("scaffold", {"delta_y_i": [delta_y[k] for k in keys],
                                        "delta_c_i": [delta_c[k] for k in keys]})

        for cb in self._callback_objs:
            cb.on_fit_end(self)
        self.report("fit_time_s", time.monotonic() - t0)
        return model

    def evaluate(self) -> Dict[str, float]:
        model = self._handle()
        try:
            loader = self.get_data().export(TorchExportStrategy, train=False, batch_size=self.batch_size)
        except KeyError:
            return {}
        model._load()
        module = model.module
        module.eval()
        loss_fn = nn.CrossEntropyLoss(reduction="sum")
        tot_loss = torch.zeros((), dtype=torch.float64, device=self.device)
        tot_correct = torch.zeros((), dtype=torch.float64, device=self.device)
        tot_n = 0
        with torch.no_grad():
            for xt, yt in loader:
                xt, yt = xt.to(self.device), yt.to(self.device)
                logits = module(xt)
                tot_loss += loss_fn(logits, yt).double()
                tot_correct += (logits.argmax(-1) == yt).sum().double()
                tot_n += int(yt.numel())
        tot_n = max(tot_n, 1)
        metrics = {"test_loss": float(tot_loss) / tot_n, "test_acc": float(tot_correct) / tot_n}
        for k, v in metrics.items():
            self.report(k, v)
        return metrics


# --- model zoo translation ----------------------------------------------------


def torch_mlp_to_wire(state: Mapping[str, Any]) -> List[torch.Tensor]:
    """Canonical (flax-leaf-order) wire layout for the torch MLP twin: per
    Dense layer ``bias, kernel`` with kernels transposed to ``[in, out]``,
    exactly ``jax.tree.leaves`` order of the flax MLP params."""
    nested = torch_state_dict_to_jax_mlp(state)["params"]
    leaves: List[torch.Tensor] = []
    for name in sorted(nested):
        leaves += [nested[name]["bias"], nested[name]["kernel"]]
    return leaves


def torch_mlp_from_wire(leaves: Sequence[Any]) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`torch_mlp_to_wire`."""
    nested = {f"Dense_{i}": {"bias": leaves[2 * i], "kernel": leaves[2 * i + 1]} for i in range(len(leaves) // 2)}
    return jax_mlp_params_to_torch({"params": nested})


def torch_state_dict_to_jax_mlp(state: Mapping[str, Any]) -> Dict[str, Any]:
    """Translate a torch MLP state_dict (tensors or arrays) into flax MLP
    params, as tensors: ``Linear.weight`` is ``[out, in]``, flax ``Dense``
    kernels are ``[in, out]``; transpose and re-nest into the linen names."""
    weights = sorted((k for k in state if k.endswith(".weight")), key=lambda k: int(k.split(".")[0]))
    params: Dict[str, Any] = {}
    for i, wk in enumerate(weights):
        bk = wk.rsplit(".", 1)[0] + ".bias"
        params[f"Dense_{i}"] = {"kernel": _tensor(state[wk]).t().contiguous(),
                                "bias": _tensor(state[bk]).clone()}
    return {"params": params}


def jax_mlp_params_to_torch(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`torch_state_dict_to_jax_mlp` for the twin built by
    :func:`torch_mlp_model` (``nn.Sequential`` indices: Flatten at 0, Linear
    at 1, 3, 5, ...)."""
    inner = params.get("params", params)
    state: Dict[str, torch.Tensor] = {}
    for i, name in enumerate(sorted(inner, key=lambda n: int(n.split("_")[1]))):
        idx = 1 + 2 * i
        state[f"{idx}.weight"] = _tensor(inner[name]["kernel"]).t().contiguous()
        state[f"{idx}.bias"] = _tensor(inner[name]["bias"]).clone()
    return state


def torch_mlp_model(
    seed: int = 0,
    hidden_sizes: Sequence[int] = (256, 128),
    out_channels: int = 10,
    in_features: int = 784,
    canonical: bool = False,
    device: DeviceLike = "cuda",
) -> TorchModelHandle:
    """Torch twin of the zoo's MLP (the JAX package's ``torch_mlp_model``:
    the same modules drawn from ``torch.manual_seed(seed)``, so the same
    weights), on ``device``. The global generator is left as it was.

    With ``canonical=True`` the handle speaks the flax-layout wire format so
    it federates with the zoo's MLP Nodes (heterogeneous federation).
    """
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        layers: List[nn.Module] = [nn.Flatten()]
        prev = in_features
        for h in hidden_sizes:
            layers += [nn.Linear(prev, h), nn.ReLU()]
            prev = h
        layers.append(nn.Linear(prev, out_channels))
        module = nn.Sequential(*layers)
    return TorchModelHandle(module, to_wire=torch_mlp_to_wire if canonical else None,
                            from_wire=torch_mlp_from_wire if canonical else None, device=device)


LearnerFactory.register("pytorch", TorchLearner)
