"""TensorFlow/Keras interop: a keras-backed handle and learner (the port's
copy of ``p2pfl_tpu/learning/interop/keras_backend.py``).

Parity with the reference's TensorFlow backend (p2pfl/learning/frameworks/
tensorflow/keras_model.py:44-119 get/set_weights<->numpy, keras_learner.py:
36-124 fit/evaluate): ``keras.Model.get_weights()`` is the parameter list,
so the gossip and aggregation machinery is shared with every other Node.
Training runs TensorFlow's eager ``GradientTape`` loop on the host, as in
the JAX package; the handle's leaves are CPU tensors (keyed ``"0000"``,
``"0001"``, ... in ``get_weights()`` order, so the port's aggregators fold
them like any parameter dict) and a Keras Node runs with ``device="cpu"``.

Gated on keras: ``keras`` and ``tensorflow`` are imported when a keras
handle or learner is built, not when this module is imported, and
:data:`KERAS_AVAILABLE` says whether they can be. SCAFFOLD is supported in
the same loop (gradient correction ``g + c - c_i`` per step, delta emission
at fit end).
"""

from __future__ import annotations

import importlib.util
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from p2pfl_tpu_torch.device import DeviceLike
from p2pfl_tpu_torch.exceptions import ModelNotMatchingError
from p2pfl_tpu_torch.learning.dataset.dataset import FederatedDataset
from p2pfl_tpu_torch.learning.dataset.export_strategies import TensorFlowExportStrategy
from p2pfl_tpu_torch.learning.interop.wire import CanonicalWireMixin
from p2pfl_tpu_torch.learning.learner import Learner, LearnerFactory
from p2pfl_tpu_torch.models.model_handle import ModelHandle

KERAS_AVAILABLE = (importlib.util.find_spec("keras") is not None
                   and importlib.util.find_spec("tensorflow") is not None)


def _keras():
    if not KERAS_AVAILABLE:
        raise ImportError("TensorFlow/Keras is not available; install tensorflow or use the port's own learner")
    import keras

    return keras


def _key(i: int) -> str:
    return f"{i:04d}"


def _host(a: Any) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class KerasModelHandle(CanonicalWireMixin, ModelHandle):
    """ModelHandle whose parameters are a keras model's weight list.

    ``params`` is ``{"0000": tensor, ...}`` in ``get_weights()`` order (CPU
    tensors); the native leaves are that list (reference keras_model.py:44-66
    uses the same order). ``to_wire`` / ``from_wire`` optionally translate
    them to and from a canonical cross-framework layout.
    """

    framework = "tensorflow"

    def __init__(
        self,
        model: Any,
        to_wire: Optional[Any] = None,
        from_wire: Optional[Any] = None,
        num_samples: int = 1,
        contributors: Optional[List[str]] = None,
        additional_info: Optional[Dict[str, Any]] = None,
    ) -> None:
        _keras()
        self.keras_model = model
        self._to_wire = to_wire
        self._from_wire = from_wire
        self.params = {_key(i): torch.from_numpy(np.array(w, copy=True)) for i, w in enumerate(model.get_weights())}
        self.num_samples = int(num_samples)
        self.contributors: List[str] = list(contributors or [])
        self.additional_info: Dict[str, Any] = dict(additional_info or {})

    @property
    def device(self) -> torch.device:
        return torch.device("cpu")

    def apply(self, params: Dict[str, torch.Tensor], x: Any) -> torch.Tensor:
        """Run the keras model on ``x`` with ``params`` (on the host)."""
        self._load(params)
        return torch.from_numpy(np.asarray(self.keras_model(_host(x).astype(np.float32), training=False)))

    def _load(self, params: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """Push the handle's parameters into the live keras model."""
        params = self.params if params is None else params
        self.keras_model.set_weights([_host(params[k]) for k in sorted(params)])

    def pull_from_model(self) -> None:
        """Refresh the handle's parameters from the live keras model."""
        self.params = {_key(i): torch.from_numpy(np.array(w, copy=True))
                       for i, w in enumerate(self.keras_model.get_weights())}

    def _native_leaves(self) -> List[torch.Tensor]:
        return [self.params[k] for k in sorted(self.params)]

    _native_tree = _native_leaves

    def _set_native(self, leaves: Any) -> None:
        leaves = [leaves[k] for k in sorted(leaves)] if isinstance(leaves, dict) else list(leaves)
        if len(leaves) != len(self.params):
            raise ModelNotMatchingError(f"expected {len(self.params)} tensors, got {len(leaves)}")
        out = {}
        for (k, t), a in zip(sorted(self.params.items()), leaves):
            a = torch.from_numpy(np.array(_host(a), copy=True)).to(t.dtype)
            if tuple(a.shape) != tuple(t.shape):
                raise ModelNotMatchingError(f"shape mismatch: {tuple(a.shape)} != {tuple(t.shape)}")
            out[k] = a
        self.params = out

    def set_parameters(self, params) -> None:
        """Adopt a parameter dict, leaves (canonical ones on a canonical
        handle, else ``get_weights()`` order) or a wire frame."""
        if isinstance(params, dict):
            self._set_native(params)
        else:
            super().set_parameters(params)

    def build_copy(self, params=None, contributors=None, num_samples=None) -> "KerasModelHandle":
        # Each copy gets its own keras model: _load pushes the handle's
        # parameters into its model, so sharing one would let copies clobber
        # each other (and a learner mid-fit) through set_weights.
        keras = _keras()
        clone = keras.models.clone_model(self.keras_model)
        if not clone.built and self.keras_model.built:
            clone.build(self.keras_model.input_shape)
        clone.set_weights(self.keras_model.get_weights())
        out = KerasModelHandle(
            clone, to_wire=self._to_wire, from_wire=self._from_wire,
            num_samples=num_samples if num_samples is not None else self.num_samples,
            contributors=contributors if contributors is not None else list(self.contributors),
            additional_info=dict(self.additional_info),
        )
        out.set_parameters(dict(self.params) if params is None else params)
        return out

    def __repr__(self) -> str:
        n = sum(int(t.numel()) for t in self.params.values())
        return (f"KerasModelHandle(leaves={len(self.params)}, params={n}, canonical={self._to_wire is not None}, "
                f"contributors={len(self.contributors)}, num_samples={self.num_samples})")


class KerasLearner(Learner):
    """Eager TF trainer with the reference learner's contract (fit updates
    the handle in place with parameters and contribution metadata;
    interrupt_fit takes effect between batches and epochs) and the JAX
    package's algorithm. TensorFlow trains on the host: ``device`` must be
    ``"cpu"`` (the Node passes its own through)."""

    SUPPORTED_CALLBACKS: Sequence[str] = ("scaffold",)

    def __init__(
        self,
        model: Optional[KerasModelHandle] = None,
        data: Optional[FederatedDataset] = None,
        self_addr: str = "unknown-node",
        lr: float = 1e-3,
        batch_size: int = 64,
        seed: int = 0,
        callbacks: Optional[List[str]] = None,
        device: DeviceLike = "cpu",
    ) -> None:
        _keras()
        if torch.device(device).type != "cpu":
            raise ValueError("the Keras learner trains with TensorFlow on the host: pass device='cpu'")
        super().__init__(model, data, self_addr)
        self.lr = float(lr)
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.callbacks = list(callbacks or [])
        from p2pfl_tpu_torch.learning.callbacks import CallbackFactory

        self._callback_objs = CallbackFactory.create(
            self.get_framework(), [cb for cb in self.callbacks if cb not in self.SUPPORTED_CALLBACKS])
        self._scaffold = "scaffold" in self.callbacks
        self._scaffold_c_i: Optional[List[np.ndarray]] = None
        self._interrupt = threading.Event()
        self._fit_count = 0

    def get_framework(self) -> str:
        return "tensorflow"

    def interrupt_fit(self) -> None:
        self._interrupt.set()

    def _handle(self) -> KerasModelHandle:
        model = self.get_model()
        if not isinstance(model, KerasModelHandle):
            raise TypeError("KerasLearner requires a KerasModelHandle")
        return model

    def fit(self) -> KerasModelHandle:
        keras = _keras()
        import tensorflow as tf

        model = self._handle()
        self._interrupt.clear()
        for cb in self._callback_objs:
            cb.on_fit_start(self)
        t0 = time.monotonic()
        keras.utils.set_random_seed((self.seed + self._fit_count) % 2**31)
        fit_idx = self._fit_count
        self._fit_count += 1

        model._load()
        km = model.keras_model
        opt = keras.optimizers.Adam(self.lr)
        # get_weights() order == km.weights order; grads come per trainable
        # variable, so map each trainable var to its weight-list index.
        weight_index = {id(v): i for i, v in enumerate(km.weights)}

        if self._scaffold:
            if model._to_wire is not None:
                raise ValueError(
                    "SCAFFOLD is not supported on canonical-wire (heterogeneous federation) handles: "
                    "control-variate payloads are framework-layout specific")
            anchor = [np.asarray(w, np.float32).copy() for w in km.get_weights()]
            c_global = [np.zeros_like(a) for a in anchor]
            if self._scaffold_c_i is None:
                self._scaffold_c_i = [np.zeros_like(a) for a in anchor]
            server = model.get_info("scaffold_server", {}) or {}
            if "global_c" in server:
                c_global = [_host(a).astype(np.float32) for a in server["global_c"]]
            corrections = [tf.constant(c - ci) for c, ci in zip(c_global, self._scaffold_c_i)]

        total_steps = 0
        for epoch in range(self.epochs):
            if self._interrupt.is_set():
                break
            ds = self.get_data().export(TensorFlowExportStrategy, train=True, batch_size=self.batch_size,
                                        seed=(self.seed, fit_idx, epoch))
            losses = []
            for xt, yt in ds:
                if self._interrupt.is_set():
                    break
                yt = tf.cast(yt, tf.int32)
                with tf.GradientTape() as tape:
                    logits = km(xt, training=True)
                    loss = tf.reduce_mean(tf.nn.sparse_softmax_cross_entropy_with_logits(labels=yt, logits=logits))
                grads = tape.gradient(loss, km.trainable_variables)
                if self._scaffold:
                    grads = [g + corrections[weight_index[id(v)]] for g, v in zip(grads, km.trainable_variables)]
                opt.apply_gradients(zip(grads, km.trainable_variables))
                losses.append(float(loss))
                total_steps += 1
            if losses:  # interrupt can land before the first batch
                self.report("train_loss", float(np.mean(losses)), step=epoch)

        model.pull_from_model()
        model.set_contribution([self._self_addr], self.get_data().get_num_samples(True))

        if self._scaffold and total_steps > 0:
            # c_i' = c_i - c + (x - y)/(K*lr); deltas ride in additional_info.
            scale = 1.0 / (total_steps * self.lr)
            final = [_host(w).astype(np.float32) for w in model._native_leaves()]
            delta_y = [f - a for f, a in zip(final, anchor)]
            c_i_new = [ci - c - dy * scale for ci, c, dy in zip(self._scaffold_c_i, c_global, delta_y)]
            delta_c = [n - o for n, o in zip(c_i_new, self._scaffold_c_i)]
            self._scaffold_c_i = c_i_new
            model.add_info("scaffold", {"delta_y_i": delta_y, "delta_c_i": delta_c})

        for cb in self._callback_objs:
            cb.on_fit_end(self)
        self.report("fit_time_s", time.monotonic() - t0)
        return model

    def evaluate(self) -> Dict[str, float]:
        model = self._handle()
        try:
            ds = self.get_data().export(TensorFlowExportStrategy, train=False, batch_size=self.batch_size)
        except KeyError:
            return {}
        model._load()
        km = model.keras_model
        tot_loss = tot_correct = tot_n = 0.0
        for xt, yt in ds:
            logits = np.asarray(km(xt, training=False))
            y = np.asarray(yt, np.int64)
            logp = logits - logits.max(-1, keepdims=True)
            logp = logp - np.log(np.exp(logp).sum(-1, keepdims=True))
            tot_loss += float(-logp[np.arange(len(y)), y].sum())
            tot_correct += float((logits.argmax(-1) == y).sum())
            tot_n += float(len(y))
        tot_n = max(tot_n, 1.0)
        metrics = {"test_loss": tot_loss / tot_n, "test_acc": tot_correct / tot_n}
        for k, v in metrics.items():
            self.report(k, v)
        return metrics


# --- model zoo translation ----------------------------------------------------


def keras_mlp_to_wire(weights: Sequence[Any]) -> List[Any]:
    """Canonical (flax-leaf-order) wire layout for the keras MLP twin: per
    Dense layer ``bias, kernel`` (keras kernels are already ``[in, out]``)."""
    leaves: List[Any] = []
    for i in range(len(weights) // 2):
        leaves += [weights[2 * i + 1], weights[2 * i]]
    return leaves


def keras_mlp_from_wire(leaves: Sequence[Any]) -> List[Any]:
    """Inverse of :func:`keras_mlp_to_wire`."""
    weights: List[Any] = []
    for i in range(len(leaves) // 2):
        weights += [leaves[2 * i + 1], leaves[2 * i]]
    return weights


def keras_mlp_model(
    seed: int = 0,
    hidden_sizes: Sequence[int] = (256, 128),
    out_channels: int = 10,
    in_shape: Sequence[int] = (28, 28),
    canonical: bool = False,
) -> KerasModelHandle:
    """Keras twin of the zoo's MLP (the JAX package's ``keras_mlp_model``).

    With ``canonical=True`` the handle speaks the flax-layout wire format so
    it federates with the zoo's MLP Nodes (heterogeneous federation).
    """
    keras = _keras()
    keras.utils.set_random_seed(seed)
    layers: List[Any] = [keras.Input(shape=tuple(in_shape)), keras.layers.Flatten()]
    for h in hidden_sizes:
        layers.append(keras.layers.Dense(h, activation="relu"))
    layers.append(keras.layers.Dense(out_channels))
    return KerasModelHandle(keras.Sequential(layers), to_wire=keras_mlp_to_wire if canonical else None,
                            from_wire=keras_mlp_from_wire if canonical else None)


def keras_weights_to_jax_mlp(weights: Sequence[Any]) -> Dict[str, Any]:
    """Translate keras MLP weights into flax MLP params (numpy). Keras
    ``Dense`` kernels are already ``[in, out]`` (flax convention): only the
    re-nesting into the linen names is needed."""
    params: Dict[str, Any] = {}
    for i in range(len(weights) // 2):
        params[f"Dense_{i}"] = {"kernel": np.array(_host(weights[2 * i]), copy=True),
                                "bias": np.array(_host(weights[2 * i + 1]), copy=True)}
    return {"params": params}


def jax_mlp_params_to_keras(params: Dict[str, Any]) -> List[np.ndarray]:
    """Inverse of :func:`keras_weights_to_jax_mlp`."""
    inner = params.get("params", params)
    out: List[np.ndarray] = []
    for name in sorted(inner, key=lambda n: int(n.split("_")[1])):
        out.append(np.array(_host(inner[name]["kernel"]), copy=True))
        out.append(np.array(_host(inner[name]["bias"]), copy=True))
    return out


if KERAS_AVAILABLE:
    LearnerFactory.register("tensorflow", KerasLearner)
