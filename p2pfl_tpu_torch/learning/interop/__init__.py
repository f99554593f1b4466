"""Framework interop: a user's own ``torch.nn.Module`` or ``keras.Model`` in
the federation (the port's copy of ``p2pfl_tpu/learning/interop/``).

Capability parity with the reference's pluggable ML frameworks
(p2pfl/learning/frameworks/: LightningLearner for torch, KerasLearner for
TF — learner_factory.py:24-56): a handle wraps the user's model and a
learner trains it, and with a canonical handle the frames carry the zoo's
flax layout, so such a Node federates with the port's zoo Nodes and the JAX
package's.

Importing this package registers the interop torch learner under
``"pytorch"`` in :class:`~p2pfl_tpu_torch.learning.learner.LearnerFactory`
and, where keras can be imported, the Keras learner under
``"tensorflow"``; the port's own zoo learner keeps ``"torch"``. Keras and
TensorFlow are imported only when a Keras handle or learner is built.
"""

from p2pfl_tpu_torch.learning.interop.keras_backend import (  # noqa: F401
    KERAS_AVAILABLE,
    KerasLearner,
    KerasModelHandle,
    jax_mlp_params_to_keras,
    keras_mlp_from_wire,
    keras_mlp_model,
    keras_mlp_to_wire,
    keras_weights_to_jax_mlp,
)
from p2pfl_tpu_torch.learning.interop.torch_backend import (  # noqa: F401
    TorchLearner,
    TorchModelHandle,
    jax_mlp_params_to_torch,
    torch_mlp_from_wire,
    torch_mlp_model,
    torch_mlp_to_wire,
    torch_state_dict_to_jax_mlp,
)
from p2pfl_tpu_torch.learning.interop.wire import CanonicalWireMixin  # noqa: F401
