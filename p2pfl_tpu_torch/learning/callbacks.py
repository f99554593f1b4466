"""Open callback registry (a copy of ``p2pfl_tpu/learning/callbacks.py``).

Capability parity with the reference CallbackFactory
(p2pfl/learning/frameworks/callback_factory.py:16-101): aggregators declare
required callback *names* (`Aggregator.get_required_callbacks`), learners
resolve names into callback objects at construction, and users can register
their own callbacks per framework.

User callbacks are *host-side* hooks around a fit (``on_fit_start`` /
``on_fit_end``), as in the JAX package. In-step behaviors (SCAFFOLD's ``g +
c - c_i`` correction, FedProx's proximal term) are implemented natively
inside the learners and exposed under reserved names — learners recognize
them before consulting this registry.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple, Type


class P2PFLCallback:
    """Base host-side callback: subclass and override the hooks.

    The model handle is available as ``learner.get_model()`` inside hooks;
    ``add_info``/``get_info`` on it is the side channel that rides the wire
    (reference: callbacks communicate with aggregators the same way,
    learner.py:126-146).
    """

    name: str = "callback"

    def on_fit_start(self, learner) -> None:  # noqa: ANN001
        """Runs before local training (host side)."""

    def on_fit_end(self, learner) -> None:  # noqa: ANN001
        """Runs after local training, before the model is handed back."""


class CallbackFactory:
    """(framework, name) -> callback class registry."""

    _registry: Dict[Tuple[str, str], Type[P2PFLCallback]] = {}

    @classmethod
    def register(
        cls, framework: str, name: str, callback_cls: Type[P2PFLCallback]
    ) -> None:
        cls._registry[(framework, name)] = callback_cls

    @classmethod
    def registered(cls, framework: str) -> List[str]:
        return sorted(n for fw, n in cls._registry if fw == framework)

    @classmethod
    def create(cls, framework: str, names: List[str]) -> List[P2PFLCallback]:
        """Instantiate callbacks for ``names``; unknown names raise with the
        available set listed (reference raises the same way,
        callback_factory.py:58-76)."""
        out: List[P2PFLCallback] = []
        for name in names:
            key = (framework, name)
            if key not in cls._registry:
                raise ValueError(
                    f"no callback {name!r} registered for framework "
                    f"{framework!r}; available: {cls.registered(framework)}"
                )
            out.append(cls._registry[key]())
        return out

    @classmethod
    def decorator(
        cls, framework: str, name: str
    ) -> Callable[[Type[P2PFLCallback]], Type[P2PFLCallback]]:
        """``@CallbackFactory.decorator("torch", "my-cb")`` registration."""

        def wrap(callback_cls: Type[P2PFLCallback]) -> Type[P2PFLCallback]:
            cls.register(framework, name, callback_cls)
            return callback_cls

        return wrap
