"""Stage ABC + early-stop predicate (reference p2pfl/stages/stage.py:26-66).

The port's copy of ``p2pfl_tpu/stages/stage.py``.
"""

from __future__ import annotations

import abc
from typing import TYPE_CHECKING, Optional, Type

if TYPE_CHECKING:  # pragma: no cover
    from p2pfl_tpu_torch.node import Node


class Stage(abc.ABC):
    """One step of the learning workflow. ``execute`` returns the next stage
    class, or ``None`` to finish."""

    name: str = "Stage"

    @staticmethod
    @abc.abstractmethod
    def execute(node: "Node") -> Optional[Type["Stage"]]: ...


def check_early_stop(node: "Node", raise_exception: bool = False) -> bool:
    """Learning was aborted iff the round was cleared
    (reference stage.py:46-66 keys off ``state.round is None``)."""
    stopped = node.state.experiment is None
    if stopped and raise_exception:
        raise StopIteration("learning stopped")
    return stopped
