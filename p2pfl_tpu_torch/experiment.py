"""Experiment descriptor: name + round bookkeeping.

Parity with reference p2pfl/experiment.py:4-74.

The port's copy of ``p2pfl_tpu/experiment.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Experiment:
    """A named multi-round learning session.

    Attributes:
        exp_name: Unique experiment identifier (used to key metric storage).
        total_rounds: Planned number of federated rounds.
        round: Current round index (0-based); ``None`` disallowed — start at 0.
    """

    exp_name: str
    total_rounds: int
    round: int = field(default=0)

    def increase_round(self) -> None:
        """Advance to the next round (reference: experiment.py:28)."""
        if self.round is None:
            raise ValueError("round not initialized")
        self.round += 1

    def self_update(self, other: "Experiment") -> None:
        """Adopt another experiment descriptor's fields."""
        self.exp_name = other.exp_name
        self.total_rounds = other.total_rounds
        self.round = other.round

    def __str__(self) -> str:
        return (
            f"Experiment(exp_name={self.exp_name}, total_rounds={self.total_rounds}, "
            f"round={self.round})"
        )
