"""The while-loop stage machine (reference p2pfl/stages/workflows.py:28-58):
run stage -> next stage class -> repeat until None; record history for
test assertions (reference test/node_test.py:114-120).

Telemetry: the whole run executes inside an ``experiment`` root span whose
trace id is shared federation-wide (the initiator mints it; peers adopt it
from the start_learning frame — see ``Node.set_start_learning``), and every
stage executes inside a child span tagged with the round. Stage wall-clock
also feeds the ``p2pfl_stage_duration_seconds`` histogram, the per-stage
breakdown every perf PR reports through.

The port's copy of ``p2pfl_tpu/stages/workflow.py``.
"""

from __future__ import annotations

import logging
import time
from typing import TYPE_CHECKING, List, Optional, Type

from p2pfl_tpu_torch.stages.stage import Stage
from p2pfl_tpu_torch.telemetry import REGISTRY, TRACER
from p2pfl_tpu_torch.telemetry.bundle import write_bundle

if TYPE_CHECKING:  # pragma: no cover
    from p2pfl_tpu_torch.node import Node

log = logging.getLogger("p2pfl_tpu_torch")

_STAGE_DURATION = REGISTRY.histogram(
    "p2pfl_stage_duration_seconds",
    "Wall-clock per stage execution",
    labels=("node", "stage"),
)


def scheduler_start_stage(mode: str) -> Type[Stage]:
    """Entry stage of a scheduler over the shared stage machine.

    Two schedulers exist (the ROADMAP refactor note): ``"sync"`` — barrier
    rounds (vote → train → aggregate → gossip, stages/base_node.py) — and
    ``"async"`` — elastic buffered windows with staleness weighting
    (stages/async_node.py). Both drive the same :class:`LearningWorkflow`
    while-loop; a scheduler is nothing but its start stage plus the
    transition graph its stages return."""
    if mode == "sync":
        from p2pfl_tpu_torch.stages.base_node import StartLearningStage

        return StartLearningStage
    if mode == "async":
        from p2pfl_tpu_torch.stages.async_node import AsyncStartStage

        return AsyncStartStage
    raise ValueError(f"unknown scheduler mode {mode!r} (expected 'sync' or 'async')")


class LearningWorkflow:
    def __init__(self, start_stage: Optional[Type[Stage]] = None) -> None:
        if start_stage is None:
            start_stage = scheduler_start_stage("sync")
        self.start_stage = start_stage
        self.history: List[str] = []

    def run(self, node: "Node") -> None:
        from p2pfl_tpu_torch.exceptions import ProtocolNotStartedError

        stage: Optional[Type[Stage]] = self.start_stage
        exp = node.state.experiment
        try:
            with TRACER.span(
                "experiment",
                node=node.addr,
                trace_id=node.state.trace_id,  # None -> fresh trace
                experiment=exp.exp_name if exp is not None else None,
            ):
                recorder = node.protocol.flight_recorder
                while stage is not None:
                    self.history.append(stage.name)
                    log.debug("%s: stage %s", node.addr, stage.name)
                    name = stage.name
                    # Visible to the fleet: the next health digest carries
                    # the stage, and the transition lands in the postmortem
                    # ring — "where was node 5 when it stalled" is answerable.
                    node.state.current_stage = name
                    recorder.record("stage", stage=name, round=node.state.round)
                    t0 = time.perf_counter()
                    with TRACER.span(name, node=node.addr, round=node.state.round):
                        stage = stage.execute(node)
                    _STAGE_DURATION.labels(node.addr, name).observe(
                        time.perf_counter() - t0
                    )
        except StopIteration:
            log.info("%s: learning stopped early", node.addr)
        except ProtocolNotStartedError:
            # Node was stopped under our feet; treat as an early stop rather
            # than letting the exception escape the daemon thread.
            log.info("%s: protocol stopped mid-workflow — aborting learning", node.addr)
        except Exception as exc:
            log.exception("%s: workflow crashed", node.addr)
            # The failure the flight recorder exists for: dump the ring
            # before the daemon thread dies with the evidence.
            node.protocol.flight_recorder.record("workflow_crash")
            node.protocol.flight_recorder.dump("workflow_crash")
            # ...and the rest of the causal story with it: one evidence
            # bundle joining every run-matching stream (both schedulers
            # crash through this path).
            write_bundle(
                "workflow_crash",
                context={
                    "node": node.addr,
                    "stage": node.state.current_stage,
                    "round": node.state.round,
                },
                error=exc,
            )
            raise
        finally:
            node.state.current_stage = ""
