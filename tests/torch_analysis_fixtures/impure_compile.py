"""SEEDED DEFECT (C4): side effects inside functions handed to torch's
tracing and capture entry points — they run once, when the function is
traced or the graph captured, then silently freeze: the metric stops
counting, the draw and the timestamp are baked into the compiled program
or the captured graph as constants."""

from __future__ import annotations

import time

import numpy as np
import torch

from p2pfl_tpu_torch.telemetry import REGISTRY

# an existing series, looked up (not declared): only C4 fires on this file
_STEPS = REGISTRY.get("p2pfl_learner_steps_per_second")


@torch.compile
def noisy_step(params, grads):
    _STEPS.labels("fixture").inc()  # traced once, never counts again
    lr = 0.1 + 0.01 * np.random.random()  # baked in at trace time
    return [p - lr * g for p, g in zip(params, grads)]


def _scaled_loss_impl(x):
    started = time.time()  # trace-time constant, not a clock
    return (x * x).sum() + (started - started)


scaled_loss = torch.compile(_scaled_loss_impl)


def _captured_step(x):
    print("step")  # runs while the graph is captured, never on replay
    return x * 2


def capture(x):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = _captured_step(x)
    return graph, y
