"""Operation and byte counts of executed torch work: the port's stand-in for
XLA's ``cost_analysis``.

XLA reports the FLOPs and bytes of a compiled program without running it;
eager PyTorch has no program to ask, so the port counts what a run
executes. :class:`CostCounter` is a ``TorchDispatchMode``: every aten op
that reaches the dispatcher adds its FLOPs, from the formulas of
:mod:`torch.utils.flop_counter` (matrix products, convolutions; elementwise
ops count none, as in ``FlopCounterMode``), and its bytes, the sizes of
its tensor inputs and outputs (view ops move nothing and count nothing).

The flash kernels are launched through ``ctypes`` and never reach the
dispatcher, while on the CPU their plain versions would be counted as the
dense products they compute. So each flash entry point of
:mod:`p2pfl_tpu_torch.ops.attention` is one counted operation on both
devices: inside :func:`opaque` the counter is paused and the call adds its
analytic FLOPs and bytes instead (:func:`~p2pfl_tpu_torch.ops.attention.
attention_cost`). The card and the CPU therefore report the same FLOPs for
the same model and shapes.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Any, Callable, Iterator, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

log = logging.getLogger("p2pfl_tpu_torch")

# The counter a cost count has open (module-wide, not thread-local: the
# autograd engine runs a card's backward on its own thread).
_ACTIVE: Optional["CostCounter"] = None


def _nbytes(obj: Any) -> int:
    """Bytes of every tensor in a (nested) argument or result."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (list, tuple)):
        return sum(_nbytes(o) for o in obj)
    if isinstance(obj, dict):
        return sum(_nbytes(o) for o in obj.values())
    return 0


class CostCounter(TorchDispatchMode):
    """Counts the FLOPs and bytes of the aten ops run while it is open, plus
    the analytic work that :func:`opaque` blocks report (``opaque_flops`` /
    ``opaque_bytes``, included in ``flops`` / ``bytes``)."""

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.opaque_flops = 0
        self.opaque_bytes = 0
        self._paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._paused:
            return func(*args, **kwargs)
        from torch.utils.flop_counter import flop_registry

        formula = flop_registry.get(func._overloadpacket)
        if formula is None and func is not torch.ops.prim.device.default:
            # As FlopCounterMode does: an op without a formula is counted
            # through its decomposition where it has one.
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        if not getattr(func, "is_view", False):
            self.bytes += _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
        return out


def active() -> Optional[CostCounter]:
    """The open counter, or None outside :func:`count_cost`."""
    return _ACTIVE


@contextlib.contextmanager
def count_cost() -> Iterator[CostCounter]:
    """Count the FLOPs and bytes of the enclosed block; yields the counter.
    Counts do not nest: a second count inside the first raises."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("a cost count is already open")
    counter = CostCounter()
    _ACTIVE = counter
    try:
        with counter:
            yield counter
    finally:
        _ACTIVE = None


def count_cost_of(work: Callable[[], Any]) -> Optional[CostCounter]:
    """Run ``work()`` under :func:`count_cost` and return the counter, as a
    cost analysis does: the global generators (the CPU's and every card's)
    are saved before and restored after, so the count leaves later work's
    random streams as they were; a failure is logged and gives ``None``
    (a cost analysis is best-effort, as in the JAX package)."""
    cpu_rng = torch.random.get_rng_state()
    cuda_rng = torch.cuda.get_rng_state_all() if torch.cuda.is_initialized() else None
    try:
        with count_cost() as counter:
            work()
        return counter
    except Exception:  # noqa: BLE001 — best-effort, see above
        log.exception("cost analysis failed")
        return None
    finally:
        torch.random.set_rng_state(cpu_rng)
        if cuda_rng is not None:
            torch.cuda.set_rng_state_all(cuda_rng)


@contextlib.contextmanager
def opaque(flops: int, nbytes: int) -> Iterator[None]:
    """Run the block as one counted operation of ``flops`` and ``nbytes``:
    the ops inside it are not counted. A no-op outside :func:`count_cost`."""
    counter = _ACTIVE
    if counter is None:
        yield
        return
    counter._paused += 1
    try:
        yield
    finally:
        counter._paused -= 1
    if not counter._paused:
        counter.flops += flops
        counter.bytes += nbytes
        counter.opaque_flops += flops
        counter.opaque_bytes += nbytes
