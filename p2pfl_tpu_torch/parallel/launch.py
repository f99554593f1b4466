"""Start W ranks of one command on this host and wait for them, with a
deadline that ends the whole world.

    results = launch([sys.executable, "-m", "p2pfl_tpu_torch.examples.mnist", "--device", "cpu"], world=2,
                     timeout_s=300)

Each rank is a fresh process (never a ``fork`` of a process that has touched
CUDA) with ``torchrun``'s variables set: ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` (127.0.0.1) and
``MASTER_PORT`` (a free port), which
:func:`~p2pfl_tpu_torch.parallel.mesh.initialize_multihost` reads. A rank
that dies leaves the others blocked in a collective, so once one rank has
failed the rest get ``FAILURE_GRACE_S`` to finish and are then killed, and
at the deadline every rank still running is killed.
"""

from __future__ import annotations

import os
import socket
import subprocess
import tempfile
import time
from typing import List, Mapping, Optional, Sequence, Tuple

#: Seconds the other ranks get to finish after one rank failed.
FAILURE_GRACE_S = 30.0


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return int(s.getsockname()[1])


def launch(
    argv: Sequence[str],
    world: int,
    *,
    timeout_s: float,
    env: Optional[Mapping[str, str]] = None,
    cwd: Optional[str] = None,
) -> List[Tuple[int, str]]:
    """Run ``argv`` as ``world`` ranks; returns each rank's ``(exit code,
    output)`` (stdout and stderr together), in rank order. A rank killed at
    the deadline, or after another rank failed, reports its signal as a
    negative code."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    base = dict(os.environ if env is None else env)
    base.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), WORLD_SIZE=str(world),
                LOCAL_WORLD_SIZE=str(world))
    procs, logs = [], []
    try:
        for rank in range(world):
            log = tempfile.TemporaryFile(mode="w+")
            logs.append(log)
            procs.append(subprocess.Popen(list(argv), cwd=cwd, stdout=log, stderr=subprocess.STDOUT,
                                          env={**base, "RANK": str(rank), "LOCAL_RANK": str(rank)}))
        deadline = time.monotonic() + float(timeout_s)
        failed_at: Optional[float] = None
        while any(p.poll() is None for p in procs):
            now = time.monotonic()
            if failed_at is None and any(p.returncode not in (None, 0) for p in procs):
                failed_at = now
            if now > deadline or (failed_at is not None and now > failed_at + FAILURE_GRACE_S):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    out = []
    for p, log in zip(procs, logs):
        log.seek(0)
        out.append((p.returncode, log.read()))
        log.close()
    return out


__all__ = ["free_port", "launch"]
