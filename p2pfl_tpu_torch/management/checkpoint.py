"""Checkpoint / resume (counterpart of ``p2pfl_tpu/management/checkpoint.py``,
written on torch).

Snapshots of

* a single :class:`~p2pfl_tpu_torch.models.model_handle.ModelHandle`
  (federation mode: one node's model + contributor metadata per round),
* an entire :class:`~p2pfl_tpu_torch.parallel.simulation.MeshSimulation`
  population (stacked params + optimizer state + round counter), restored
  onto the template's devices so a resumed run stays on the card, in one
  process or a slab a rank over the ranks of a rank mesh, and
* a wire node's recovery closure (:class:`NodeJournal`).

On-disk layout, one directory per step under the checkpoint root::

    <root>/<step>/state.pt              torch.save of a flat {path: CPU tensor} dict
    <root>/<step>/meta.json             the JSON meta record
    <root>/<step>/_CHECKPOINT_METADATA  the commit marker, written last

A step saved over the W ranks of a rank mesh (``save(..., shards=)``, every
rank calling it with the same step) holds, in place of ``state.pt``, each
rank's own part and the replicated leaves once::

    <root>/<step>/shard-<r>-of-<W>.pt   rank r's part of every split leaf
    <root>/<step>/replicated.pt         the leaves every rank holds whole (rank 0's)

and ``meta.json``'s ``"sharded"`` entry names the world size, the rank axis,
the save's token, the files with their bytes, and each split leaf's
dimension and whole size (rank r holds the r-th of W equal parts of it).
Either layout restores into either kind of run: a restoring rank reads only
the parts that overlap its own (memory-mapped, so its host memory follows
its part), and :func:`~p2pfl_tpu_torch.population.sharding.recut` puts
them together.

The JAX package writes orbax checkpoints; neither package reads the other's.

Crash safety: a step is staged in a ``.tmp-*`` directory inside the root
(so the rename stays on one filesystem), its files are fsynced, the commit
marker is written last, the directory is renamed into place and the root
fsynced. A step directory without the marker is torn and invisible; stale
temp directories are swept when a checkpointer opens its root, by rank 0
alone in a joined process group and never a stage of a save in flight in
this process (a save marks its stage live before it returns). Over ranks every rank writes its shard into one stage named by
a token rank 0 draws, then a ``done-<r>`` file; rank 0 waits for every
rank's (a file rendezvous, under ``_COMMIT_TIMEOUT_S``), writes the meta and
the marker and makes the one rename; the other ranks wait for the rename.
The rendezvous uses files, not the rounds' process group: the writer thread
runs while the rounds run their own collectives.

Updated-in-place state: :meth:`FLCheckpointer.save` takes its host copy of
every leaf before it returns (the population's round updates its tensors in
place), and only the file I/O runs on a writer thread. A save first drains
the one in flight, whichever thread asked for it; :meth:`FLCheckpointer.wait`
joins it and raises the writer's error, if any.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from p2pfl_tpu_torch.parallel.mesh import PartitionSpec
from p2pfl_tpu_torch.telemetry import REGISTRY

log = logging.getLogger("p2pfl_tpu_torch")

Pytree = Any

_JOURNAL_SAVES = REGISTRY.counter(
    "p2pfl_recovery_journal_saves_total",
    "Write-ahead recovery-journal snapshots committed to disk",
    labels=("node",),
)

#: The per-step commit marker, written as the final act of a save (the JAX
#: package's orbax name, so a torn step looks the same in both). A step
#: directory without it is torn and must be skipped by ``latest_step`` /
#: ``restore``.
_COMMIT_MARKER = "_CHECKPOINT_METADATA"
_STATE_FILE = "state.pt"
_META_FILE = "meta.json"
_TMP_PREFIX = ".tmp-"
_REPLICATED_FILE = "replicated.pt"
#: The meta record's entry that describes a sharded step's layout.
SHARDED_KEY = "sharded"
#: Over ranks, how long rank 0 waits for every rank's shard, and the other
#: ranks for rank 0's commit, before the save fails (seconds).
_COMMIT_TIMEOUT_S = 600.0

#: Stages of the saves in flight in this process: the sweep at open leaves them.
_LIVE_STAGES: set = set()
_LIVE_LOCK = threading.Lock()


def _set_live(stage: str, live: bool) -> None:
    with _LIVE_LOCK:
        (_LIVE_STAGES.add if live else _LIVE_STAGES.discard)(stage)


def _fsync_dir(path: str) -> None:
    """fsync a directory so a completed rename survives power loss.
    Best-effort: not every filesystem supports a directory fsync."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _write_synced(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def _save_synced(path: str, flat: Dict[str, torch.Tensor]) -> int:
    """``torch.save`` ``flat`` to ``path``, fsynced; returns the file's bytes."""
    with open(path, "wb") as f:
        torch.save(flat, f)
        f.flush()
        os.fsync(f.fileno())
    return os.path.getsize(path)


def _tensor_bytes(flat: Dict[str, torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in flat.values())


def _shard_file(rank: int, world: int) -> str:
    return f"shard-{rank:05d}-of-{world:05d}.pt"


def _joined_rank() -> int:
    """This process' rank in a joined process group (0 when none is joined)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _dtype_of(leaf: Any) -> Any:
    """A template leaf's dtype as torch names it."""
    return leaf.dtype if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.zeros(0, leaf.dtype)).dtype


# --- pytree <-> flat {path: CPU tensor} ---------------------------------------------


def _flatten(tree: Pytree, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    """Host copies of ``tree``'s leaves under '/'-joined paths: dict keys,
    list indices and dataclass fields (``AdamState`` / ``TraceState``).
    ``None`` leaves are not stored. The copies are the caller's own: a CUDA
    leaf is copied to the host synchronously, a CPU tensor or numpy leaf is
    cloned, so later in-place updates do not reach them."""
    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        out[prefix] = t.cpu() if t.device.type != "cpu" else t.clone()
    elif isinstance(tree, np.ndarray):
        out[prefix] = torch.from_numpy(np.array(tree, copy=True))
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}/{k}" if prefix else str(k), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}/{i}" if prefix else str(i), out)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            _flatten(getattr(tree, f.name), f"{prefix}/{f.name}" if prefix else f.name, out)
    else:
        raise TypeError(f"checkpoint leaf {prefix!r} has unsupported type {type(tree).__name__}")


def _split_dims(shards: Any) -> Dict[str, int]:
    """``{path: dimension}`` of the leaves split over the ranks in a
    :class:`~p2pfl_tpu_torch.population.sharding.StateShards` (the paths
    :func:`_flatten` gives the state tree); the other leaves are whole."""
    out: Dict[str, int] = {}

    def walk(tree: Any, prefix: str) -> None:
        if isinstance(tree, PartitionSpec):
            d = shards.split_dim(tree)
            if d is not None:
                out[prefix] = d
        elif isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}/{k}" if prefix else str(k))
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                walk(v, f"{prefix}/{i}" if prefix else str(i))
        elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
            for f in dataclasses.fields(tree):
                walk(getattr(tree, f.name), f"{prefix}/{f.name}" if prefix else f.name)

    walk(shards.specs, "")
    return out


def _restore_leaf(t: Any, r: torch.Tensor, path: str) -> Any:
    """Place the loaded ``r`` as template leaf ``t`` is placed: a tensor
    onto ``t``'s device, a numpy leaf as numpy. A shape or dtype that
    differs from the template's raises."""
    if isinstance(t, torch.Tensor):
        if tuple(r.shape) != tuple(t.shape) or r.dtype != t.dtype:
            raise ValueError(f"{path}: stored {r.dtype}{tuple(r.shape)} != template {t.dtype}{tuple(t.shape)}")
        return r.to(t.device)
    if isinstance(t, np.ndarray):
        a = r.numpy()
        if a.shape != t.shape or a.dtype != t.dtype:
            raise ValueError(f"{path}: stored {a.dtype}{a.shape} != template {t.dtype}{t.shape}")
        return a
    raise TypeError(f"checkpoint template leaf {path!r} has unsupported type {type(t).__name__}")


def _unflatten(template: Pytree, load: Callable[[str, Any], torch.Tensor], prefix: str, used: set) -> Pytree:
    """``template``'s structure with every leaf ``load(path, leaf)``, placed
    as the template leaf is (:func:`_restore_leaf`)."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten(v, load, f"{prefix}/{k}" if prefix else str(k), used) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        out = [_unflatten(v, load, f"{prefix}/{i}" if prefix else str(i), used) for i, v in enumerate(template)]
        return out if isinstance(template, list) else type(template)(out)
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return type(template)(**{
            f.name: _unflatten(getattr(template, f.name), load, f"{prefix}/{f.name}" if prefix else f.name, used)
            for f in dataclasses.fields(template)
        })
    if not isinstance(template, (torch.Tensor, np.ndarray)):
        raise TypeError(f"checkpoint template leaf {prefix!r} has unsupported type {type(template).__name__}")
    used.add(prefix)
    return _restore_leaf(template, load(prefix, template), prefix)


class FLCheckpointer:
    """Round-indexed checkpoint store.

    Args:
        directory: checkpoint root (created if missing; made absolute).
            Over ranks every rank names the same root on a shared
            filesystem.
        max_to_keep: retained snapshots (oldest pruned; over ranks by rank 0).
        save_interval: only save when ``round % save_interval == 0``.
    """

    def __init__(self, directory: str, max_to_keep: int = 3, save_interval: int = 1) -> None:
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max(1, int(max_to_keep))
        self.save_interval = max(1, int(save_interval))
        self.commit_timeout_s = _COMMIT_TIMEOUT_S
        self._lock = threading.Lock()  # guards the writer handle, its error and the timings
        self._serial = threading.Lock()  # one save at a time: drain, copy, start
        self._writer: Optional[threading.Thread] = None
        self._writer_error: Optional[Exception] = None
        #: The last save's timings and sizes on this rank, once it landed:
        #: ``host_copy_ms``, ``write_ms``, ``commit_wait_ms`` (over ranks:
        #: rank 0's wait for every shard and its commit, the others' wait
        #: for the commit), ``file_bytes`` and ``tensor_bytes`` (this rank's
        #: shard, or the one-process state file) and, on rank 0 of a sharded
        #: step, ``replicated_file_bytes`` / ``replicated_tensor_bytes``.
        self.last_save: Dict[str, Any] = {}
        #: The last restore's ``step``, ``load_ms``, ``files`` read and
        #: ``tensor_bytes`` assembled on this rank.
        self.last_load: Dict[str, Any] = {}
        # A crash mid-save leaves a temp-staged step: sweep stale ones at
        # (re)open so a restarted process never accumulates them. Over ranks
        # only rank 0 sweeps (another rank opening late would delete a stage
        # rank 0 is still writing), and never a stage of this process's
        # saves in flight.
        if _joined_rank() == 0:
            with _LIVE_LOCK:
                live = set(_LIVE_STAGES)
            for name in os.listdir(self.directory):
                path = os.path.join(self.directory, name)
                if name.startswith(_TMP_PREFIX) and path not in live:
                    shutil.rmtree(path, ignore_errors=True)

    # --- crash safety ----------------------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def _step_complete(self, step: int) -> bool:
        """A step is trustworthy only once its commit marker exists: a bare
        directory a crash left behind is torn and is skipped."""
        return os.path.exists(os.path.join(self._step_dir(step), _COMMIT_MARKER))

    # --- generic pytree + metadata ---------------------------------------------------

    def save(self, step: int, state: Pytree, meta: Optional[Dict[str, Any]] = None, *, shards: Any = None) -> bool:
        """Save ``state`` (a tree of tensors / numpy arrays in dicts, lists
        and optimizer-state dataclasses) and the JSON-able ``meta`` at
        ``step``.

        ``shards`` (a :class:`~p2pfl_tpu_torch.population.sharding.StateShards`
        over a rank mesh of W > 1 ranks) makes it a sharded step and the
        call a collective: every rank calls it with the same step, passing
        its own part of the state; each writes only the leaves its shards
        split, rank 0 also the whole ones, and rank 0 commits once every
        rank's shard is on disk (the module docstring's layout). No
        population row moves between the ranks.

        The host copy of every leaf is taken before this returns; the files
        are written on a writer thread (:meth:`wait` joins it). A save
        first drains the one in flight and raises its error, if it had one.
        Returns False (and skips) when the step is off the save interval.
        """
        if step % self.save_interval != 0:
            return False
        with self._serial:
            self._drain()
            meta = dict(meta or {})
            meta_bytes = json.dumps(meta).encode()  # meta that JSON cannot hold raises here
            t0 = time.monotonic()
            flat: Dict[str, torch.Tensor] = {}
            _flatten(state, "", flat)
            copy_ms = (time.monotonic() - t0) * 1e3
            if shards is not None and shards.mesh.world > 1:
                target, args = self._write_sharded_step, self._sharded_args(int(step), flat, meta, shards, copy_ms)
            else:
                target, args = self._write_step, (self._stage(step, uuid.uuid4().hex), int(step), flat, meta_bytes,
                                                  copy_ms)
            # Live before this returns: a checkpointer opened on the root
            # right after must not sweep the stage, which another rank may
            # already be writing into while this rank's writer has not run.
            _set_live(args[0], True)
            writer = threading.Thread(target=target, args=args, name=f"checkpoint-writer-{step}", daemon=True)
            with self._lock:
                # Started before it is published: a drain on another thread
                # must never join a thread that has not started.
                writer.start()
                self._writer = writer
        return True

    def _stage(self, step: int, token: str) -> str:
        return os.path.join(self.directory, f"{_TMP_PREFIX}{step}-{token}")

    def _sharded_args(self, step: int, flat: Dict[str, torch.Tensor], meta: Dict[str, Any], shards: Any,
                      copy_ms: float) -> tuple:
        """The sharded writer's arguments: the stage named by rank 0's token
        (broadcast here, on the calling thread, in the rounds' program
        order), this rank's split leaves, rank 0's whole leaves and the
        layout for the meta."""
        from p2pfl_tpu_torch.parallel import collectives

        mesh = shards.mesh
        token = f"{collectives.broadcast_ints([uuid.uuid4().int >> 66], 0, mesh.group, mesh.device)[0]:016x}"
        dims = _split_dims(shards)
        local = {p: t for p, t in flat.items() if p in dims}
        whole = {p: t for p, t in flat.items() if p not in dims} if mesh.rank == 0 else {}
        meta[SHARDED_KEY] = {
            "world": mesh.world, "axis": mesh.rank_axis, "token": token,
            "files": [_shard_file(r, mesh.world) for r in range(mesh.world)], "replicated": _REPLICATED_FILE,
            "split": {p: [d, int(t.shape[d]) * mesh.world] for p, t in local.items() for d in (dims[p],)},
        }
        return self._stage(step, token), step, token, mesh.rank, mesh.world, local, whole, meta, copy_ms

    def _write_step(self, stage: str, step: int, flat: Dict[str, torch.Tensor], meta_bytes: bytes,
                    copy_ms: float) -> None:
        """Stage, fsync, commit-mark, rename into place, fsync the root,
        prune (runs on the writer thread; ``save`` marked ``stage`` live)."""
        try:
            t0 = time.monotonic()
            os.makedirs(stage)
            nbytes = _save_synced(os.path.join(stage, _STATE_FILE), flat)
            _write_synced(os.path.join(stage, _META_FILE), meta_bytes)
            write_ms = (time.monotonic() - t0) * 1e3
            t1 = time.monotonic()
            self._commit(stage, step)
            self._record_save(step=step, host_copy_ms=copy_ms, write_ms=write_ms,
                              commit_wait_ms=(time.monotonic() - t1) * 1e3, file_bytes=nbytes,
                              tensor_bytes=_tensor_bytes(flat))
        except Exception as exc:  # noqa: BLE001 - handed to wait() / the next save
            shutil.rmtree(stage, ignore_errors=True)
            with self._lock:
                self._writer_error = exc
        finally:
            _set_live(stage, False)

    def _commit(self, stage: str, step: int) -> None:
        """Write the marker into the complete ``stage``, rename it into place,
        fsync the root and prune."""
        _write_synced(os.path.join(stage, _COMMIT_MARKER), b"{}")
        _fsync_dir(stage)
        final = self._step_dir(step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(stage, final)
        _fsync_dir(self.directory)
        for old in self._steps()[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)

    def _record_save(self, **timing: Any) -> None:
        with self._lock:
            self.last_save = timing

    def _write_sharded_step(self, stage: str, step: int, token: str, rank: int, world: int,
                            local: Dict[str, torch.Tensor], whole: Dict[str, torch.Tensor], meta: Dict[str, Any],
                            copy_ms: float) -> None:
        """This rank's part of a sharded step (runs on the writer thread;
        ``save`` marked ``stage`` live): its shard, rank 0's whole leaves,
        its ``done-<r>`` file; then rank 0 waits for every rank's and
        commits, and the others wait for the commit."""
        try:
            t0 = time.monotonic()
            os.makedirs(stage, exist_ok=True)
            timing: Dict[str, Any] = {
                "step": step, "rank": rank, "world": world, "host_copy_ms": copy_ms,
                "file_bytes": _save_synced(os.path.join(stage, _shard_file(rank, world)), local),
                "tensor_bytes": _tensor_bytes(local)}
            if rank == 0:
                timing["replicated_file_bytes"] = _save_synced(os.path.join(stage, _REPLICATED_FILE), whole)
                timing["replicated_tensor_bytes"] = _tensor_bytes(whole)
            timing["write_ms"] = (time.monotonic() - t0) * 1e3
            t1 = time.monotonic()
            self._mark_done(stage, rank, {k: timing[k] for k in ("file_bytes", "tensor_bytes")})
            if rank == 0:
                done = self._await_ranks(stage, world, step)
                meta[SHARDED_KEY].update(
                    file_bytes=[d["file_bytes"] for d in done], tensor_bytes=[d["tensor_bytes"] for d in done],
                    replicated_file_bytes=timing["replicated_file_bytes"],
                    replicated_tensor_bytes=timing["replicated_tensor_bytes"])
                for r in range(world):
                    os.remove(os.path.join(stage, f"done-{r}"))
                _write_synced(os.path.join(stage, _META_FILE), json.dumps(meta).encode())
                self._commit(stage, step)
            else:
                self._await_commit(stage, step, token)
            timing["commit_wait_ms"] = (time.monotonic() - t1) * 1e3
            self._record_save(**timing)
        except Exception as exc:  # noqa: BLE001 - handed to wait() / the next save
            if rank == 0:
                shutil.rmtree(stage, ignore_errors=True)
            elif os.path.isdir(stage):
                try:  # rank 0 stops waiting for this rank
                    _write_synced(os.path.join(stage, f"failed-{rank}"), repr(exc).encode())
                except OSError:
                    pass
            with self._lock:
                self._writer_error = exc
        finally:
            _set_live(stage, False)

    def _mark_done(self, stage: str, rank: int, info: Dict[str, Any]) -> None:
        """This rank's shard is on disk: its ``done-<r>`` file, fsynced and
        renamed into place whole (rank 0 reads it once the name appears)."""
        path = os.path.join(stage, f"done-{rank}")
        _write_synced(path + ".part", json.dumps(info).encode())
        os.rename(path + ".part", path)
        _fsync_dir(stage)

    def _await_ranks(self, stage: str, world: int, step: int) -> List[Dict[str, Any]]:
        """Rank 0: every rank's ``done-<r>`` record, once all are in the stage."""
        deadline = time.monotonic() + self.commit_timeout_s
        while True:
            names = set(os.listdir(stage))
            failed = sorted(n for n in names if n.startswith("failed-"))
            if failed:
                raise RuntimeError(f"sharded save of step {step}: rank {failed[0][7:]} failed")
            if all(f"done-{r}" in names for r in range(world)):
                break
            if time.monotonic() > deadline:
                missing = [r for r in range(world) if f"done-{r}" not in names]
                raise TimeoutError(f"sharded save of step {step}: ranks {missing} wrote no shard within "
                                   f"{self.commit_timeout_s} s; the step stays uncommitted")
            time.sleep(0.005)
        out = []
        for r in range(world):
            with open(os.path.join(stage, f"done-{r}"), "rb") as f:
                out.append(json.loads(f.read().decode()))
        return out

    def _await_commit(self, stage: str, step: int, token: str) -> None:
        """A rank other than 0: wait until rank 0 renamed the stage, and check
        the committed step is this save's."""
        deadline = time.monotonic() + self.commit_timeout_s
        while os.path.isdir(stage):
            if time.monotonic() > deadline:
                raise TimeoutError(f"sharded save of step {step}: rank 0 did not commit within "
                                   f"{self.commit_timeout_s} s")
            time.sleep(0.005)
        try:
            got = self._read_meta(step)[SHARDED_KEY]["token"] if self._step_complete(step) else None
        except Exception:  # noqa: BLE001 - unreadable: not this save's commit
            got = None
        if got != token:
            raise RuntimeError(f"sharded save of step {step} was not committed (rank 0 failed or gave up)")

    def _drain(self) -> None:
        """Join the save in flight (from any thread) and raise its error."""
        with self._lock:
            writer = self._writer
        if writer is not None:
            writer.join()
        with self._lock:
            if self._writer is writer:
                self._writer = None
            err, self._writer_error = self._writer_error, None
        if err is not None:
            raise RuntimeError(f"checkpoint write under {self.directory} failed: {err!r}") from err

    def restore(self, template: Pytree, step: Optional[int] = None, *, shards: Any = None):
        """Restore ``(state, meta)`` at ``step`` (default: the newest
        restorable).

        ``template`` gives structure, shapes, dtypes and placement: its
        tensor leaves' devices receive the restored tensors (a CUDA template
        restores onto the card), numpy leaves come back as numpy. A shape or
        dtype that differs from the template's raises. Either layout (one
        process, or sharded over any number of ranks) restores: with
        ``shards`` over W > 1 ranks (a collective) ``template`` is this
        rank's part and gets its part of every split leaf, re-cut from the
        saved parts; without, every leaf whole.

        With ``step=None``, torn or unreadable snapshots are skipped: the
        walk tries complete steps newest-first and returns the first that
        loads, raising :class:`FileNotFoundError` only when none does. Over
        ranks every rank restores the same step: the newest whose every
        needed part loads on every rank.
        """
        return self._walk(template, step, None, shards)

    def _read_meta(self, step: int) -> Dict[str, Any]:
        with open(os.path.join(self._step_dir(step), _META_FILE), "rb") as f:
            return dict(json.loads(f.read().decode()) or {})

    def _load_step(self, template: Pytree, step: int, shards: Any = None) -> Pytree:
        """``template``'s state from ``step``: every leaf's part this rank
        holds (``shards``; the whole leaf without), re-cut from the saved
        parts that overlap it. Files are memory-mapped and opened only when
        a part of theirs is needed."""
        from p2pfl_tpu_torch.population.sharding import part_range, recut

        t0 = time.monotonic()
        root = self._step_dir(step)
        layout = self._read_meta(step).get(SHARDED_KEY)
        files: Dict[str, Dict[str, torch.Tensor]] = {}

        def opened(name: str) -> Dict[str, torch.Tensor]:
            if name not in files:
                files[name] = torch.load(os.path.join(root, name), weights_only=True, map_location="cpu", mmap=True)
            return files[name]

        whole_file = _STATE_FILE if layout is None else layout["replicated"]
        split = {} if layout is None else {p: (int(d), int(n)) for p, (d, n) in layout["split"].items()}
        saved = set(opened(whole_file)) | set(split)
        ranked = shards is not None and shards.mesh.world > 1
        want = _split_dims(shards) if ranked else {}
        assembled = [0]

        def load(path: str, leaf: Any) -> torch.Tensor:
            if path not in saved:
                raise KeyError(f"checkpoint has no leaf {path!r}")
            shape = list(leaf.shape)
            box = [(0, n) for n in shape]
            if path in want:  # this rank's part of the whole leaf
                d = want[path]
                shape[d] *= shards.mesh.world
                box[d] = part_range(shape[d], shards.mesh.rank, shards.mesh.world)
            if path in split:
                d, n = split[path]
                saved_world = len(layout["files"])
                pieces = []
                for r in range(saved_world):
                    lo, hi = part_range(n, r, saved_world)
                    if d < len(box) and (lo >= box[d][1] or hi <= box[d][0]) and box[d][1] > box[d][0]:
                        continue  # no overlap with this rank's part: the file is not read
                    t = opened(layout["files"][r])[path]
                    pieces.append(([(lo, hi) if i == d else (0, s) for i, s in enumerate(t.shape)], t))
                stored = list(pieces[0][1].shape)
                stored[d] = n
            else:
                t = opened(whole_file)[path]
                pieces, stored = [([(0, s) for s in t.shape], t)], list(t.shape)
            if stored != shape or pieces[0][1].dtype != _dtype_of(leaf):
                raise ValueError(f"{path}: stored {pieces[0][1].dtype}{tuple(stored)} != template "
                                 f"{_dtype_of(leaf)}{tuple(shape)}")
            out = recut(pieces, box, path)
            assembled[0] += out.numel() * out.element_size()
            return out

        used: set = set()
        state = _unflatten(template, load, "", used)
        extra = sorted(saved - used)
        if extra:
            raise ValueError(f"checkpoint holds leaves the template lacks: {extra[:4]}")
        with self._lock:
            self.last_load = {"step": step, "load_ms": (time.monotonic() - t0) * 1e3, "files": sorted(files),
                              "tensor_bytes": assembled[0]}
        return state

    def restore_meta(self, step: Optional[int] = None) -> dict:
        """Restore only the JSON meta record at ``step`` (default: the newest
        restorable; torn steps are skipped as :meth:`restore` skips them),
        so callers can check configuration pins before the structural
        restore."""
        self._drain()
        if step is None:
            for s in sorted(self._steps(), reverse=True):
                try:
                    return self._read_meta(s)
                except Exception as exc:  # noqa: BLE001 - torn step: try older
                    log.warning("checkpoint meta at step %s under %s unreadable (%s) — falling back",
                                s, self.directory, exc)
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        if not self._step_complete(step):
            raise FileNotFoundError(f"checkpoint step {step} under {self.directory} is torn/absent")
        return self._read_meta(step)

    def restore_coherent(self, template: Pytree, step: Optional[int] = None, check_meta=None, *, shards: Any = None):
        """Restore ``(state, meta)`` with both drawn from the same step.

        The walk reads a step's meta, then its state, and falls back to the
        next-older step on any read failure, so a step whose meta survived
        while its state is torn never pairs one step's cursor with another's
        weights. ``check_meta(meta)``, when given, runs between the two
        reads; what it raises propagates (a configuration-pin mismatch is
        the caller's error, not a torn snapshot). ``shards`` as in
        :meth:`restore`: over ranks every rank reaches the same verdict on
        each step before it moves on.
        """
        return self._walk(template, step, check_meta, shards)

    def _walk(self, template: Pytree, step: Optional[int], check_meta, shards: Any):
        """The walk of :meth:`restore` and :meth:`restore_coherent`: ``step``,
        or every committed step newest first, until one whose meta reads and
        whose state loads, with ``check_meta(meta)`` between the two reads.
        Over ranks (``shards`` over W > 1 ranks; a collective) every rank
        walks rank 0's list of steps and takes a step only when its meta
        reads and its every needed part loads on every rank; on one process
        both agreements are this process's own verdict. An explicit ``step``
        that does not restore raises (this rank's error where it failed)."""
        if shards is not None and shards.mesh.world > 1:
            from p2pfl_tpu_torch.parallel.collectives import all_agree, broadcast_ints

            mesh = shards.mesh

            def agree(ok: bool) -> bool:
                return all_agree(ok, mesh.group, mesh.device)

            def steps(ss: List[int]) -> List[int]:
                return broadcast_ints(ss, 0, mesh.group, mesh.device)
        else:
            agree, steps = bool, list
        self._drain()
        candidates = [int(step)] if step is not None else steps(sorted(self._steps(), reverse=True))
        if not candidates:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        last_exc: Optional[Exception] = None
        for s in candidates:
            meta = state = None
            try:
                if not self._step_complete(s):
                    raise FileNotFoundError(f"checkpoint step {s} under {self.directory} is torn/absent")
                meta = self._read_meta(s)
            except Exception as exc:  # noqa: BLE001 - torn meta: every rank tries older
                last_exc = exc
            if agree(meta is not None):
                if check_meta is not None:
                    check_meta(meta)
                try:
                    state = self._load_step(template, s, shards)
                except Exception as exc:  # noqa: BLE001 - torn state: every rank tries older
                    last_exc = exc
                if agree(state is not None):
                    return state, meta
            if step is not None:
                if last_exc is not None:
                    raise last_exc
                raise FileNotFoundError(f"checkpoint step {s} under {self.directory} does not restore on every rank")
            log.warning("checkpoint step %s under %s unreadable (here: %s) — falling back to the previous snapshot",
                        s, self.directory, last_exc)
        raise FileNotFoundError(f"no restorable checkpoint under {self.directory} (last error here: {last_exc})")

    # --- ModelHandle convenience -----------------------------------------------------

    def save_model(self, step: int, model) -> bool:
        """Snapshot a ModelHandle: params + federation metadata."""
        meta = {
            "contributors": list(model.contributors),
            "num_samples": int(model.num_samples),
            "additional_info": _jsonable(model.additional_info),
        }
        return self.save(step, model.params, meta)

    def restore_model(self, template_model, step: Optional[int] = None):
        """Restore into a copy of ``template_model`` (same module)."""
        params, meta = self.restore(template_model.params, step)
        out = template_model.build_copy(params=params)
        out.contributors = list(meta.get("contributors", []))
        out.num_samples = int(meta.get("num_samples", 1))
        out.additional_info = dict(meta.get("additional_info", {}))
        return out

    # --- bookkeeping -----------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return max(steps) if steps else None

    def all_steps(self) -> List[int]:
        """Complete (committed) steps only, ascending, once the save in
        flight has landed: torn directories are never a resume point."""
        self._drain()
        return self._steps()

    def _steps(self) -> List[int]:
        steps = [int(n) for n in os.listdir(self.directory) if n.isdigit()]
        return sorted(s for s in steps if self._step_complete(s))

    def wait(self) -> None:
        """Block until the save in flight has landed (raising its error),
        then fsync the root and the newest step's directory."""
        self._drain()
        _fsync_dir(self.directory)
        latest = self.latest_step()
        if latest is not None:
            _fsync_dir(self._step_dir(latest))

    def close(self) -> None:
        self._drain()

    def __enter__(self) -> "FLCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class NodeJournal:
    """Write-ahead node-state journal: the recovery closure of one wire node,
    snapshotted per round.

    It holds what :meth:`p2pfl_tpu_torch.node.Node.resume` needs to bring a
    crashed node back as itself mid-experiment: the model params and
    contributor metadata; the sparse-delta wire state (the round anchor and
    the error-feedback residuals, restored bit-exact); the round position,
    scheduler mode, epochs and total rounds; the known membership and
    per-peer round status; the privacy plane's key material. Steps are
    indexed by round and ride :class:`FLCheckpointer`'s crash-safe path.
    """

    def __init__(self, directory: str, max_to_keep: Optional[int] = None, every: Optional[int] = None) -> None:
        from p2pfl_tpu_torch.config import Settings

        self._ck = FLCheckpointer(directory, max_to_keep=max_to_keep or Settings.RECOVERY_JOURNAL_KEEP,
                                  save_interval=1)
        self.every = max(1, int(every or Settings.RECOVERY_JOURNAL_EVERY))

    @property
    def directory(self) -> str:
        return self._ck.directory

    # --- write side ------------------------------------------------------------------

    def snapshot(self, node) -> bool:
        """Journal ``node``'s recovery closure at its current round. No-op
        (False) outside an experiment or when this round is already
        journaled."""
        state = node.state
        r = state.round
        if state.experiment is None or r is None:
            return False
        if r in self._ck.all_steps():
            return False  # this position is already durable
        model = node.learner.get_model()
        wire_st = state.wire.export_state()
        tree: Dict[str, Any] = {"params": list(model.get_parameters())}
        if wire_st["anchor"] is not None:
            tree["anchor"] = wire_st["anchor"]
        if wire_st["residual"] is not None:
            tree["residual"] = wire_st["residual"]
        try:
            membership = list(node.protocol.get_neighbors(only_direct=False))
        except Exception:  # noqa: BLE001 - protocol stopping; journal anyway
            membership = []
        meta = {
            "journal_version": 1,
            "addr": node.addr,
            "round": int(r),
            "total_rounds": int(state.total_rounds or 0),
            "epochs": int(state.epochs),
            "fed_mode": state.fed_mode,
            "exp_name": state.experiment.exp_name,
            "anchor_round": int(wire_st["anchor_round"]),
            "anchor_crc": int(wire_st["anchor_crc"]),
            "anchor_shapes": [list(s) for s in (wire_st["shapes"] or [])],
            "has_anchor": wire_st["anchor"] is not None,
            "has_residual": wire_st["residual"] is not None,
            "membership": membership,
            "nei_status": {k: int(v) for k, v in state.nei_status.items()},
            "contributors": list(model.contributors),
            "num_samples": int(model.get_num_samples()),
            # The privacy plane's session keypair and learned peer keys: a
            # restarted masker re-derives the same pair masks, so its re-sent
            # masked frame cancels as the lost one would have.
            "privacy": state.privacy.export_state(),
        }
        saved = self._ck.save(int(r), tree, meta)
        if saved:
            _JOURNAL_SAVES.labels(node.addr).inc()
            try:
                node.protocol.flight_recorder.record("journal", round=int(r), steps=len(self._ck._steps()))
            except Exception:  # noqa: BLE001 - observability must not raise
                pass
        return saved

    # --- read side -------------------------------------------------------------------

    def latest_meta(self) -> Dict[str, Any]:
        """The newest restorable snapshot's metadata (FileNotFoundError when
        the journal is empty; torn steps are skipped)."""
        return self._ck.restore_meta()

    def restore_into(self, node) -> Dict[str, Any]:
        """Load the newest restorable snapshot into ``node``: params and
        contribution, the delta anchor and residuals (bit-exact), per-peer
        round status and the privacy key material. Older snapshots are
        tried when the newest is torn. Returns the metadata (also kept as
        ``node._resume_meta`` for :meth:`~p2pfl_tpu_torch.node.Node.resume_learning`)."""
        steps = sorted(self._ck.all_steps(), reverse=True)
        last_exc: Optional[Exception] = None
        for step in steps:
            try:
                meta = self._ck.restore_meta(step)
                model = node.learner.get_model()
                tree_t: Dict[str, Any] = {"params": list(model.get_parameters())}
                flat_sizes = [int(np.prod(s, dtype=np.int64)) if s else 1 for s in meta.get("anchor_shapes") or []]
                if meta.get("has_anchor"):
                    tree_t["anchor"] = [np.zeros((n,), np.float32) for n in flat_sizes]
                if meta.get("has_residual"):
                    tree_t["residual"] = [np.zeros((n,), np.float32) for n in flat_sizes]
                tree, _ = self._ck.restore(tree_t, step)
                model.set_parameters(tree["params"])
                model.set_contribution(list(meta.get("contributors") or [node.addr]), int(meta.get("num_samples", 1)))
                shapes = [tuple(s) for s in meta.get("anchor_shapes") or []]
                node.state.wire.import_state({
                    "anchor": tree.get("anchor"),
                    "shapes": shapes or None,
                    "anchor_round": meta.get("anchor_round", -1),
                    "anchor_crc": meta.get("anchor_crc", 0),
                    "residual": tree.get("residual"),
                })
                node.state.nei_status.update({k: int(v) for k, v in (meta.get("nei_status") or {}).items()})
                node.state.privacy.import_state(meta.get("privacy") or {})
                node._resume_meta = dict(meta)
                return dict(meta)
            except Exception as exc:  # noqa: BLE001 - torn step: fall back
                last_exc = exc
                log.warning("journal step %s under %s unrestorable (%s) — trying the previous snapshot",
                            step, self.directory, exc)
        raise FileNotFoundError(f"no restorable journal under {self.directory} (last error: {last_exc})")

    # --- bookkeeping -----------------------------------------------------------------

    def all_steps(self) -> List[int]:
        return self._ck.all_steps()

    def wait(self) -> None:
        self._ck.wait()

    def close(self) -> None:
        self._ck.close()

    def __enter__(self) -> "NodeJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def attach_node_journal(node, journal: NodeJournal) -> None:
    """Journal the node's recovery closure at every ``journal.every``-th
    round end and at the last round (and expose the journal on the node, so
    quorum parking can snapshot on demand: ``Node.journal_now``)."""
    node.recovery_journal = journal

    def hook(n) -> None:
        r = n.state.round
        if r is None:
            return
        total = n.state.total_rounds or 0
        if r % journal.every == 0 or r >= total:
            journal.snapshot(n)

    node.round_end_hooks.append(hook)


def attach_node_checkpointing(node, checkpointer: FLCheckpointer) -> None:
    """Federation mode: snapshot the node's model at every round end (the
    saved step is the round just finished)."""

    def hook(n) -> None:
        r = n.state.round
        finished = (r - 1) if r is not None else 0
        checkpointer.save_model(max(finished, 0), n.learner.get_model())

    node.round_end_hooks.append(hook)


def _jsonable(d: Dict[str, Any]) -> Dict[str, Any]:
    """Drop or convert values JSON can't carry (numpy scalars to Python,
    arrays and tensors to lists)."""
    out: Dict[str, Any] = {}
    for k, v in d.items():
        if isinstance(v, np.generic):
            out[k] = v.item()
        elif isinstance(v, np.ndarray):
            out[k] = v.tolist()
        elif isinstance(v, torch.Tensor):
            out[k] = v.detach().cpu().tolist()
        elif isinstance(v, (str, int, float, bool, list, dict, type(None))):
            out[k] = v
    return out
