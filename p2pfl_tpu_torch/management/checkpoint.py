"""Checkpoint / resume (counterpart of ``p2pfl_tpu/management/checkpoint.py``,
written on torch).

Snapshots of

* a single :class:`~p2pfl_tpu_torch.models.model_handle.ModelHandle`
  (federation mode: one node's model + contributor metadata per round),
* an entire :class:`~p2pfl_tpu_torch.parallel.simulation.MeshSimulation`
  population (stacked params + optimizer state + round counter), restored
  onto the template's devices so a resumed run stays on the card, and
* a wire node's recovery closure (:class:`NodeJournal`).

On-disk layout, one directory per step under the checkpoint root::

    <root>/<step>/state.pt              torch.save of a flat {path: CPU tensor} dict
    <root>/<step>/meta.json             the JSON meta record
    <root>/<step>/_CHECKPOINT_METADATA  the commit marker, written last

The JAX package writes orbax checkpoints; neither package reads the other's.

Crash safety: a step is staged in a ``.tmp-*`` directory inside the root
(so the rename stays on one filesystem), its files are fsynced, the commit
marker is written last, the directory is renamed into place and the root
fsynced. A step directory without the marker is torn and invisible; stale
temp directories are swept when a checkpointer opens its root.

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
import uuid
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

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


def _unflatten(template: Pytree, flat: Dict[str, torch.Tensor], prefix: str, used: set) -> Pytree:
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten(v, flat, f"{prefix}/{k}" if prefix else str(k), used) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        out = [_unflatten(v, flat, f"{prefix}/{i}" if prefix else str(i), used) for i, v in enumerate(template)]
        return out if isinstance(template, list) else type(template)(out)
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return type(template)(**{
            f.name: _unflatten(getattr(template, f.name), flat, f"{prefix}/{f.name}" if prefix else f.name, used)
            for f in dataclasses.fields(template)
        })
    if prefix not in flat:
        raise KeyError(f"checkpoint has no leaf {prefix!r}")
    used.add(prefix)
    return _restore_leaf(template, flat[prefix], prefix)


class FLCheckpointer:
    """Round-indexed checkpoint store.

    Args:
        directory: checkpoint root (created if missing; made absolute).
        max_to_keep: retained snapshots (oldest pruned).
        save_interval: only save when ``round % save_interval == 0``.
    """

    def __init__(self, directory: str, max_to_keep: int = 3, save_interval: int = 1) -> None:
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max(1, int(max_to_keep))
        self.save_interval = max(1, int(save_interval))
        self._lock = threading.Lock()  # guards the writer handle and its error
        self._serial = threading.Lock()  # one save at a time: drain, copy, start
        self._writer: Optional[threading.Thread] = None
        self._writer_error: Optional[Exception] = None
        # A crash mid-save leaves a temp-staged step: sweep stale ones at
        # (re)open so a restarted process never accumulates them.
        for name in os.listdir(self.directory):
            if name.startswith(_TMP_PREFIX):
                shutil.rmtree(os.path.join(self.directory, name), ignore_errors=True)

    # --- crash safety ----------------------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def _step_complete(self, step: int) -> bool:
        """A step is trustworthy only once its commit marker exists: a bare
        directory a crash left behind is torn and is skipped."""
        return os.path.exists(os.path.join(self._step_dir(step), _COMMIT_MARKER))

    # --- generic pytree + metadata ---------------------------------------------------

    def save(self, step: int, state: Pytree, meta: Optional[Dict[str, Any]] = None) -> bool:
        """Save ``state`` (a tree of tensors / numpy arrays in dicts, lists
        and optimizer-state dataclasses) and the JSON-able ``meta`` at
        ``step``.

        The host copy of every leaf is taken before this returns; the files
        are written on a writer thread (:meth:`wait` joins it). A save
        first drains the one in flight and raises its error, if it had one.
        Returns False (and skips) when the step is off the save interval.
        """
        if step % self.save_interval != 0:
            return False
        with self._serial:
            self._drain()
            meta_bytes = json.dumps(meta or {}).encode()  # meta that JSON cannot hold raises here
            flat: Dict[str, torch.Tensor] = {}
            _flatten(state, "", flat)
            writer = threading.Thread(target=self._write_step, args=(int(step), flat, meta_bytes),
                                      name=f"checkpoint-writer-{step}", daemon=True)
            with self._lock:
                # Started before it is published: a drain on another thread
                # must never join a thread that has not started.
                writer.start()
                self._writer = writer
        return True

    def _write_step(self, step: int, flat: Dict[str, torch.Tensor], meta_bytes: bytes) -> None:
        """Stage, fsync, commit-mark, rename into place, fsync the root,
        prune (runs on the writer thread)."""
        stage = os.path.join(self.directory, f"{_TMP_PREFIX}{step}-{uuid.uuid4().hex}")
        try:
            os.makedirs(stage)
            state_path = os.path.join(stage, _STATE_FILE)
            with open(state_path, "wb") as f:
                torch.save(flat, f)
                f.flush()
                os.fsync(f.fileno())
            _write_synced(os.path.join(stage, _META_FILE), meta_bytes)
            _write_synced(os.path.join(stage, _COMMIT_MARKER), b"{}")
            _fsync_dir(stage)
            final = self._step_dir(step)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(stage, final)
            _fsync_dir(self.directory)
            for old in self._steps()[:-self.max_to_keep]:
                shutil.rmtree(self._step_dir(old), ignore_errors=True)
        except Exception as exc:  # noqa: BLE001 - handed to wait() / the next save
            shutil.rmtree(stage, ignore_errors=True)
            with self._lock:
                self._writer_error = exc

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

    def restore(self, template: Pytree, step: Optional[int] = None):
        """Restore ``(state, meta)`` at ``step`` (default: the newest
        restorable).

        ``template`` gives structure, shapes, dtypes and placement: its
        tensor leaves' devices receive the restored tensors (a CUDA template
        restores onto the card), numpy leaves come back as numpy. A shape or
        dtype that differs from the template's raises.

        With ``step=None``, torn or unreadable snapshots are skipped: the
        walk tries complete steps newest-first and returns the first that
        loads, raising :class:`FileNotFoundError` only when none does.
        """
        self._drain()
        if step is None:
            candidates = sorted(self._steps(), reverse=True)
            if not candidates:
                raise FileNotFoundError(f"no checkpoints under {self.directory}")
            last_exc: Optional[Exception] = None
            for s in candidates:
                try:
                    return self._restore_step(template, s)
                except Exception as exc:  # noqa: BLE001 - torn step: try older
                    last_exc = exc
                    log.warning("checkpoint step %s under %s unreadable (%s) — falling back to the previous "
                                "snapshot", s, self.directory, exc)
            raise FileNotFoundError(f"no restorable checkpoint under {self.directory} (last error: {last_exc})")
        if not self._step_complete(step):
            raise FileNotFoundError(f"checkpoint step {step} under {self.directory} is torn/absent")
        return self._restore_step(template, step)

    def _read_meta(self, step: int) -> Dict[str, Any]:
        with open(os.path.join(self._step_dir(step), _META_FILE), "rb") as f:
            return dict(json.loads(f.read().decode()) or {})

    def _restore_step(self, template: Pytree, step: int) -> Tuple[Pytree, Dict[str, Any]]:
        meta = self._read_meta(step)
        flat = torch.load(os.path.join(self._step_dir(step), _STATE_FILE), weights_only=True, map_location="cpu")
        used: set = set()
        state = _unflatten(template, flat, "", used)
        extra = sorted(set(flat) - used)
        if extra:
            raise ValueError(f"checkpoint holds leaves the template lacks: {extra[:4]}")
        return state, meta

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

    def restore_coherent(self, template: Pytree, step: Optional[int] = None, check_meta=None):
        """Restore ``(state, meta)`` with both drawn from the same step.

        The walk reads a step's meta, then its state, and falls back to the
        next-older step on any read failure, so a step whose meta survived
        while its state is torn never pairs one step's cursor with another's
        weights. ``check_meta(meta)``, when given, runs between the two
        reads; what it raises propagates (a configuration-pin mismatch is
        the caller's error, not a torn snapshot).
        """
        if step is not None:
            meta = self.restore_meta(step)
            if check_meta is not None:
                check_meta(meta)
            state, _ = self.restore(template, step)
            return state, meta
        candidates = sorted(self.all_steps(), reverse=True)
        if not candidates:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        last_exc: Optional[Exception] = None
        for s in candidates:
            try:
                meta = self.restore_meta(s)
            except Exception as exc:  # noqa: BLE001 - torn meta: try older
                last_exc = exc
                log.warning("checkpoint meta at step %s under %s unreadable (%s) — falling back to the previous "
                            "snapshot", s, self.directory, exc)
                continue
            if check_meta is not None:
                check_meta(meta)
            try:
                state, _ = self.restore(template, s)
            except Exception as exc:  # noqa: BLE001 - torn state: try older
                last_exc = exc
                log.warning("checkpoint state at step %s under %s unreadable (%s) — falling back to the previous "
                            "snapshot", s, self.directory, exc)
                continue
            return state, meta
        raise FileNotFoundError(
            f"no coherently restorable checkpoint under {self.directory} (last error: {last_exc})")

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
