"""Run context and evidence bundles — the fed_doctor capture plane (the port's framework-free copy of
``p2pfl_tpu/telemetry/bundle.py``, its imports rerouted to ``p2pfl_tpu_torch``).

Every observability stream the stack emits (trajectory ledger, flight
recorder, metrics registry, observatory snapshots, supervisor reports,
campaign records, bench meta blocks) is useful alone but only tells the
causal story when *joined* — and joining requires a shared key. This
module provides both halves:

* **Run context** — a federation-wide run id minted once per experiment
  or engine launch: a seeded-deterministic body (so parity/campaign
  replays mint the same id) plus a host-unique suffix (so two hosts
  launching the same seed stay distinguishable). It rides the reserved
  trailing control-arg path on the gRPC transport (``__run__:`` next to
  ``__trace__``/``__digest__``) and the :class:`Envelope` dataclass on
  the in-memory transport, so every node in a federation — whichever
  peer kicked off learning — stamps the SAME id into its artifacts.

* **Evidence bundles** — :func:`write_bundle` collects every
  run-id-matching signal into one versioned ``artifacts/bundle_<run_id>/``
  directory with a manifest (member list, schema versions, sha256 for the
  canonical members, clock-era info), then runs the diagnosis engine over
  it and drops ``incident.json`` for ``scripts/fed_doctor.py`` and the
  fed_top DIAGNOSIS banner. The failure hooks (workflow crash,
  supervisor park, devobs trip, campaign violation, bench assertion)
  call it; the happy path never does — bundle cost is zero unless
  something went wrong or a human asked.

Manifest determinism contract (make doctor-check replays it): everything
outside the manifest's ``excluded`` section is a pure function of the
run — member names, kinds, schema versions, and the sha256 of canonical
ledger dumps. Wall-clock timestamps and the hashes of timestamped
members live only under ``excluded``.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import shutil
import socket
import threading
import time
import traceback
from typing import Any, Dict, Iterable, List, Optional, Tuple

from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.telemetry.metrics import REGISTRY

log = logging.getLogger("p2pfl_tpu_torch")

#: bump when the common artifact header shape changes
ARTIFACT_SCHEMA_VERSION = 1
#: bump when the bundle manifest shape changes
BUNDLE_SCHEMA_VERSION = 1
#: reserved trailing control-arg prefix carrying the run id on the wire —
#: appended after the ``__trace__`` arg in ``_env_to_pb`` and popped first
#: (reverse order) in ``_pb_to_env``.
WIRE_ARG_PREFIX = "__run__:"

_BUNDLES = REGISTRY.counter(
    "p2pfl_doctor_bundles_total",
    "Evidence bundles written, by trigger (workflow_crash, supervisor_park, "
    "devobs_trip, campaign_violation, bench_assertion, manual).",
    labels=("trigger",),
)

_SAFE_RE = re.compile(r"[^A-Za-z0-9_.-]")

_lock = threading.Lock()
_run_id: str = ""


def _safe(name: str) -> str:
    return _SAFE_RE.sub("_", name) or "norun"


def _host_suffix() -> str:
    """4-hex host/process discriminator: two hosts launching the same
    seeded experiment mint distinguishable ids, while one host's id stays
    stable for the life of the process."""
    raw = f"{socket.gethostname()}:{os.getpid()}".encode()
    return hashlib.blake2b(raw, digest_size=2).hexdigest()


def mint_run_id(seed: Optional[int] = None, name: str = "") -> str:
    """Mint a run id: ``Settings.RUN_ID`` pin wins outright (CI replay
    harnesses need byte-stable manifests); otherwise a 12-hex body —
    seeded-deterministic when a seed is given, random when not — plus the
    host-unique suffix."""
    pinned = str(Settings.RUN_ID or "")
    if pinned:
        return pinned
    if seed is not None:
        body = hashlib.blake2b(
            f"p2pfl-run:{int(seed)}:{name}".encode(), digest_size=6
        ).hexdigest()
    else:
        import secrets

        body = secrets.token_hex(6)
    return f"{body}-{_host_suffix()}"


def _configure_siblings(rid: str) -> None:
    from p2pfl_tpu_torch.telemetry.ledger import LEDGERS

    if not LEDGERS.run_id:
        LEDGERS.configure(rid)
    try:
        REGISTRY.gauge(
            "p2pfl_run_info",
            "Run-identity info metric: 1 for the active run id — joins "
            "Prometheus scrapes to ledger/flightrec/bundle artifacts.",
            labels=("run_id",),
        ).labels(rid).set(1.0)
    except Exception:  # metrics must never take the run context down
        log.debug("run_info gauge refresh failed", exc_info=True)


def establish_run(
    seed: Optional[int] = None,
    name: str = "",
    run_id: Optional[str] = None,
    fresh: bool = False,
) -> str:
    """Establish the ambient run id for this process. Resolution order:
    explicit ``run_id`` arg > ``Settings.RUN_ID`` pin > the id already
    configured into ``LEDGERS`` (parity/campaign scenario runners pin it
    there first — adopting it keeps their canonical dumps byte-identical)
    > mint. First establish wins for the life of the process unless
    ``fresh=True`` (a new ``set_start_learning`` kickoff is a new
    experiment)."""
    global _run_id
    from p2pfl_tpu_torch.telemetry.ledger import LEDGERS

    with _lock:
        if _run_id and not fresh and run_id is None:
            return _run_id
        rid = (
            (run_id or "")
            or str(Settings.RUN_ID or "")
            # a FRESH establish is a new experiment: never re-adopt the
            # previous run's ledger pin
            or ("" if fresh else LEDGERS.run_id)
            or mint_run_id(seed, name)
        )
        _run_id = rid
    _configure_siblings(rid)
    return rid


def adopt_run_id(rid: str, force: bool = False) -> str:
    """Adopt a run id learned from the wire. First-wins: an established
    context ignores ids riding ordinary gossip/heartbeat frames (stale
    peers must not flip it mid-run); ``force=True`` — used for
    ``start_learning`` kickoff frames only — overwrites, so every node in
    a federation converges on the initiator's id."""
    global _run_id
    rid = str(rid or "")
    if not rid:
        return _run_id
    with _lock:
        if _run_id == rid or (_run_id and not force):
            return _run_id
        _run_id = rid
    _configure_siblings(rid)
    return rid


def current_run_id() -> str:
    """The ambient run id ("" before any establish/adopt). A
    ``Settings.RUN_ID`` pin always wins — replay harnesses see their
    pinned id even mid-run."""
    return str(Settings.RUN_ID or "") or _run_id


def reset_run() -> None:
    """Forget the ambient run id (test isolation)."""
    global _run_id
    with _lock:
        _run_id = ""


def artifact_header(
    node: str = "",
    kind: str = "",
    schema_version: int = ARTIFACT_SCHEMA_VERSION,
    run_id: Optional[str] = None,
) -> Dict[str, Any]:
    """The common versioned header every artifact carries: run id, schema
    version, emitting node, and clock-era info (wall + monotonic + the
    epoch mapping between them, so cross-artifact monotonic timestamps
    can be aligned after the fact). Old readers tolerate its absence."""
    wall = time.time()
    mono = time.monotonic()
    return {
        "run_id": current_run_id() if run_id is None else str(run_id),
        "schema_version": int(schema_version),
        "kind": str(kind),
        "node": str(node),
        "clock": {
            "wall": round(wall, 6),
            "mono": round(mono, 6),
            "mono_to_wall_epoch": round(wall - mono, 6),
        },
    }


# --- evidence bundles ---------------------------------------------------------


def bundle_dir(run_id: str, directory: Optional[str] = None) -> str:
    base = directory or str(Settings.DOCTOR_BUNDLE_DIR)
    return os.path.join(base, f"bundle_{_safe(run_id)}")


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 16), b""):
            h.update(chunk)
    return h.hexdigest()


def _write_json(path: str, doc: Any) -> None:
    # pid alone is not unique here: two node threads crashing in one
    # process write the same bundle members concurrently.
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def _doc_matches_run(doc: Any, rid: str) -> bool:
    """Pre-doctor artifacts (no header) are adopted; headered artifacts
    must match the bundle's run id (or carry none)."""
    if not isinstance(doc, dict):
        return True
    header = doc.get("header")
    if not isinstance(header, dict):
        return True
    return str(header.get("run_id", "")) in ("", rid)


#: sibling artifacts in the bundle's parent directory that get copied in
#: when their header matches the run (name -> manifest member kind).
_SIBLING_ARTIFACTS: Tuple[Tuple[str, str], ...] = (
    ("federation_snapshot.json", "snapshot"),
    ("parity_diff.json", "parity"),
)


def write_bundle(
    trigger: str,
    directory: Optional[str] = None,
    run_id: Optional[str] = None,
    context: Optional[Dict[str, Any]] = None,
    error: Optional[BaseException] = None,
    extra_docs: Optional[Dict[str, Any]] = None,
    diagnose: bool = True,
) -> Optional[str]:
    """Collect every run-matching signal into ``<dir>/bundle_<run_id>/``
    and return its path (None when disabled or on any internal failure —
    evidence capture must never compound the original fault)."""
    try:
        return _write_bundle(
            trigger, directory, run_id, context, error, extra_docs, diagnose
        )
    except Exception:
        log.exception("evidence bundle for trigger %r failed", trigger)
        return None


def _write_bundle(
    trigger: str,
    directory: Optional[str],
    run_id: Optional[str],
    context: Optional[Dict[str, Any]],
    error: Optional[BaseException],
    extra_docs: Optional[Dict[str, Any]],
    diagnose: bool,
) -> Optional[str]:
    if not Settings.DOCTOR_BUNDLE_ENABLED:
        return None
    from p2pfl_tpu_torch.telemetry import export
    from p2pfl_tpu_torch.telemetry import flight_recorder as flightrec_mod
    from p2pfl_tpu_torch.telemetry.ledger import LEDGER_SCHEMA_VERSION, LEDGERS

    rid = current_run_id() if run_id is None else str(run_id)
    parent = directory or str(Settings.DOCTOR_BUNDLE_DIR)
    out = bundle_dir(rid or "norun", parent)
    os.makedirs(out, exist_ok=True)

    # (name, kind, schema_version, deterministic) — canonical ledger dumps
    # are the only members whose bytes are a pure function of the run.
    members: List[Tuple[str, str, int, bool]] = []

    for path in LEDGERS.dump_all(out):
        members.append((os.path.basename(path), "ledger", LEDGER_SCHEMA_VERSION, True))

    for rec in flightrec_mod.live_recorders():
        p = rec.dump(trigger, directory=out)
        if p:
            members.append(
                (
                    os.path.basename(p),
                    "flightrec",
                    flightrec_mod.FLIGHTREC_SCHEMA_VERSION,
                    False,
                )
            )

    _write_json(
        os.path.join(out, "metrics.json"),
        {
            "header": artifact_header(kind="metrics", run_id=rid),
            "families": export.snapshot(),
        },
    )
    members.append(("metrics.json", "metrics", ARTIFACT_SCHEMA_VERSION, False))
    prom_path = os.path.join(out, "metrics.prom")
    prom_tmp = f"{prom_path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(prom_tmp, "w", encoding="utf-8") as f:
        f.write(export.render_prometheus())
    os.replace(prom_tmp, prom_path)
    members.append(("metrics.prom", "prometheus", ARTIFACT_SCHEMA_VERSION, False))

    for name, kind in _SIBLING_ARTIFACTS:
        src = os.path.join(parent, name)
        if not os.path.isfile(src):
            continue
        try:
            with open(src, "r", encoding="utf-8") as f:
                doc = json.load(f)
        except Exception:
            continue
        if _doc_matches_run(doc, rid):
            shutil.copyfile(src, os.path.join(out, name))
            members.append((name, kind, ARTIFACT_SCHEMA_VERSION, False))

    ctx_doc: Dict[str, Any] = {
        "header": artifact_header(kind="context", run_id=rid),
        "trigger": trigger,
        "context": dict(context or {}),
    }
    if error is not None:
        ctx_doc["error"] = {
            "type": type(error).__name__,
            "message": str(error),
            "traceback": traceback.format_exception(
                type(error), error, error.__traceback__
            ),
        }
    _write_json(os.path.join(out, "context.json"), ctx_doc)
    members.append(("context.json", "context", ARTIFACT_SCHEMA_VERSION, False))

    for name, doc in (extra_docs or {}).items():
        fname = f"{_safe(name)}.json"
        if isinstance(doc, dict) and "header" not in doc:
            doc = dict(doc)
            doc["header"] = artifact_header(kind=name, run_id=rid)
        _write_json(os.path.join(out, fname), doc)
        members.append((fname, name, ARTIFACT_SCHEMA_VERSION, False))

    det_members: List[Dict[str, Any]] = []
    excluded: Dict[str, Any] = {"written_at": round(time.time(), 6), "volatile_sha256": {}}
    for name, kind, ver, det in sorted(members):
        entry: Dict[str, Any] = {"name": name, "kind": kind, "schema_version": ver}
        sha = _sha256_file(os.path.join(out, name))
        if det:
            entry["sha256"] = sha
        else:
            excluded["volatile_sha256"][name] = sha
        det_members.append(entry)
    manifest = {
        "bundle": "evidence",
        "v": BUNDLE_SCHEMA_VERSION,
        "run_id": rid,
        "trigger": trigger,
        "members": det_members,
        "excluded": excluded,
    }
    _write_json(os.path.join(out, "manifest.json"), manifest)
    _BUNDLES.labels(trigger).inc()

    if diagnose:
        try:
            from p2pfl_tpu_torch.telemetry import diagnosis

            findings = diagnosis.diagnose(diagnosis.load_evidence(out))
            incident = diagnosis.incident_doc(findings, run_id=rid, source=out)
            _write_json(os.path.join(out, "incident.json"), incident)
            # Latest-incident pointer next to federation_snapshot.json —
            # what the fed_top DIAGNOSIS banner reads.
            _write_json(os.path.join(parent, "incident.json"), incident)
        except Exception:
            log.exception("diagnosis over bundle %s failed", out)
    return out


def load_manifest(path: str) -> Optional[Dict[str, Any]]:
    """Read a bundle's manifest (``path`` is the bundle dir or the
    manifest file itself); None when absent/unreadable."""
    if os.path.isdir(path):
        path = os.path.join(path, "manifest.json")
    try:
        with open(path, "r", encoding="utf-8") as f:
            return json.load(f)
    except Exception:
        return None


def comparable_manifest(manifest: Dict[str, Any]) -> Dict[str, Any]:
    """The replay-deterministic projection of a manifest: everything but
    the ``excluded`` section (wall timestamps + volatile member hashes)."""
    return {k: v for k, v in manifest.items() if k != "excluded"}


__all__ = [
    "ARTIFACT_SCHEMA_VERSION",
    "BUNDLE_SCHEMA_VERSION",
    "WIRE_ARG_PREFIX",
    "mint_run_id",
    "establish_run",
    "adopt_run_id",
    "current_run_id",
    "reset_run",
    "artifact_header",
    "bundle_dir",
    "write_bundle",
    "load_manifest",
    "comparable_manifest",
]
