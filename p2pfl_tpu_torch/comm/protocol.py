"""CommunicationProtocol: the transport-agnostic composition root (the
port's copy of ``p2pfl_tpu/comm/protocol.py``, on the port's chaos plane and
telemetry; the port has the in-memory transport only).

Parity with the reference's CommunicationProtocol ABC
(communication/protocols/communication_protocol.py:27-198) and the per-
transport composition roots (grpc_communication_protocol.py:50-263,
memory_communication_protocol.py:33-66). Design departure: the reference
duplicates the Neighbors+Client+Gossiper+Server+Heartbeater wiring in each
transport; here the base class owns the composition and transports supply
three factories (server, client-send, neighbors), so both transports share
one tested code path.
"""

from __future__ import annotations

import functools
import logging
import random
import threading
import time
from typing import Any, Callable, List, Optional

from p2pfl_tpu_torch.chaos import CHAOS
from p2pfl_tpu_torch.comm.commands.command import Command, CommandDispatcher
from p2pfl_tpu_torch.comm.envelope import Envelope
from p2pfl_tpu_torch.comm.gossiper import Gossiper
from p2pfl_tpu_torch.comm.heartbeater import HEARTBEAT_CMD, Heartbeater
from p2pfl_tpu_torch.comm.neighbors import Neighbors
from p2pfl_tpu_torch.config import Settings
from p2pfl_tpu_torch.exceptions import (
    CommunicationError,
    NeighborNotConnectedError,
    ProtocolNotStartedError,
)
from p2pfl_tpu_torch.telemetry import REGISTRY, TRACER
from p2pfl_tpu_torch.telemetry import bundle as bundle_mod
from p2pfl_tpu_torch.telemetry import digest as digest_mod
from p2pfl_tpu_torch.telemetry.flight_recorder import FlightRecorder
from p2pfl_tpu_torch.telemetry.observatory import Observatory

log = logging.getLogger("p2pfl_tpu_torch")

# Inbound wire accounting (the TX mirror lives in comm/gossiper.py).
_RX_BYTES = REGISTRY.counter(
    "p2pfl_gossip_rx_bytes_total",
    "Model-plane payload bytes received, by command",
    labels=("node", "cmd"),
)
_RX_FRAMES = REGISTRY.counter(
    "p2pfl_gossip_rx_frames_total",
    "Inbound envelopes dispatched (control + weights), by command",
    labels=("node", "cmd"),
)
_SEND_RETRIES = REGISTRY.counter(
    "p2pfl_send_retries_total",
    "Transport send attempts retried after a failure (bounded backoff)",
    labels=("node",),
)
_PEER_WRITTEN_OFF = REGISTRY.counter(
    "p2pfl_peer_written_off_total",
    "Neighbors removed after a send failed all its retry attempts",
    labels=("node",),
)
_HEALS = REGISTRY.counter(
    "p2pfl_recovery_heals_total",
    "Failure-departed peers observed coming back (heal/recover detections)",
    labels=("node",),
)
_DIGEST_BYTES = REGISTRY.counter(
    "p2pfl_digest_bytes_total",
    "Health-digest payload bytes emitted onto heartbeats (per beat) — the "
    "observability plane's wire cost, which must stay flat-to-logarithmic "
    "as the fleet grows (sketches, not per-peer scalars)",
    labels=("node",),
)


def jittered_backoff(src: str, dst: str, attempt: int) -> float:
    """Seeded-jitter retry backoff for gossip sends.

    Pure exponential backoff synchronizes retries: after a partition heals,
    every survivor that was mid-retry against the returned peer fires again
    in lockstep (same base, same attempt index), re-colliding forever. The
    fix is the classic decorrelation jitter — scale the exponential base by
    a uniform in [0.5, 1.5) — but drawn from a DEDICATED stream seeded by
    ``(CHAOS_SEED, src, dst, attempt)``, so replays stay deterministic and
    the chaos plane's per-pair decision streams are never consumed."""
    base = min(Settings.GOSSIP_SEND_BACKOFF * (2 ** max(0, int(attempt))), 2.0)
    if base <= 0.0:
        return 0.0
    u = random.Random(
        f"{Settings.CHAOS_SEED}|backoff|{src}->{dst}|{attempt}"
    ).random()
    return base * (0.5 + u)


def running(fn: Callable) -> Callable:
    """Guard decorator: raise unless the protocol has been started
    (reference grpc_communication_protocol.py:38-47)."""

    @functools.wraps(fn)
    def wrapper(self: "CommunicationProtocol", *args: Any, **kwargs: Any) -> Any:
        if not self._running:
            raise ProtocolNotStartedError(f"{fn.__name__} requires a started protocol")
        return fn(self, *args, **kwargs)

    return wrapper


class CommunicationProtocol:
    """Base protocol: membership + gossip + command dispatch.

    Subclasses implement :meth:`_build_neighbors`, :meth:`_server_start`,
    :meth:`_server_stop`, and :meth:`_transport_send`.
    """

    def __init__(self, addr: Optional[str] = None) -> None:
        self._addr = addr or self._default_addr()
        self._running = False
        self._lock = threading.Lock()
        self.dispatcher = CommandDispatcher()
        # Federation observatory + flight recorder (telemetry/): the
        # observatory assembles peers' heartbeat-piggybacked health digests
        # into a fleet view; the recorder keeps the postmortem event ring.
        self.flight_recorder = FlightRecorder(self._addr)
        # The observatory records membership transitions (join/rejoin/leave)
        # into the flight recorder — churn is postmortem-worthy.
        self.observatory = Observatory(self._addr, recorder=self.flight_recorder)
        # Digest source: returns this node's HealthDigest for the next beat.
        # The default sees only the registry; Node swaps in a state-aware
        # provider (round/stage); None disables emission entirely (the node
        # stays wire-compatible — its beats are simply digest-free).
        self._digest_provider: Optional[Callable[[], Optional[digest_mod.HealthDigest]]] = (
            lambda: digest_mod.collect(self._addr)
        )
        self.neighbors = self._build_neighbors(self._addr)
        self.gossiper = Gossiper(
            self._addr,
            send_fn=self._safe_send,
            get_direct_neighbors_fn=lambda: self.neighbors.get_all(only_direct=True),
            recorder=self.flight_recorder,
        )
        self.heartbeater = Heartbeater(
            self._addr,
            self.neighbors,
            self.broadcast,
            digest_fn=self._digest_wire,
            probe_fn=self._probe_departed,
        )
        # Dead peers leave the fleet view and the postmortem record together.
        self.neighbors.add_removal_listener(self._observe_peer_removed)
        # Healed peers re-enter it with fresh scoring state (a returned
        # partition survivor must not inherit its pre-partition z-scores).
        self.neighbors.add_recovery_listener(self._observe_peer_recovered)
        # auto-register the heartbeat handler (reference
        # grpc_communication_protocol.py:63-89)
        protocol = self

        class _BeatCommand(Command):
            @staticmethod
            def get_name() -> str:
                return HEARTBEAT_CMD

            def execute(self, source: str, round: int, *args: str, **kwargs: Any) -> None:
                ts = float(args[0]) if args else 0.0
                protocol.heartbeater.beat(source, ts)

        self.dispatcher.register([_BeatCommand()])

    # --- observatory / flight recorder --------------------------------------

    def set_digest_source(
        self, provider: Optional[Callable[[], Optional[digest_mod.HealthDigest]]]
    ) -> None:
        """Install the health-digest provider piggybacked on heartbeats
        (``None`` disables emission — the node keeps interoperating, its
        beats are just digest-free)."""
        self._digest_provider = provider

    def _digest_wire(self) -> Optional[str]:
        """Encoded digest for the next beat (None = skip). The self view
        rides the same ingest path as peers' digests, so the local fleet
        snapshot always includes this node."""
        provider = self._digest_provider
        if provider is None:
            return None
        dig = provider()
        if dig is None:
            return None
        self.observatory.ingest(dig)
        wire = dig.encode()
        _DIGEST_BYTES.labels(self._addr).inc(len(wire))
        return wire

    def _ingest_digest(self, env: Envelope) -> None:
        dig = digest_mod.decode(env.digest)
        if dig is None:
            log.debug("(%s) undecodable digest from %s ignored", self._addr, env.source)
            return
        if dig.node != env.source:
            # A digest must describe its sender; a mismatch is either a bug
            # or spoofed attribution — drop it (beats stay valid either way).
            log.debug(
                "(%s) digest node %s != envelope source %s — ignored",
                self._addr, dig.node, env.source,
            )
            return
        if self.observatory.ingest(dig):
            self.flight_recorder.record(
                "digest", peer=dig.node, round=dig.round, stage=dig.stage
            )

    def _observe_peer_removed(self, addr: str) -> None:
        self.observatory.forget(addr)
        self.flight_recorder.record("peer_lost", peer=addr)

    def _observe_peer_recovered(self, addr: str) -> None:
        """A failure-departed peer demonstrably returned: the heal event.
        The observatory resets its scoring state (stale pre-partition
        straggler/link stats must not outlive the partition) and the return
        is postmortem-worthy."""
        self.observatory.peer_recovered(addr)
        self.flight_recorder.record("peer_recovered", peer=addr)
        _HEALS.labels(self._addr).inc()

    def on_neighbor_recovered(self, fn: Callable[[str], None]) -> None:
        """Register a heal callback: fired (with the address) whenever a
        peer that was written off via a failure path comes back — the hook
        partition-heal reconciliation hangs off (node-level reconcile pings,
        stages re-evaluating quorum)."""
        self.neighbors.add_recovery_listener(fn)

    def _probe_departed(self) -> None:
        """Heal detection (runs on the heartbeater's sweep tick): attempt to
        re-reach peers that left the table via failure paths. Beats alone
        cannot re-discover a healed partition — the first blocked send
        already dropped the only link that would carry them — so the
        detector must actively knock.

        The probe is a handshake-connect: it respects chaos partitions and
        crashes via the STATE-ONLY :meth:`ChaosPlane.link_blocked` check
        (drawing from the per-pair decision streams here would make their
        replay depend on probe cadence), touches neither side's neighbor
        table unless the connect round-trips, and fires the recovery
        listeners only on success."""
        if not self._running or not Settings.RECOVERY_PROBE_ENABLED:
            return
        for addr in self.neighbors.departed(Settings.RECOVERY_PROBE_MAX):
            if not self._running:
                return
            if CHAOS.active and CHAOS.link_blocked(self._addr, addr):
                continue  # still partitioned/crashed: don't pierce it
            try:
                # connect_to performs the transport handshake; failure (peer
                # still down) leaves both tables untouched, success re-adds
                # the peer and _note_returned fires the recovery listeners.
                self.neighbors.add(addr, non_direct=False)
            except Exception:  # noqa: BLE001 — still dead; keep probing
                log.debug("(%s) heal probe to %s failed", self._addr, addr)

    def export_trace(self, path: str) -> str:
        """Write this PROCESS's span buffer as an annotated Chrome trace.

        On top of ``TRACER.export_chrome_trace()`` (which already carries
        the wall-clock epoch anchor), the dump's ``metadata`` records this
        node's address and its per-peer clock-skew snapshot from the
        heartbeater — everything
        :meth:`p2pfl_tpu_torch.telemetry.critical_path.CriticalPathAnalyzer.
        from_chrome_traces` needs to merge dumps from separate gRPC
        processes onto one skew-corrected timeline. Atomic write (tmp +
        rename) so a crash mid-dump never leaves a torn trace.
        """
        import json
        import os

        doc = TRACER.export_chrome_trace()
        meta = doc.setdefault("metadata", {})
        meta["node"] = self._addr
        meta["peer_clock_skew_s"] = self.heartbeater.clock_skews()
        directory = os.path.dirname(path)
        if directory:
            os.makedirs(directory, exist_ok=True)
        # pid alone collides when two node threads write the same doc path
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path

    # --- transport hooks ----------------------------------------------------

    def _default_addr(self) -> str:
        raise NotImplementedError

    def _build_neighbors(self, addr: str) -> Neighbors:
        raise NotImplementedError

    def _server_start(self) -> None:
        raise NotImplementedError

    def _server_stop(self) -> None:
        raise NotImplementedError

    def _transport_send(self, nei: str, env: Envelope) -> None:
        """Deliver one envelope to a connected neighbor (may raise)."""
        raise NotImplementedError

    # --- lifecycle (reference communication_protocol.py:56-77) --------------

    @property
    def addr(self) -> str:
        return self._addr

    def get_address(self) -> str:
        return self._addr

    def start(self) -> None:
        if self._running:
            return
        self._server_start()
        # _running must be set before the heartbeater launches: its thread
        # broadcasts immediately and would hit the @running guard, delaying
        # first-beat membership discovery by a full HEARTBEAT_PERIOD.
        self._running = True
        self.heartbeater.start()
        self.gossiper.start()

    def stop(self) -> None:
        if not self._running:
            return
        self._running = False
        self.heartbeater.stop()
        self.gossiper.stop()
        self.neighbors.clear()
        self._server_stop()

    def crash(self) -> None:
        """Abrupt-death simulation: tear everything down WITHOUT disconnect
        notifications, as a killed process would. Peers must discover the
        death through heartbeat timeouts / send failures — which is exactly
        what chaos tests exercise."""
        if not self._running:
            return
        self._running = False
        # Postmortem FIRST, while the ring still holds the final moments —
        # the teardown below emits nothing worth recording.
        self.flight_recorder.record("crash")
        self.flight_recorder.dump("crash")
        self.heartbeater.stop()
        self.gossiper.stop()
        self.neighbors.clear(notify=False)
        self._server_stop()

    # --- membership ---------------------------------------------------------

    @running
    def connect(self, addr: str, non_direct: bool = False) -> bool:
        try:
            return self.neighbors.add(addr, non_direct=non_direct)
        except Exception as exc:
            raise CommunicationError(f"could not connect to {addr}: {exc}") from exc

    @running
    def disconnect(self, addr: str, notify: bool = True) -> None:
        # Explicit local disconnect: graceful, never a failure departure.
        self.neighbors.remove(addr, notify=notify, departed=False)

    @running
    def get_neighbors(self, only_direct: bool = False) -> List[str]:
        return self.neighbors.get_all(only_direct=only_direct)

    def on_neighbor_removed(self, fn: Callable[[str], None]) -> None:
        """Register a death callback: fired (with the address) whenever a
        neighbor leaves the table — heartbeat-timeout sweeps, send-failure
        write-offs and explicit disconnects all converge here, so round
        machinery (vote expectations, aggregation finish conditions) can
        shrink immediately instead of sleeping out its fixed timeout."""
        self.neighbors.add_removal_listener(fn)

    # --- messaging (reference communication_protocol.py:95-160) -------------

    def build_msg(self, cmd: str, args: Optional[List[str]] = None, round: int = 0) -> Envelope:
        return Envelope.message(self._addr, cmd, args=args, round=round)

    def build_weights(
        self,
        cmd: str,
        round: int,
        serialized_model: bytes,
        contributors: Optional[List[str]] = None,
        num_samples: int = 1,
        codec: str = "dense",
    ) -> Envelope:
        return Envelope.weights(
            self._addr, cmd, round, serialized_model, list(contributors or []),
            num_samples, codec=codec,
        )

    @running
    def send(
        self,
        nei: str,
        env: Envelope,
        create_connection: bool = False,
        raise_error: bool = True,
        remove_on_error: bool = True,
        retries: int = 0,
    ) -> None:
        """Unicast with the reference's failure semantics
        (grpc_client.py:124-192), hardened two ways:

        * **chaos intercept** — when the fault plane is active, each attempt
          consults :data:`~p2pfl_tpu_torch.chaos.CHAOS` first: injected drops
          return silently (the sender believes it delivered), delays stall
          this thread, duplicates double-deliver, and blocked links
          (partition / crash) raise into the normal failure path below.
        * **bounded retry** — a failed attempt is retried up to ``retries``
          times with exponential backoff before the neighbor is written off
          and removed (firing the death callbacks registered via
          :meth:`on_neighbor_removed`). The gossip path passes
          ``Settings.GOSSIP_SEND_RETRIES``; heartbeats stay at 0 (they ARE
          the retry loop).
        """
        if not self.neighbors.exists(nei):
            if create_connection:
                self.neighbors.add(nei, non_direct=False)
            elif raise_error:
                raise NeighborNotConnectedError(f"{nei} is not a neighbor")
            else:
                return
        attempts = 1 + max(0, int(retries))
        if CHAOS.active and env.is_weights:
            # Byzantine peer behavior (chaos plane): a node marked adversarial
            # poisons every model-plane frame it sends — corrupted ONCE per
            # send call, before the retry loop, so retries re-ship the same
            # (corrupted) frame like a real adversary would.
            env = CHAOS.corrupt_weights(self._addr, env)
        for attempt in range(attempts):
            try:
                if CHAOS.active:
                    decision = CHAOS.intercept(self._addr, nei)
                    if decision.blocked:
                        self.flight_recorder.record(
                            "fault", fault=decision.blocked, peer=nei, cmd=env.cmd
                        )
                        raise CommunicationError(
                            f"chaos: link {self._addr} -> {nei} blocked "
                            f"({decision.blocked})"
                        )
                    if decision.drop:
                        self.flight_recorder.record(
                            "fault", fault="drop", peer=nei, cmd=env.cmd
                        )
                        return  # injected loss: the sender never learns
                    if decision.delay_s > 0.0:
                        time.sleep(decision.delay_s)
                    for _ in range(decision.duplicates):
                        self._transport_send(nei, env)
                self._transport_send(nei, env)
                return
            except (TypeError, AttributeError):
                # Local programming error (e.g. bad payload type), not a peer
                # failure: keep the neighbor and surface it loudly instead of
                # masking it as a CommunicationError. Never retried.
                # (ValueError stays on the transport path: grpc raises it for
                # closed-channel races.)
                log.exception("send to %s failed with a local error", nei)
                if raise_error:
                    raise
                return
            except Exception as exc:
                if attempt + 1 < attempts:
                    _SEND_RETRIES.labels(self._addr).inc()
                    time.sleep(jittered_backoff(self._addr, nei, attempt))
                    continue
                if remove_on_error:
                    _PEER_WRITTEN_OFF.labels(self._addr).inc()
                    self.flight_recorder.record(
                        "peer_written_off", peer=nei, cmd=env.cmd, error=str(exc)[:200]
                    )
                    if attempts > 1:
                        log.warning(
                            "(%s) writing off %s after %d failed send attempts: %s",
                            self._addr, nei, attempts, exc,
                        )
                    self.neighbors.remove(nei, notify=False)
                if raise_error:
                    raise CommunicationError(f"send to {nei} failed: {exc}") from exc
                return

    def _safe_send(self, nei: str, env: Envelope) -> None:
        if not self._running:
            return
        self.send(
            nei,
            env,
            raise_error=False,
            remove_on_error=True,
            retries=Settings.GOSSIP_SEND_RETRIES,
        )

    @running
    def broadcast(self, env: Envelope, node_list: Optional[List[str]] = None) -> None:
        """Send to every direct neighbor (reference grpc_client.py:194-208)."""
        for nei in node_list if node_list is not None else self.neighbors.get_all(only_direct=True):
            self.send(nei, env, raise_error=False, remove_on_error=True)
            if env.payload is not None:
                # Model-plane accounting for broadcast weights (async window
                # contributions): the sync model gossip counts at its own
                # send point in gossip_weights — this is the only other
                # weights choke point, so bytes_for_round and the per-codec
                # TX attribution cover both schedulers.
                self.gossiper._record_tx(env, nei)

    # --- command wiring -----------------------------------------------------

    def add_command(self, cmds: Command | List[Command]) -> None:
        self.dispatcher.register(cmds if isinstance(cmds, list) else [cmds])

    # --- inbound (called by transport servers) ------------------------------

    def _dispatch_contained(self, env: Envelope, **kwargs: Any) -> None:
        """Dispatch with APPLICATION errors contained at the receiving node.

        An unknown command (version-skewed peer) or a handler exception must
        never surface as a transport failure: the gRPC server would return
        an error Ack, the SENDER's broadcast path would treat that as a dead
        link and remove the neighbor — one stray command dismantling
        connectivity. Transport-level problems (undecodable frames) still
        propagate from the server adapters.
        """
        args = () if env.is_weights else tuple(env.args)  # weights ride kwargs only
        try:
            self.dispatcher.dispatch(env.cmd, env.source, env.round, *args, **kwargs)
        except Exception:  # noqa: BLE001 — any app error is the receiver's own
            log.exception(
                "(%s) contained error dispatching %r from %s",
                self._addr, env.cmd, env.source,
            )

    def handle_envelope(self, env: Envelope) -> None:
        """Inbound dispatch with dedup + TTL re-gossip
        (reference grpc_server.py:161-212).

        Traced frames (``env.trace`` set) dispatch inside a receiver span
        parented onto the SENDER's span, so cross-node latency — model
        diffusion, vote RTT — is attributable in the exported trace.
        """
        _RX_FRAMES.labels(self._addr, env.cmd).inc()
        if env.is_weights:
            _RX_BYTES.labels(self._addr, env.cmd).inc(len(env.payload))
            self.flight_recorder.record(
                "recv", cmd=env.cmd, peer=env.source,
                round=env.round, bytes=len(env.payload),
            )
            with TRACER.recv_span(
                f"recv:{env.cmd}", self._addr, env.trace,
                source=env.source, round=env.round, bytes=len(env.payload),
            ):
                self._dispatch_contained(
                    env,
                    weights=env.payload,
                    contributors=env.contributors,
                    num_samples=env.num_samples,
                )
            return
        if not self.gossiper.check_and_set_processed(env.msg_id):
            return
        # Run-id adoption (AFTER dedup, like digests): first-wins for
        # ordinary frames — a stale peer's heartbeat must not flip an
        # established context — but a start_learning kickoff forces it, so
        # every node converges on the initiator's experiment id before any
        # model traffic flows.
        if env.run_id:
            bundle_mod.adopt_run_id(env.run_id, force=env.cmd == "start_learning")
        # Piggybacked health digest (normally on beats): feed the fleet view
        # AFTER dedup so re-gossiped copies don't re-ingest. Absent digests
        # (older / opted-out peers) skip this entirely — wire compatibility.
        if env.digest:
            self._ingest_digest(env)
        with TRACER.recv_span(
            f"recv:{env.cmd}", self._addr, env.trace,
            source=env.source, round=env.round,
        ):
            self._dispatch_contained(env)
        if env.ttl > 1:
            fwd = Envelope(
                source=env.source,
                cmd=env.cmd,
                round=env.round,
                args=env.args,
                ttl=env.ttl - 1,
                msg_id=env.msg_id,
                trace=env.trace,  # re-gossip stays in the sender's trace
                digest=env.digest,  # digests reach non-direct peers this way
                run_id=env.run_id,  # run id diffuses past direct neighbors
            )
            self.gossiper.add_message(fwd)

    # --- model gossip (reference communication_protocol.py:162-198) ---------

    @running
    def gossip_weights(
        self,
        early_stopping_fn: Callable[[], bool],
        get_candidates_fn: Callable[[], List[str]],
        status_fn: Callable[[], Any],
        model_fn: Callable[[str], Optional[Envelope]],
        period: Optional[float] = None,
        create_connection: bool = False,
    ) -> None:
        self.gossiper.gossip_weights(
            early_stopping_fn, get_candidates_fn, status_fn, model_fn, period
        )
