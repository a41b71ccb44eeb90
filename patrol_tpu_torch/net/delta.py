"""Delta-interval replication data plane (wire protocol v2).

The v1 data plane ships ONE full bucket state per ≤256-B datagram per
take (repo.go:123-158) — the scaling wall for 256+ peers and
million-bucket churn, and a drip-feed of tiny rx batches into the
device-commit pipeline. This module replaces it, in the delta-state CRDT
shape of Almeida et al. (arXiv:1410.2803):

* the engine's broadcast emission no longer maps 1:1 to datagrams —
  :meth:`DeltaPlane.offer` accumulates each emitted state's
  join-decomposition (absolute PN-lane values, keyed by (bucket, lane))
  into a dirty buffer, newest value winning;
* a paced flusher packs the dirty set into **delta-interval datagrams**
  (hundreds of bucket deltas per packet, ops/wire.py framing), one
  interval sequence per packet per peer;
* receivers decode an interval straight into the batched slot/flag
  planes the device-commit pipeline consumes (engine.ingest_interval →
  ops/delta.delta_fold: ONE scatter-max dispatch per datagram) and
  acknowledge interval seqs via **ack vectors piggybacked** on their own
  delta traffic (or bare-ack datagrams when they have none);
* unacked intervals **retransmit** after a timeout — with the CURRENT
  values (absolute monotone state subsumes every older interval, so no
  history is kept) — and acked intervals are **garbage-collected**. The
  timeout adapts per peer: every interval seq is sent once, so each ack
  is an unambiguous round-trip sample (in flush ticks), smoothed as in
  TCP (RFC 6298: ``srtt + max(1, 4·rttvar)``, never under the configured
  ``retransmit_ticks``), and each retransmit round doubles it until the
  next sample. A fixed timeout shorter than the peer's ack latency
  resends every interval before its ack lands, and the resends keep the
  receiver behind: a storm that does not end by itself;
* when a peer stops acking (interval log overflow) or heals from a
  partition, the plane falls back to **full-state repair**: the pending
  interval log is dropped, the peer's capability is re-negotiated, and
  heal-time anti-entropy (net/antientropy.py digest+fetch) re-ships only
  the divergent buckets. A bucket already being re-shipped by an
  in-flight anti-entropy job is deduped out of delta retransmits toward
  that peer.

Capability is discovered on the existing reserved-name control channel:
a ``dv2?`` advert (carrying the sender's receive bound — the native
recvmmsg backend can only take 256-B datagrams, the asyncio backend
takes ``DELTA_PACKET_SIZE``) is answered by a ``dv2!`` ack. Peers that
never answer (v1 reference nodes, pre-delta builds, ``--wire-mode
compat``/``aggregate`` nodes that choose not to) keep receiving the
classic per-state packets — the compat interop path and the
partition-heal fallback. Receiving deltas needs no mode flag: any build
with this module accepts them regardless of its own tx mode.

Thread model: ``offer`` runs on engine/completer threads, ``on_packet``
on the rx thread, the flusher on its own daemon thread; one lock guards
the dirty buffer and per-peer interval state. All sends go through the
owning replicator's thread-safe ``unicast``.
"""

from __future__ import annotations

import math
import os
import struct
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from patrol_tpu_torch.ops import wire
from patrol_tpu_torch.utils import histogram as hist
from patrol_tpu_torch.utils import profiling
from patrol_tpu_torch.utils import trace as trace_mod
from patrol_tpu_torch.utils import config
from patrol_tpu_torch.net.replication import CTRL_PREFIX

Addr = Tuple[str, int]

# Capability handshake, on the control channel (zero-state packets whose
# name carries the payload — invisible to v1 peers like every other
# CTRL_PREFIX exchange). Payload: u32 receive bound in bytes.
DELTA_ADVERT_NAME = CTRL_PREFIX + "dv2?"
DELTA_ADVERT_ACK_NAME = CTRL_PREFIX + "dv2!"
_ADVERT_PAYLOAD = struct.Struct(">I")

# The conservative rx bound assumed for a peer that SENT us deltas but
# whose advert we have not (yet) seen: every backend can receive at least
# the v1 packet size.
MIN_DELTA_MTU = wire.PACKET_SIZE

# Device-resident ingest (ops/ingest.py; ROADMAP item 1): when the
# engine supports it, rx delta datagrams ship as RAW BYTE PLANES into
# one decode+fold dispatch (engine.ingest_raw_planes) instead of the
# per-datagram python decode + delta_fold two-step. The plane keeps the
# header/ack bookkeeping host-side (a vectorized structure walk shared
# with the engine's directory pass); entries never touch python. 0
# restores the python decode path everywhere.
RAW_INGEST = os.environ.get("PATROL_RAW_INGEST", "1") != "0"

# Ceiling of the adaptive retransmit timeout, in flush ticks (10 s at the
# default 20 ms pacing).
MAX_RETRANSMIT_TICKS = 500


def _encode_ctrl(name_payload: bytes) -> bytes:
    name = name_payload.decode("utf-8", "surrogateescape")
    return wire.encode(wire.WireState(name=name, added=0.0, taken=0.0, elapsed_ns=0))


class _PeerDelta:
    """Per-peer delta state: tx interval log + rx ack bookkeeping."""

    __slots__ = (
        "capable", "max_rx", "next_seq", "unacked", "pending_acks",
        "last_advert_tick", "last_rx_data_ns", "srtt", "rttvar", "backoff",
    )

    def __init__(self) -> None:
        self.capable = False
        self.max_rx = MIN_DELTA_MTU
        self.next_seq = 1
        # seq -> (flush tick at emission, emission perf_counter_ns,
        #         tuple[wire.DeltaEntry]) — the wall stamp is the
        # patrol-audit replication-lag source (net/audit.py): the oldest
        # unacked interval's age IS this peer's outstanding-repair lag.
        self.unacked: "OrderedDict[int, Tuple[int, int, tuple]]" = OrderedDict()
        # interval seqs received from this peer, to ack back (newest kept)
        self.pending_acks: deque = deque(maxlen=64)
        self.last_advert_tick = -(1 << 30)
        # perf_counter_ns of the last DATA-bearing delta interval received
        # from this peer (0 = never) — the audit plane's per-peer
        # time-since-last-absorb gauge.
        self.last_rx_data_ns = 0
        # Ack round trip in flush ticks (None until the first sample) and
        # the retransmit backoff exponent since the last sample.
        self.srtt: Optional[float] = None
        self.rttvar = 0.0
        self.backoff = 0


class DeltaPlane:
    """One per replicator (either backend). The replicator feeds
    :meth:`offer` from ``broadcast_states``, routes ``dv2`` datagrams to
    :meth:`on_packet`, and dispatches the handshake through
    :meth:`handle_control`; pacing lives on the plane's own thread."""

    def __init__(
        self,
        rep,
        tx_mtu: int = wire.DELTA_PACKET_SIZE,
        rx_mtu: int = wire.DELTA_PACKET_SIZE,
        flush_interval_s: Optional[float] = None,
        retransmit_ticks: Optional[int] = None,
        max_unacked_intervals: int = 64,
        max_dirty: int = 1 << 16,
        advert_ticks: int = 50,
    ):
        self.rep = rep  # Replicator / NativeReplicator (unicast, slots, ...)
        self.node_slot = rep.slots.self_slot
        self.tx_mtu = min(tx_mtu, wire.DELTA_PACKET_SIZE)
        self.rx_mtu = min(rx_mtu, wire.DELTA_PACKET_SIZE)
        self.flush_interval_s = (
            config.env_float("PATROL_DELTA_FLUSH_MS") / 1000.0
            if flush_interval_s is None
            else flush_interval_s
        )
        self.retransmit_ticks = (
            max(1, int(config.env_float("PATROL_DELTA_RETX_TICKS")))
            if retransmit_ticks is None
            else retransmit_ticks
        )
        # The adaptive timeout's ceiling; ``retransmit_ticks`` is its
        # floor, and a ceiling under the floor holds the timeout fixed.
        self.max_retransmit_ticks = MAX_RETRANSMIT_TICKS
        self.max_unacked_intervals = max_unacked_intervals
        self.max_dirty = max_dirty
        self.advert_ticks = advert_ticks
        self._mu = threading.Lock()
        # (name, slot) -> wire.DeltaEntry: the join of the states offered
        # since the last flush (lanes are monotone).
        self._dirty: Dict[Tuple[str, int], wire.DeltaEntry] = {}
        self._peers: Dict[Addr, _PeerDelta] = {}
        # Raw-ingest plane pool (asyncio backend / P=1 packets): reusable
        # [1, DELTA_PACKET_SIZE] byte planes filled per datagram and
        # recycled once the engine's H2D transfer is ready — the same
        # planes-per-batch shape the native rx ring feeds, slower but
        # path-identical. Free list under its own leaf lock (the release
        # callback runs on the engine completer thread).
        self._raw_mu = threading.Lock()
        self._raw_free: List["object"] = []
        self._tick = 0
        self._thread: Optional[threading.Thread] = None
        self._stopped = threading.Event()
        # Counters (read by stats()).
        self.deltas_batched = 0
        self.data_packets_tx = 0
        self.ack_packets_tx = 0
        self.interval_retransmits = 0
        self.fullstate_fallbacks = 0
        self.ae_deduped = 0
        self.rx_packets = 0
        self.rx_deltas = 0
        self.rx_errors = 0
        self.adverts_tx = 0

    # -- lifecycle -----------------------------------------------------------

    @property
    def tx_enabled(self) -> bool:
        """Delta SHIPPING is opt-in (--wire-mode delta); receiving is not."""
        return getattr(self.rep, "wire_mode", None) == "delta"

    def start(self) -> None:
        """Spawn the flusher (idempotent). Called by the owning replicator
        in delta mode, and lazily on first delta rx in any mode — a
        receiver must keep acking even when it ships nothing itself."""
        if self.flush_interval_s <= 0 or self._thread is not None:
            return
        with self._mu:
            if self._thread is not None or self._stopped.is_set():
                return
            self._thread = threading.Thread(
                target=self._run, name="patrol-delta-flush", daemon=True
            )
            self._thread.start()

    def _run(self) -> None:
        while True:
            interval = self.flush_interval_s
            if interval <= 0 or self._stopped.wait(interval):
                return
            try:
                self.flush()
            except Exception:  # pragma: no cover - flusher must not die
                if getattr(self.rep, "log", None):
                    self.rep.log.exception("delta flush failed")

    def close(self) -> None:
        self._stopped.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2)

    # -- capability handshake (control channel) ------------------------------

    def _peer(self, addr: Addr) -> _PeerDelta:
        """Get-or-create the per-peer state. Caller holds ``_mu`` (a
        declared HOLDER contract in analysis/race.py::HOLDERS)."""
        st = self._peers.get(addr)
        if st is None:
            st = self._peers[addr] = _PeerDelta()
        return st

    def mark_capable(self, addr: Addr, max_rx: int) -> None:
        with self._mu:
            st = self._peer(addr)
            st.capable = True
            st.max_rx = max(MIN_DELTA_MTU, min(int(max_rx), wire.DELTA_PACKET_SIZE))

    def capable_peers(self) -> List[Addr]:
        with self._mu:
            return [a for a, st in self._peers.items() if st.capable]

    def _advert_bytes(self, ack: bool) -> bytes:
        name = DELTA_ADVERT_ACK_NAME if ack else DELTA_ADVERT_NAME
        return _encode_ctrl(name.encode() + _ADVERT_PAYLOAD.pack(self.rx_mtu))

    def handle_control(self, name: str, addr: Addr) -> bool:
        """Dispatch a control-channel packet; True iff it was a delta
        capability advert/ack. Adverts are answered regardless of our own
        wire mode — rx capability is a property of the build."""
        for ctrl, is_ack in (
            (DELTA_ADVERT_NAME, False),
            (DELTA_ADVERT_ACK_NAME, True),
        ):
            if not name.startswith(ctrl):
                continue
            raw = name.encode("utf-8", "surrogateescape")[len(ctrl.encode()):]
            if len(raw) < _ADVERT_PAYLOAD.size:
                return True  # malformed advert: ours, but ignored
            (max_rx,) = _ADVERT_PAYLOAD.unpack_from(raw)
            self.mark_capable(addr, max_rx)
            if not is_ack and self.rep.reply_gate.allow(DELTA_ADVERT_ACK_NAME, addr):
                self.rep.unicast(self._advert_bytes(ack=True), addr)
            return True
        return False

    def on_peer_heal(self, addr: Addr) -> None:
        """A peer transitioned quiet→alive: drop its pending interval log
        (anti-entropy — triggered by the same heal — re-ships whatever
        diverged) and re-negotiate capability, in case the peer restarted
        as a build or mode that no longer speaks v2."""
        with self._mu:
            st = self._peers.get(addr)
            if st is None:
                return
            if st.unacked:
                st.unacked.clear()
                self.fullstate_fallbacks += 1
                profiling.COUNTERS.inc("wire_fullstate_fallbacks")
            st.capable = False
            st.last_advert_tick = -(1 << 30)

    def on_peer_leave(self, addr: Addr) -> None:
        """Elastic membership: a peer left the cluster — drop its per-peer
        delta bookkeeping entirely (unacked interval log, capability, seq
        state). A rejoin under a new address negotiates from scratch; the
        departed lane's shipped values are already join-absorbed."""
        with self._mu:
            self._peers.pop(addr, None)

    # -- tx: accumulate + flush ---------------------------------------------

    @staticmethod
    def eligible(st: wire.WireState) -> bool:
        """A state is delta-able when it carries the exact lane payload
        (origin slot, cap base, lane values) — everything else (scalar
        fallbacks, trailer-less oversized names) keeps the classic path."""
        return (
            st.origin_slot is not None
            and st.cap_nt is not None
            and st.lane_added_nt is not None
            and st.lane_taken_nt is not None
            and len(st.name.encode("utf-8", "surrogateescape")) <= 255
        )

    def offer(
        self, states: Sequence[wire.WireState]
    ) -> Tuple[List[Addr], List[wire.WireState]]:
        """Accumulate the delta-able states' join-decompositions for every
        capable peer. Returns (classic_addrs, classic_states): the peers
        that must receive the full classic broadcast of ALL states, and
        the non-delta-able leftover states that must also go classically
        to the capable peers."""
        with self._mu:
            classic_addrs = [
                a for a in self.rep.peers if not self._peers.get(a, _NOT_CAPABLE).capable
            ]
            any_capable = len(classic_addrs) < len(self.rep.peers)
            leftover: List[wire.WireState] = []
            if not any_capable:
                return classic_addrs, []
            for st in states:
                if not self.eligible(st):
                    leftover.append(st)
                    continue
                key = (st.name, st.origin_slot)
                prev = self._dirty.get(key)
                added, taken = st.lane_added_nt, st.lane_taken_nt
                elapsed, cap = max(st.elapsed_ns, 0), st.cap_nt
                if prev is not None:
                    # Lanes are monotone: keep the join of every state
                    # offered since the last flush. Emitters may offer out
                    # of order (a host-lane take and the native front's
                    # drain each emit after releasing the lanes' lock), and
                    # an older state must not replace a newer one.
                    added, taken = max(added, prev.added_nt), max(taken, prev.taken_nt)
                    elapsed, cap = max(elapsed, prev.elapsed_ns), max(cap, prev.cap_nt)
                self._dirty[key] = wire.DeltaEntry(
                    name=st.name,
                    slot=st.origin_slot,
                    cap_nt=cap,
                    added_nt=added,
                    taken_nt=taken,
                    elapsed_ns=elapsed,
                )
            overflow = len(self._dirty) >= self.max_dirty
        if overflow:
            self.flush()  # inline backpressure: never grow without bound
        return classic_addrs, leftover

    def flush(self) -> int:
        """One pacing tick: advertise to silent peers, retransmit expired
        intervals, pack + send the dirty set to every capable peer, drain
        pending ack vectors. Returns data packets sent."""
        t0 = time.perf_counter_ns()
        sends: List[Tuple[bytes, Addr]] = []
        data_packets = 0
        with self._mu:
            self._tick += 1
            tick = self._tick
            dirty = self._dirty
            self._dirty = {}
            peers = list(self.rep.peers)
            ae = getattr(self.rep, "antientropy", None)
            for addr in peers:
                st = self._peer(addr)
                if not st.capable:
                    if (
                        self.tx_enabled
                        and tick - st.last_advert_tick >= self.advert_ticks
                    ):
                        st.last_advert_tick = tick
                        self.adverts_tx += 1
                        sends.append((self._advert_bytes(ack=False), addr))
                    continue
                data_packets += self._flush_peer_locked(
                    addr, st, dirty, tick, ae, sends
                )
        for data, addr in sends:
            self.rep.unicast(data, addr)
        tr = trace_mod.TRACE
        if tr.enabled and sends:
            tr.record(
                trace_mod.EV_DELTA_PACK, time.perf_counter_ns() - t0, len(sends)
            )
        return data_packets

    def _timeout_locked(self, st: _PeerDelta) -> int:
        """Ticks an interval toward this peer waits for its ack. Caller
        holds _mu."""
        floor = self.retransmit_ticks
        # RFC 6298 §2.3 with a clock granularity of one tick: a sample is
        # read between two flushes, so an ack may land up to a tick later.
        rto = floor if st.srtt is None else st.srtt + max(1.0, 4.0 * st.rttvar)
        rto *= 1 << st.backoff
        return min(max(math.ceil(rto), floor), max(floor, self.max_retransmit_ticks))

    def _on_ack_locked(self, st: _PeerDelta, seq: int) -> None:
        """GC an acked interval and take its round trip as a sample
        (RFC 6298 §2 gains). Caller holds _mu."""
        rec = st.unacked.pop(seq, None)
        if rec is None:
            return
        r = float(self._tick - rec[0])
        if st.srtt is None:
            st.srtt, st.rttvar = r, r / 2.0
        else:
            st.rttvar = 0.75 * st.rttvar + 0.25 * abs(st.srtt - r)
            st.srtt = 0.875 * st.srtt + 0.125 * r
        st.backoff = 0

    def _flush_peer_locked(
        self,
        addr: Addr,
        st: _PeerDelta,
        dirty: Dict[Tuple[str, int], wire.DeltaEntry],
        tick: int,
        ae,
        sends: List[Tuple[bytes, Addr]],
    ) -> int:
        """Build this peer's datagrams for one tick. Caller holds _mu."""
        send_map: Dict[Tuple[str, int], wire.DeltaEntry] = {}
        ae_names = (
            ae.inflight_buckets(addr) if ae is not None and st.unacked else ()
        )
        retransmitted = 0
        now_ns = time.perf_counter_ns()
        timeout = self._timeout_locked(st)
        for seq in [
            s for s, (t, _, _) in st.unacked.items()
            if tick - t >= timeout
        ]:
            _, _, ents = st.unacked.pop(seq)
            live = False
            deferred = []
            for e in ents:
                key = (e.name, e.slot)
                if key in dirty:
                    continue  # the dirty value below subsumes this one
                if e.name in ae_names:
                    # An in-flight anti-entropy job toward this peer is
                    # already re-shipping this bucket's full lane state;
                    # a concurrent delta retransmit would be a duplicate.
                    # Defer the entry to a fresh interval next tick.
                    self.ae_deduped += 1
                    deferred.append(e)
                    continue
                send_map.setdefault(key, e)
                live = True
            if deferred:
                st.unacked[st.next_seq] = (tick, now_ns, tuple(deferred))
                st.next_seq += 1
            if live:
                retransmitted += 1
        if retransmitted:
            st.backoff = min(st.backoff + 1, 6)
            self.interval_retransmits += retransmitted
            profiling.COUNTERS.inc("wire_interval_retransmits", retransmitted)
            tr = trace_mod.TRACE
            if tr.enabled:
                tr.record(trace_mod.EV_DELTA_RETRANSMIT, 0, retransmitted)
        send_map.update(dirty)
        entries = list(send_map.values())
        acks = [st.pending_acks.popleft() for _ in range(len(st.pending_acks))]
        packets = 0
        max_size = min(self.tx_mtu, st.max_rx)
        while entries:
            seq = st.next_seq
            data, n = wire.encode_delta_packet(
                self.node_slot, seq, acks[: wire.DELTA_MAX_ACKS], entries,
                max_size,
            )
            if n == 0:  # cannot happen for legal names; guard anyway
                break
            acks = acks[wire.DELTA_MAX_ACKS:]
            st.next_seq += 1
            st.unacked[seq] = (tick, now_ns, tuple(entries[:n]))
            entries = entries[n:]
            sends.append((data, addr))
            packets += 1
            self.deltas_batched += n
            profiling.COUNTERS.inc("wire_deltas_batched", n)
        while acks:
            data, _ = wire.encode_delta_packet(
                self.node_slot, 0, acks[: wire.DELTA_MAX_ACKS], (), max_size
            )
            acks = acks[wire.DELTA_MAX_ACKS:]
            sends.append((data, addr))
            self.ack_packets_tx += 1
            tr = trace_mod.TRACE
            if tr.enabled:
                tr.record(trace_mod.EV_DELTA_ACK, 0, 1)
        if len(st.unacked) > self.max_unacked_intervals:
            # The peer stopped acking: the interval log is no longer a
            # faithful repair set. Drop it, fall back to full-state repair
            # via anti-entropy, and re-negotiate capability.
            st.unacked.clear()
            st.capable = False
            st.last_advert_tick = -(1 << 30)
            self.fullstate_fallbacks += 1
            profiling.COUNTERS.inc("wire_fullstate_fallbacks")
            if ae is not None:
                ae.trigger(addr, force=True)
        self.data_packets_tx += packets
        return packets

    # -- rx ------------------------------------------------------------------

    def raw_engine(self):
        """The engine the raw-plane path dispatches to, or None: feature
        off, no repo wired yet, or an engine that opts out (MeshEngine's
        sharded planes). Callers fall back to the python decode path."""
        if not RAW_INGEST:
            return None
        repo = getattr(self.rep, "repo", None)
        eng = getattr(repo, "engine", None)
        if eng is None or not getattr(eng, "_raw_ingest_capable", False):
            return None
        return eng

    def _lease_raw_plane(self):
        with self._raw_mu:
            if self._raw_free:
                profiling.COUNTERS.inc("rx_ring_lease_reuse")
                return self._raw_free.pop()
        return np.zeros((1, wire.DELTA_PACKET_SIZE), np.uint8)

    def _release_raw_plane(self, plane) -> None:
        with self._raw_mu:
            if len(self._raw_free) < 8:
                self._raw_free.append(plane)

    def _on_packet_raw(self, eng, data: bytes, addr: Addr) -> bool:
        """P=1 raw-plane ingest: the asyncio backend's half of the
        device-resident path. Fills a pooled plane row (stale tail bytes
        are masked by the walk/kernel length bounds — verified across the
        hostile corpus) and runs the shared walk + dispatch."""
        from patrol_tpu_torch.ops import ingest as ingest_ops

        t0 = time.perf_counter_ns()
        plane = self._lease_raw_plane()
        n = len(data)
        plane[0, :n] = np.frombuffer(data, np.uint8)
        lengths = np.array([n], np.int32)
        walk = ingest_ops.host_walk(plane, lengths)
        self._ingest_walk(
            eng, plane, lengths, walk, [addr],
            lambda: self._release_raw_plane(plane), t0,
        )
        return bool(walk.ok[0])

    def on_raw_planes(
        self, planes, lengths, addrs, release=None
    ) -> bool:
        """Batch raw-plane ingest — the native rx ring's entry: ``planes``
        is the leased ring plane (uint8[P, row], shipped to the device
        without an intermediate numpy copy), ``lengths`` carries each
        row's datagram size with non-dv2 rows zeroed (they fail the
        in-kernel verdict and cost only a verdict lane), ``addrs`` maps
        rows to senders for the ack bookkeeping, and ``release`` commits
        the ring plane back once the H2D transfer is ready. Returns False
        when the engine can't take the raw path (caller falls back);
        ``release`` is honored either way."""
        eng = self.raw_engine()
        if eng is None:
            if release is not None:
                release()
            return False
        from patrol_tpu_torch.ops import ingest as ingest_ops

        t0 = time.perf_counter_ns()
        walk = ingest_ops.host_walk(planes, lengths)
        self._ingest_walk(eng, planes, lengths, walk, addrs, release, t0)
        return True

    def _ingest_walk(
        self, eng, planes, lengths, walk, addrs, release, t0_ns: int
    ) -> None:
        """Shared tail of the raw rx paths: per-packet header/ack
        bookkeeping from the walk (the python decoder's exact counter
        semantics), then ONE engine dispatch for the whole plane batch.
        The walk rides into the engine so the directory pass never
        re-walks the bytes."""
        dur = time.perf_counter_ns() - t0_ns
        hist.STAGE_RX_DECODE.record(dur)
        tr = trace_mod.TRACE
        if tr.enabled:
            tr.record(
                trace_mod.EV_RX_DECODE, dur, max(int(walk.count.sum()), 1)
            )
        max_slots = self.rep.slots.max_slots
        data_live = False
        with self._mu:
            for i in range(len(lengths)):
                if lengths[i] <= 0:
                    continue  # non-dv2 ring row: not delta traffic
                if not walk.ok[i]:
                    self.rx_errors += 1
                    continue
                st = self._peer(addrs[i])
                # A peer shipping deltas is v2-capable by demonstration.
                st.capable = True
                n_acks = int(walk.n_acks[i])
                for k in range(n_acks):
                    self._on_ack_locked(st, int(walk.acks[i, k]))
                if n_acks and tr.enabled:
                    tr.record(trace_mod.EV_DELTA_ACK, 0, n_acks)
                if walk.seq[i]:
                    st.pending_acks.append(int(walk.seq[i]))
                cnt = int(walk.count[i])
                if cnt:
                    st.last_rx_data_ns = time.perf_counter_ns()
                    data_live = True
                self.rx_packets += 1
                self.rx_deltas += cnt
                # Python-path parity for the per-entry error counter:
                # out-of-range slots and control-channel names are
                # counted (and never folded — the engine's entry filter
                # sentinels them out of the dispatch).
                if cnt:
                    offs = walk.name_off[i, :cnt].astype(np.int64)
                    first = np.asarray(planes)[
                        i, np.clip(offs, 0, np.asarray(planes).shape[1] - 1)
                    ]
                    ctrl = (walk.name_len[i, :cnt] > 0) & (first == 0)
                    bad = int(
                        ((walk.slot[i, :cnt] >= max_slots) | ctrl).sum()
                    )
                    self.rx_errors += bad
        # Acking needs a pacing tick even on nodes that ship no deltas.
        self.start()
        if data_live:
            eng.ingest_raw_planes(planes, lengths, walk=walk, release=release)
            hist.RX_APPLY.record(time.perf_counter_ns() - t0_ns)
        elif release is not None:
            release()

    def on_packet(self, data: bytes, addr: Addr) -> bool:
        """Decode + ingest one delta datagram. False ⇒ malformed (counted;
        the caller's generic rx error accounting need not double-count).
        When the engine supports device-resident ingest the datagram
        ships as a raw byte plane (ops/ingest.py) instead of through the
        python decoder — same verdicts, same counters, one dispatch."""
        eng = self.raw_engine()
        if eng is not None and len(data) <= wire.DELTA_PACKET_SIZE:
            return self._on_packet_raw(eng, data, addr)
        t0 = time.perf_counter_ns()
        pkt = wire.decode_delta_packet(data)
        if pkt is None:
            self.rx_errors += 1
            return False
        dur = time.perf_counter_ns() - t0
        hist.STAGE_RX_DECODE.record(dur)
        tr = trace_mod.TRACE
        if tr.enabled:
            tr.record(trace_mod.EV_RX_DECODE, dur, max(len(pkt.entries), 1))
        with self._mu:
            st = self._peer(addr)
            # A peer shipping deltas is v2-capable by demonstration; until
            # its advert arrives, assume the conservative rx bound.
            st.capable = True
            for seq in pkt.acks:
                self._on_ack_locked(st, seq)
            if pkt.acks:
                tr = trace_mod.TRACE
                if tr.enabled:
                    tr.record(trace_mod.EV_DELTA_ACK, 0, len(pkt.acks))
            if pkt.seq:
                st.pending_acks.append(pkt.seq)
            if pkt.entries:
                st.last_rx_data_ns = time.perf_counter_ns()
            self.rx_packets += 1
            self.rx_deltas += len(pkt.entries)
        # Acking needs a pacing tick even on nodes that ship no deltas.
        self.start()
        repo = getattr(self.rep, "repo", None)
        if repo is None or not pkt.entries:
            return True
        max_slots = self.rep.slots.max_slots
        names: List[str] = []
        slots: List[int] = []
        caps: List[int] = []
        added: List[int] = []
        taken: List[int] = []
        elapsed: List[int] = []
        for e in pkt.entries:
            if e.slot >= max_slots or e.name.startswith(CTRL_PREFIX):
                self.rx_errors += 1
                continue
            names.append(e.name)
            slots.append(e.slot)
            caps.append(e.cap_nt)
            added.append(e.added_nt)
            taken.append(e.taken_nt)
            elapsed.append(e.elapsed_ns)
        if names:
            repo.engine.ingest_interval(names, slots, caps, added, taken, elapsed)
            hist.RX_APPLY.record(time.perf_counter_ns() - t0)
        return True

    # -- observability -------------------------------------------------------

    def lag_stats(self, now_ns: Optional[int] = None) -> Dict[Addr, dict]:
        """Per-peer replication-lag view for patrol-audit (net/audit.py),
        derived entirely from state the plane already keeps — the interval
        log and ack bookkeeping carry lag for free (arXiv:1410.2803):

        * ``unacked`` — outstanding interval count (the seq gap between
          what we shipped and what the peer acknowledged);
        * ``oldest_unacked_age_ns`` — age of the oldest un-acked interval
          (0 when fully acked): how long the peer has been behind;
        * ``last_rx_data_age_ns`` — time since the peer last shipped us a
          data-bearing interval (None when it never has);
        * ``srtt_ticks`` / ``retransmit_timeout_ticks`` — the smoothed ack
          round trip (None before the first ack) and the timeout it sets.

        Covers every peer that has exchanged delta traffic; read-only."""
        now = time.perf_counter_ns() if now_ns is None else now_ns
        out: Dict[Addr, dict] = {}
        with self._mu:
            for addr, st in self._peers.items():
                if not st.capable and not st.unacked and not st.last_rx_data_ns:
                    continue
                oldest = min(
                    (t_ns for _, t_ns, _ in st.unacked.values()), default=None
                )
                out[addr] = {
                    "unacked": len(st.unacked),
                    "oldest_unacked_age_ns": (
                        max(0, now - oldest) if oldest is not None else 0
                    ),
                    "last_rx_data_age_ns": (
                        max(0, now - st.last_rx_data_ns)
                        if st.last_rx_data_ns
                        else None
                    ),
                    "srtt_ticks": st.srtt,
                    "retransmit_timeout_ticks": self._timeout_locked(st),
                }
        return out

    def stats(self) -> dict:
        with self._mu:
            capable = sum(1 for st in self._peers.values() if st.capable)
            unacked = sum(len(st.unacked) for st in self._peers.values())
            return {
                "wire_delta_peers": capable,
                "wire_deltas_batched": self.deltas_batched,
                "wire_delta_packets_tx": self.data_packets_tx,
                "wire_delta_ack_packets_tx": self.ack_packets_tx,
                "wire_interval_retransmits": self.interval_retransmits,
                "wire_intervals_unacked": unacked,
                "wire_fullstate_fallbacks": self.fullstate_fallbacks,
                "wire_ae_deduped": self.ae_deduped,
                "wire_delta_rx_packets": self.rx_packets,
                "wire_delta_rx_deltas": self.rx_deltas,
                "wire_delta_rx_errors": self.rx_errors,
                "wire_adverts_tx": self.adverts_tx,
            }


class _NotCapable:
    capable = False


_NOT_CAPABLE = _NotCapable()
