"""Native UDP replication backend: the C++ recvmmsg/sendmmsg host path.

Same protocol as :mod:`patrol_tpu_torch.net.replication` (and the reference,
repo.go:20-169); different machinery, shaped like the Go runtime's compiled
network path rather than an asyncio event loop:

* a dedicated RX thread pulls up to 512 datagrams per syscall
  (``pt_recv_batch``) straight into a leased plane of a C++-owned ring
  (``native.RxRing``), batch-decodes them in C++ (``pt_decode_batch``), and
  bulk-queues the deltas into the device engine — wire→device with two
  python-level calls per *batch*, not per packet. Wire-v2 delta datagrams
  ship from the plane itself to one ``decode_fold`` launch per batch
  (``DeltaPlane.on_raw_planes``); on a CUDA node the planes are registered
  as page-locked memory (:meth:`NativeReplicator.pin_rx_ring`), so that
  copy needs no staging bounce;
* TX runs directly on the engine thread: one ``sendmmsg`` flushes an entire
  broadcast matrix (states × peers), no event-loop hop;
* incast requests (zero-state packets, repo.go:78-90) are answered from the
  RX thread with unicast lane snapshots.
"""

from __future__ import annotations

import logging
import socket as pysocket
import struct
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from patrol_tpu_torch import native
from patrol_tpu_torch.ops import ingest as ingest_ops
from patrol_tpu_torch.ops import wire
from patrol_tpu_torch.net.replication import (
    CTRL_PREFIX,
    PROBE_ACK_NAME,
    PROBE_NAME,
    PeerHealth,
    ReplyGate,
    SlotTable,
    parse_addr,
    _is_ip,
    _resolve,
)
from patrol_tpu_torch.utils import histogram as hist
from patrol_tpu_torch.utils import profiling
from patrol_tpu_torch.utils import trace as trace_mod

log = logging.getLogger("patrol.native-replication")


def _ip_to_u32(ip: str) -> int:
    return struct.unpack("!I", pysocket.inet_aton(ip))[0]


def _u32_to_ip(v: int) -> str:
    return pysocket.inet_ntoa(struct.pack("!I", v))


class NativeReplicator:
    """Drop-in peer of :class:`patrol_tpu_torch.net.replication.Replicator` with
    the same surface (broadcast_states / send_incast_request / repo / stats /
    close), driven by the native library instead of asyncio."""

    def __init__(
        self,
        node_addr: str,
        peer_addrs: Sequence[str],
        slots: SlotTable,
        log_=None,
        wire_mode: str = "aggregate",
    ):
        host, port = parse_addr(node_addr)
        self.sock = native.NativeSocket(host, port)
        self.node_addr = node_addr
        self.slots = slots
        self.log = log_ or log
        if wire_mode == "full":
            wire_mode = "aggregate"  # the CLI's opt-out alias
        if wire_mode not in ("aggregate", "compat", "delta"):
            raise ValueError(f"unknown wire_mode {wire_mode!r}")
        # "aggregate" = dual-payload wire form (flag-day vs pre-lane-trailer
        # builds); "compat" = raw own-lane headers + base trailers for
        # rolling upgrades; "delta" = batched delta-interval datagrams to
        # v2-capable peers (net/delta.py). See ops/wire.py module docs.
        self.wire_mode = wire_mode
        # Unresolvable peers are health-tracked for re-resolution but
        # excluded from the fan-out arrays (inet_aton on a hostname would
        # have crashed this constructor before the resilience layer).
        self.health = PeerHealth()
        peers: List[Tuple[str, int]] = []
        for p in dict.fromkeys(peer_addrs):
            if p == node_addr:
                continue
            a = _resolve(p)
            ok = _is_ip(a[0])
            self.health.add_peer(p, a, resolved=ok)
            if ok:
                peers.append(a)
            else:
                self.log.warning("peer %s unresolvable at startup; will retry", p)
        self.peers = peers
        self._endpoints = (
            np.array([_ip_to_u32(h) for h, _ in peers], np.uint32),
            np.array([p for _, p in peers], np.uint16),
        )
        self.repo = None  # wired by the supervisor
        self.reply_gate = ReplyGate()
        self.rx_packets = 0
        self.rx_errors = 0
        self.tx_packets = 0
        self.tx_bytes = 0
        self.send_errors = 0
        # Fault injection: predicate (host, port)→bool; True drops traffic
        # to/from that peer (partition simulation). Settable at runtime.
        self.drop_addr = None
        # Scripted fault injection (net/faultnet.py). While set, rx runs
        # the per-packet python path (chaos is a test/debug mode; the
        # vectorized batch path resumes the moment it is detached).
        self.faultnet = None
        from patrol_tpu_torch.net.antientropy import AntiEntropy
        from patrol_tpu_torch.net.audit import AuditPlane
        from patrol_tpu_torch.net.delta import DeltaPlane
        from patrol_tpu_torch.net.fleet import FleetPlane

        self.antientropy = AntiEntropy(self)
        # The recvmmsg rx ring rows are DELTA-sized (native.RX_RING_ROW =
        # 8 KiB): the compiled path receives full delta
        # intervals, so this backend advertises the same rx bound as the
        # asyncio one and unicast tx is row-sized per datagram.
        self.delta = DeltaPlane(
            self, tx_mtu=native.RX_RING_ROW, rx_mtu=native.RX_RING_ROW
        )
        if self.wire_mode == "delta":
            self.delta.start()
        # patrol-fleet metrics-lattice gossip (net/fleet.py).
        self.fleet = FleetPlane(self, tx_mtu=native.RX_RING_ROW)
        # patrol-audit consistency plane (net/audit.py): the rx ring rows
        # bound the frame size exactly like the delta/fleet planes.
        self.audit = AuditPlane(self, tx_mtu=native.RX_RING_ROW)
        # Elastic membership (net/membership.py): runtime join / leave /
        # rejoin events over the control channel.
        from patrol_tpu_torch.net.membership import MembershipPlane

        self.membership = MembershipPlane(self)
        if peers:
            self.fleet.start()
            self.audit.start()
        self._probe_bytes = wire.encode(
            wire.WireState(name=PROBE_NAME, added=0.0, taken=0.0, elapsed_ns=0)
        )
        self._probe_ack_bytes = wire.encode(
            wire.WireState(name=PROBE_ACK_NAME, added=0.0, taken=0.0, elapsed_ns=0)
        )
        self._stopped = threading.Event()
        # Reused rx staging (device-commit pipeline): the slot/flag planes
        # the engine's ingest consumes are refilled into per-replicator
        # buffers instead of fresh per-batch allocations — safe because
        # every ingest path copies out of them (fancy-indexed chunk
        # slices) before queueing, and this thread is their only writer.
        self._slots_staging = np.empty(1024, np.int64)
        self._nt_staging = np.empty(1024, bool)
        # Reused decode output buffers (pt_decode_batch), one per rx loop.
        self._dbuf: "native.DecodeBuffers | None" = None
        # Zero-copy rx ring (device-resident ingest, ops/ingest.py): the
        # recvmmsg loop receives straight into C++-owned page-aligned
        # planes, dv2 rows ship to the device from the SAME memory (no
        # intermediate numpy copy), and the engine's completion pipeline
        # commits each plane back once its H2D transfer is ready. Ring
        # exhaustion (every plane in a still-shipping batch) falls back
        # to the socket's own staging buffer for that batch.
        self._rx_ring = None
        from patrol_tpu_torch.net.delta import RAW_INGEST

        if RAW_INGEST:
            self._rx_ring = native.RxRing(
                n_planes=4, max_batch=512, row=native.RX_RING_ROW
            )
        self._rx_thread = threading.Thread(
            target=self._rx_loop, name="patrol-native-rx", daemon=True
        )
        self._rx_thread.start()

    def pin_rx_ring(self) -> None:
        """Register the rx ring's planes as page-locked memory (a node
        whose engine runs on CUDA calls this once at start), so each
        batch's copy to the device leaves straight from its plane."""
        if self._rx_ring is not None:
            self._rx_ring.pin()

    def _stage_slots(self, n: int, raw_slots: np.ndarray) -> np.ndarray:
        """Fill the reused int64 slot staging plane from the decoder's
        raw slot column; grows (rarely — recv batches are ≤512) by
        doubling. Returns the live [:n] view."""
        if self._slots_staging.shape[0] < n:
            size = self._slots_staging.shape[0]
            while size < n:
                size <<= 1
            self._slots_staging = np.empty(size, np.int64)
            self._nt_staging = np.empty(size, bool)
        else:
            profiling.COUNTERS.inc("rx_staging_reuse_hits")
        slots = self._slots_staging[:n]
        np.copyto(slots, raw_slots[:n], casting="unsafe")
        return slots

    # -- receive path -------------------------------------------------------

    def _rx_loop(self) -> None:
        while not self._stopped.is_set():
            # Zero-copy ingest: receive straight into a leased ring plane
            # (committed back by the engine's completion pipeline once
            # the dv2 H2D transfer is ready); exhaustion or chaos mode
            # falls back to the socket's own staging buffer.
            ring = self._rx_ring
            lease = None
            if ring is not None and self.faultnet is None:
                lease = ring.lease()
            try:
                if lease is not None:
                    packets, sizes, ips, ports = self.sock.recv_batch_into(
                        ring.plane(lease), timeout_ms=100
                    )
                else:
                    packets, sizes, ips, ports = self.sock.recv_batch(
                        timeout_ms=100
                    )
            except OSError as exc:
                if lease is not None:
                    ring.commit(lease)
                if self._stopped.is_set():
                    return
                self.log.warning("recv failed: %s", exc)
                continue
            committed = lease is None
            try:
                committed = self._rx_batch(
                    packets, sizes, ips, ports, ring, lease
                )
            finally:
                if not committed and lease is not None:
                    ring.commit(lease)

    def _rx_batch(self, packets, sizes, ips, ports, ring, lease) -> bool:
        """One recv batch. Returns True when the leased ring plane's
        commit is already owned elsewhere (handed to the engine's
        completion pipeline, or no lease was taken)."""
        committed = lease is None
        n = len(packets)
        fn = self.faultnet
        if fn is not None:
            # Chaos mode: per-packet python ingestion so every fault
            # primitive (dup/reorder/delay release) applies exactly as
            # on the asyncio backend. Throughput is not the point here.
            for data, addr in fn.due():
                self._ingest_py(data, addr)
            for i in range(n):
                addr = (_u32_to_ip(int(ips[i])), int(ports[i]))
                for payload in fn.filter(bytes(packets[i][: sizes[i]]), addr):
                    self._ingest_py(payload, addr)
            self._health_tick()
            return committed
        if n == 0:
            self._health_tick()
            return committed
        self.rx_packets += n
        # Fully vectorized wire→engine: batch C++ decode into reused
        # buffers, resolve buckets through the directory's hash table —
        # a Python string is materialized only for incast requests and
        # first-seen bucket names (engine.ingest_deltas_batch_raw).
        t_batch0 = time.perf_counter_ns()
        self._dbuf, _ = native.decode_batch_raw(packets, sizes, self._dbuf)
        dbuf = self._dbuf
        dur = time.perf_counter_ns() - t_batch0
        # One observation per rx BATCH (the C++ decode is the unit of
        # work here, not the packet); arg carries the batch size.
        hist.STAGE_RX_DECODE.record(dur)
        tr = trace_mod.TRACE
        if tr.enabled:
            tr.record(trace_mod.EV_RX_DECODE, dur, n)
        valid = dbuf.name_lens[:n] >= 0
        self.rx_errors += int(n - valid.sum())
        live = valid.copy()
        # Device-resident ingest: dv2 delta datagrams sitting in a leased
        # ring plane ship to the device AS RAW BYTES (one decode+fold
        # dispatch, ops/ingest.py) instead of the per-packet python
        # decode the control-channel branch below would run. Decided up
        # front so the classify masks can exclude them.
        raw_dv2 = None
        if lease is not None:
            m = ingest_ops.dv2_mask(packets, sizes)
            if m.any() and self.delta.raw_engine() is not None:
                raw_dv2 = m
        # Peers are few: address-keyed decisions (fault injection,
        # v1 slot resolution) run per unique address, not per packet.
        addr_key = (ips.astype(np.uint64) << np.uint64(16)) | ports.astype(
            np.uint64
        )
        if self.drop_addr is not None and live.any():
            for k in np.unique(addr_key[live]):
                addr = (_u32_to_ip(int(k) >> 16), int(k) & 0xFFFF)
                if self.drop_addr(addr):
                    live &= addr_key != k
        if live.any():
            # Liveness per unique sender; a quiet→alive transition
            # triggers the heal-time anti-entropy exchange.
            for k in np.unique(addr_key[live]):
                addr = (_u32_to_ip(int(k) >> 16), int(k) & 0xFFFF)
                healed = self.health.on_rx(addr)
                if healed is not None:
                    self.antientropy.trigger(healed)
                    self.delta.on_peer_heal(healed)
        # Incast requests (zero-state packets, repo.go:86-90). dv2 rows
        # decode as zero-state control packets; the raw path claims them
        # out of the per-packet branch.
        zero = (
            live
            & (dbuf.added[:n] == 0)
            & (dbuf.taken[:n] == 0)
            & (dbuf.elapsed[:n] == 0)
        )
        inc = zero if raw_dv2 is None else zero & ~raw_dv2
        # Multi-lane trailers (compact incast replies): the flat batch
        # decode surfaces only slot+cap for them — re-decode the few
        # such packets (cold-start only) through the Python codec.
        multi2 = live & ~zero & (dbuf.multi[:n] == 2)
        deltas = live & ~zero & ~multi2
        # Slot resolution: a valid trailer carries the slot; otherwise
        # (v1 reference peer) resolve by sender address — per unique
        # address, peers are few. Unresolvable ⇒ dropped (slot −1).
        # Both planes live in reused staging, not fresh arrays: the
        # engine hands copies to its queue, never these views.
        slots = self._stage_slots(n, dbuf.slots)
        no_trailer = np.less(slots, 0, out=self._nt_staging[:n])
        need = deltas & (
            no_trailer | (slots >= self.slots.max_slots)
        )
        if need.any():
            for k in np.unique(addr_key[need]):
                addr = (_u32_to_ip(int(k) >> 16), int(k) & 0xFFFF)
                resolved = self.slots.resolve(addr)
                sel = need & (addr_key == k)
                slots[sel] = -1 if resolved is None else resolved
            unresolved = need & (slots < 0)
            self.rx_errors += int(unresolved.sum())
        slots[~deltas] = -1  # the classify keep-filter drops these
        # Data paths need the repo wired; control-channel handling
        # below does not (parity with the asyncio backend, which
        # dispatches control packets before its repo check).
        if deltas.any() and self.repo is not None:
            self.repo.engine.ingest_wire_batch(
                dbuf, n, slots, no_trailer.view(np.uint8)
            )
            # rx→apply for the whole batch: decode start to engine
            # queue handoff.
            hist.RX_APPLY.record(time.perf_counter_ns() - t_batch0)
        if multi2.any() and self.repo is not None:
            for i in np.flatnonzero(multi2):
                st = wire.decode(bytes(packets[i][: sizes[i]]))
                if st.lanes is None:
                    self.rx_errors += 1
                    continue
                lanes = [l for l in st.lanes if l[0] < self.slots.max_slots]
                self.rx_errors += len(st.lanes) - len(lanes)
                if lanes:
                    self.repo.engine.ingest_deltas_batch(
                        [st.name] * len(lanes),
                        [l[0] for l in lanes],
                        [st.added_nt] * len(lanes),
                        [st.taken_nt] * len(lanes),
                        [max(st.elapsed_ns, 0)] * len(lanes),
                        [st.cap_nt] * len(lanes),
                        [l[1] for l in lanes],
                        [l[2] for l in lanes],
                    )
        if inc.any():
            incasts = []
            for i in np.flatnonzero(inc):
                name = bytes(dbuf.names[i, : dbuf.name_lens[i]]).decode(
                    "utf-8", "surrogateescape"
                )
                if name.startswith(CTRL_PREFIX):
                    addr_i = (_u32_to_ip(int(ips[i])), int(ports[i]))
                    if name == wire.DELTA_CHANNEL_NAME:
                        # v2 delta interval: payload rides after the
                        # reserved name in the raw datagram bytes.
                        self.delta.on_packet(
                            bytes(packets[i][: sizes[i]]), addr_i
                        )
                    elif name == wire.METRICS_CHANNEL_NAME:
                        # patrol-fleet metrics gossip: same envelope.
                        self.fleet.on_packet(
                            bytes(packets[i][: sizes[i]]), addr_i
                        )
                    elif name == wire.AUDIT_CHANNEL_NAME:
                        # patrol-audit digests + admitted windows.
                        self.audit.on_packet(
                            bytes(packets[i][: sizes[i]]), addr_i
                        )
                    elif name == wire.MEMBER_CHANNEL_NAME:
                        # Elastic-membership events (join/leave/rejoin).
                        self.membership.on_packet(
                            bytes(packets[i][: sizes[i]]), addr_i
                        )
                    else:
                        # Probe pings / anti-entropy: never a bucket.
                        self._handle_control(name, addr_i)
                    continue
                incasts.append(
                    (
                        name,
                        int(ips[i]),
                        int(ports[i]),
                        int(dbuf.multi[i]) >= 1,  # requester's multi advert
                    )
                )
            if incasts and self.repo is not None:
                self._reply_incasts(incasts)
        # Device-resident raw dispatch: the leased plane's received rows
        # ship (non-dv2 rows ride along with zeroed lengths and fail the
        # in-kernel verdict for the cost of a verdict lane); the engine
        # commits the plane back once the H2D transfer is ready.
        if raw_dv2 is not None:
            sel = raw_dv2 & live
            if sel.any():
                # Exactly the n received rows ship (a zero-copy prefix of
                # the ring plane): the CUDA kernel has one variant for
                # every batch size, so nothing is padded.
                lengths = np.where(sel, sizes[:n], 0).astype(np.int32)
                addrs_l = [
                    (_u32_to_ip(int(ips[i])), int(ports[i])) if sel[i] else None
                    for i in range(n)
                ]
                handed = self.delta.on_raw_planes(
                    ring.plane(lease)[:n], lengths, addrs_l,
                    release=(lambda idx=lease: ring.commit(idx)),
                )
                # The release contract is honored either way (inline on
                # refusal) — never double-commit from the loop.
                committed = True
                if not handed:
                    # Engine raced away (repo detach): per-packet python
                    # fallback; bytes() copies, so the committed plane
                    # may recycle freely.
                    for i in np.flatnonzero(sel):
                        self.delta.on_packet(
                            bytes(packets[i][: sizes[i]]), addrs_l[i]
                        )
        self._health_tick()
        return committed

    def _ingest_py(self, data: bytes, addr: Tuple[str, int]) -> None:
        """Single-packet python ingestion — the chaos-mode (faultnet) and
        held-packet-release path. Mirrors the asyncio backend's rx logic
        step for step so both backends converge identically under faults."""
        if self.drop_addr is not None and self.drop_addr(addr):
            return
        self.rx_packets += 1
        t0 = time.perf_counter_ns()
        try:
            state = wire.decode(data)
        except ValueError:
            self.rx_errors += 1
            return
        dur = time.perf_counter_ns() - t0
        hist.STAGE_RX_DECODE.record(dur)
        if state.trace_id:
            trace_mod.SPANS.add(
                state.trace_id, self.slots.self_slot, "rx_decode",
                state.name, t0, dur,
            )
        healed = self.health.on_rx(addr)
        if healed is not None:
            self.antientropy.trigger(healed)
            self.delta.on_peer_heal(healed)
        if state.is_zero() and state.name.startswith(CTRL_PREFIX):
            if state.name == wire.DELTA_CHANNEL_NAME:
                self.delta.on_packet(data, addr)
                return
            if state.name == wire.METRICS_CHANNEL_NAME:
                self.fleet.on_packet(data, addr)
                return
            if state.name == wire.AUDIT_CHANNEL_NAME:
                self.audit.on_packet(data, addr)
                return
            if state.name == wire.MEMBER_CHANNEL_NAME:
                self.membership.on_packet(data, addr)
                return
            self._handle_control(state.name, addr)
            return
        if self.repo is None:
            return
        if state.is_zero():
            self._reply_incasts(
                [(state.name, _ip_to_u32(addr[0]), int(addr[1]), state.multi_ok)]
            )
            return
        if state.lanes is not None:
            for lane_slot, la, lt in state.lanes:
                if lane_slot >= self.slots.max_slots:
                    self.rx_errors += 1
                    continue
                self.repo.apply_delta(
                    wire.WireState(
                        name=state.name, added=state.added, taken=state.taken,
                        elapsed_ns=state.elapsed_ns, origin_slot=lane_slot,
                        cap_nt=state.cap_nt, lane_added_nt=la, lane_taken_nt=lt,
                    ),
                    lane_slot,
                )
            return
        slot = (
            state.origin_slot
            if state.origin_slot is not None
            and state.origin_slot < self.slots.max_slots
            else self.slots.resolve(addr)
        )
        if slot is None:
            self.rx_errors += 1
            return
        self.repo.apply_delta(state, slot, scalar=state.origin_slot is None)

    def _handle_control(self, name: str, addr: Tuple[str, int]) -> None:
        if name == PROBE_NAME:
            if self.reply_gate.allow(PROBE_ACK_NAME, addr):
                self.unicast(self._probe_ack_bytes, addr)
        elif name == PROBE_ACK_NAME:
            pass  # on_rx already refreshed liveness
        elif self.delta is not None and self.delta.handle_control(name, addr):
            pass  # v2 capability advert/ack (net/delta.py)
        elif self.antientropy is not None:
            self.antientropy.handle(name, addr)

    def _health_tick(self) -> None:
        """Probe/backoff/re-resolution schedule, driven from the rx thread
        (it wakes at least every recv timeout). Errors never kill rx."""
        try:
            probes, resolves = self.health.tick()
            for addr in probes:
                self.unicast(self._probe_bytes, addr)
            for p in resolves:
                self._reresolve_peer(p)
            if self.membership is not None:
                # Membership loss repair: re-announce recent local
                # events (bounded; duplicates are receiver no-ops).
                self.membership.maybe_replay()
        except Exception:  # pragma: no cover - rx loop must survive
            self.log.exception("health tick failed")

    def _reresolve_peer(self, p) -> None:
        old = p.addr
        try:
            new = _resolve(p.addr_str)
        except Exception:  # pragma: no cover - resolver must never raise
            return
        if not _is_ip(new[0]) or new == old:
            return
        self.slots.realias(old, new)
        self.health.mark_resolved(p, new)
        peers = [a for a in self.peers if a != old] + [new]
        self._swap_peers(peers)
        self.log.info("peer %s re-resolved to %s:%d", p.addr_str, new[0], new[1])

    def _swap_peers(self, peers: List[Tuple[str, int]]) -> None:
        """Adopt a new fan-out list. One atomic attribute swap per array
        pair: the engine thread reads ips+ports as a single tuple, so it
        can never see a half-updated fan-out."""
        self.peers = peers
        self._endpoints = (
            np.array([_ip_to_u32(h) for h, _ in peers], np.uint32),
            np.array([pt for _, pt in peers], np.uint16),
        )

    # -- elastic membership (net/membership.py drives these) ----------------

    def _adopt_peer(self, addr_str: str) -> Optional[Tuple[str, int]]:
        """Add a peer to the fan-out at runtime (membership join/rejoin).
        Idempotent. Starts the paced planes if this is the first peer."""
        if addr_str == self.node_addr:
            return None
        a = _resolve(addr_str)
        ok = _is_ip(a[0])
        if a not in self.health.peers:
            self.health.add_peer(addr_str, a, resolved=ok)
        if ok and a not in self.peers:
            self._swap_peers(self.peers + [a])
        if self.peers:
            self.fleet.start()
            self.audit.start()
        return a if ok else None

    def _drop_peer(self, addr_str: str) -> None:
        """Remove a departed peer from the fan-out (membership leave).
        Its lane stays tombstoned in the SlotTable — late datagrams from
        the address still attribute correctly and max-join to no-ops."""
        a = _resolve(addr_str)
        self._swap_peers([p for p in self.peers if p != a])
        self.health.remove_peer(a)
        if self.delta is not None:
            self.delta.on_peer_leave(a)

    def _encode_py(self, states):
        """Python-codec encode into the (n, 256) fan-out layout — the cold
        path for wire forms the C++ encoder doesn't speak (multi trailers)."""
        pkts = np.zeros((len(states), 256), np.uint8)
        szs = np.zeros(len(states), np.int32)
        for i, st in enumerate(states):
            b = wire.encode(st)
            pkts[i, : len(b)] = np.frombuffer(b, np.uint8)
            szs[i] = len(b)
        return pkts, szs

    def _reply_incasts(self, requests) -> None:
        """Serve a batch of incast requests with ONE device gather. The
        reply gate bounds storm amplification: one burst per (bucket,
        requester) per TTL (see replication.ReplyGate)."""
        requests = [
            r for r in requests if self.reply_gate.allow(r[0], (r[1], r[2]))
        ]
        if not requests:
            return
        by_name = self.repo.engine.snapshot_many([name for name, _, _, _ in requests])
        for name, ip, port, multi_ok in requests:
            states = by_name.get(name)
            if not states:
                continue
            if multi_ok and self.wire_mode != "compat":
                packed = wire.pack_multi(states)
                if any(s.lanes is not None for s in packed):
                    pkts, sizes2 = self._encode_py(packed)
                    self.tx_packets += self.sock.send_fanout(
                        pkts, sizes2,
                        np.array([ip], np.uint32), np.array([port], np.uint16),
                    )
                    continue
            pkts, sizes2 = self._encode_states(states)
            self.tx_packets += self.sock.send_fanout(
                pkts, sizes2, np.array([ip], np.uint32), np.array([port], np.uint16)
            )

    # -- send path ----------------------------------------------------------

    def unicast(self, data: bytes, addr: Tuple[str, int]) -> None:
        """Thread-safe single-datagram send (probes, acks, anti-entropy,
        delta intervals, metrics gossip). The staging row is sized to the
        datagram — the old fixed (1, 256) row capped unicast at the v1
        packet size and would have truncated 8-KiB delta intervals."""
        n = len(data)
        pkts = np.frombuffer(data, np.uint8).reshape(1, n)
        try:
            sent = self.sock.send_fanout(
                pkts,
                np.array([n], np.int32),
                np.array([_ip_to_u32(addr[0])], np.uint32),
                np.array([int(addr[1])], np.uint16),
            )
            self.tx_packets += sent
            self.tx_bytes += n * sent
        except OSError:
            self.send_errors += 1

    def _live_peers(self):
        ips, ports = self._endpoints
        if self.drop_addr is None:
            return ips, ports
        keep = [
            i
            for i in range(len(ips))
            if not self.drop_addr((_u32_to_ip(int(ips[i])), int(ports[i])))
        ]
        return ips[keep], ports[keep]

    def _encode_states(self, states: Sequence[wire.WireState]):
        """Mode-gated C++ batch encode (see Replicator._payload_bytes for
        the compat-form rationale)."""
        slots = [s.origin_slot if s.origin_slot is not None else -1 for s in states]
        if self.wire_mode == "compat":
            compat_ok = [
                s.cap_nt is not None
                and s.lane_added_nt is not None
                and s.lane_taken_nt is not None
                for s in states
            ]
            pkts, sizes = native.encode_batch(
                [
                    s.lane_added_nt / wire.NANO if ok else s.added
                    for s, ok in zip(states, compat_ok)
                ],
                [
                    s.lane_taken_nt / wire.NANO if ok else s.taken
                    for s, ok in zip(states, compat_ok)
                ],
                [s.elapsed_ns for s in states],
                [s.name for s in states],
                slots,
            )
        else:
            pkts, sizes = native.encode_batch(
                [s.added for s in states],
                [s.taken for s in states],
                [s.elapsed_ns for s in states],
                [s.name for s in states],
                slots,
                [s.cap_nt if s.cap_nt is not None else -1 for s in states],
                [s.lane_added_nt if s.lane_added_nt is not None else -1 for s in states],
                [s.lane_taken_nt if s.lane_taken_nt is not None else -1 for s in states],
            )
        return self._retry_oversize(states, pkts, sizes)

    def broadcast_states(self, states: Sequence[wire.WireState]) -> None:
        """Full-state broadcast to every peer (repo.go:123-158); one
        sendmmsg per ≤1024-datagram chunk. Runs on the caller's thread.
        In delta mode the emission splits like the asyncio backend's:
        delta-able states accumulate for v2-capable peers, classic
        datagrams go to the rest."""
        if not len(self._endpoints[0]) or not states:
            return
        if self.delta is not None and self.delta.tx_enabled:
            classic_addrs, leftover = self.delta.offer(states)
            classic = set(classic_addrs)
            if classic:
                self._fanout_states(
                    states, [a for a in self.peers if a in classic]
                )
            if leftover:
                capable = [a for a in self.peers if a not in classic]
                if capable:
                    self._fanout_states(leftover, capable)
            return
        self._fanout_states(states, None)

    def _fanout_states(
        self,
        states: Sequence[wire.WireState],
        addrs: Optional[List[Tuple[str, int]]],
    ) -> None:
        """Encode + sendmmsg ``states`` to ``addrs`` (None = every live
        peer)."""
        pkts, sizes = self._encode_states(states)
        if addrs is None:
            ips, ports = self._live_peers()
        else:
            if self.drop_addr is not None:
                addrs = [a for a in addrs if not self.drop_addr(a)]
            ips = np.array([_ip_to_u32(h) for h, _ in addrs], np.uint32)
            ports = np.array([p for _, p in addrs], np.uint16)
        if len(ips):
            sent = self.sock.send_fanout(pkts, sizes, ips, ports)
            self.tx_packets += sent
            self.tx_bytes += int(np.maximum(sizes, 0).sum()) * len(ips)
            profiling.COUNTERS.inc("replication_tx_packets", sent)
            profiling.COUNTERS.inc(
                "replication_tx_bytes", int(np.maximum(sizes, 0).sum()) * len(ips)
            )
            tr = trace_mod.TRACE
            if tr.enabled:
                tr.record(
                    trace_mod.EV_BROADCAST_TX, 0, len(sizes) * len(ips)
                )

    def _retry_oversize(self, states, pkts, sizes):
        """Re-encode trailer-oversized states (size −1) without the
        trailer: ``added`` stays capacity-included, so receivers treating
        these as v1 packets (sender-address slot table, scalar semantics)
        still converge."""
        bad = sizes < 0
        if not bad.any():
            return pkts, sizes
        retry_idx = np.flatnonzero(bad)
        r_pkts, r_sizes = native.encode_batch(
            [states[i].added for i in retry_idx],
            [states[i].taken for i in retry_idx],
            [states[i].elapsed_ns for i in retry_idx],
            [states[i].name for i in retry_idx],
            [-1] * len(retry_idx),
        )
        pkts = np.concatenate([pkts[~bad], r_pkts[r_sizes >= 0]])
        sizes = np.concatenate([sizes[~bad], r_sizes[r_sizes >= 0]])
        return pkts, sizes

    def send_incast_request(self, name: str) -> None:
        if not len(self._endpoints[0]):
            return
        try:
            # Base trailer with the multi-reply capability advert (0x04) —
            # python-encoded, the C++ encoder doesn't emit advert bits.
            pkts, sizes = self._encode_py(
                [
                    wire.WireState(
                        name=name, added=0.0, taken=0.0, elapsed_ns=0,
                        origin_slot=self.slots.self_slot, multi_ok=True,
                    )
                ]
            )
        except wire.NameTooLargeError:
            pkts, sizes = native.encode_batch([0.0], [0.0], [0], [name], [-1])
        ips, ports = self._live_peers()
        if sizes[0] >= 0 and len(ips):
            self.tx_packets += self.sock.send_fanout(pkts, sizes, ips, ports)

    def close(self) -> None:
        self._stopped.set()
        if self.delta is not None:
            self.delta.close()
        if self.fleet is not None:
            self.fleet.close()
        if self.audit is not None:
            self.audit.close()
        if self.antientropy is not None:
            self.antientropy.close()
        self._rx_thread.join(timeout=2)
        if self._rx_ring is not None:
            # Deferred release: the ring is unregistered and freed only
            # once the last leased plane commits (in-flight copies safe).
            self._rx_ring.close()
        self.sock.close()

    def stats(self) -> dict:
        out = {
            "replication_rx_packets": self.rx_packets,
            "replication_rx_errors": self.rx_errors,
            "replication_tx_packets": self.tx_packets,
            "replication_tx_bytes": self.tx_bytes,
            "replication_send_errors": self.send_errors,
            "replication_peers": len(self.peers),
            "replication_incast_suppressed": self.reply_gate.suppressed,
            "replication_backend": 1,  # 1 = native
            "faultnet_active": int(self.faultnet.active) if self.faultnet else 0,
        }
        out.update(self.health.stats())
        if self.membership is not None:
            out.update(self.membership.stats())
        if self._rx_ring is not None:
            out.update(self._rx_ring.stats())
        if self.delta is not None:
            out.update(self.delta.stats())
        if self.fleet is not None:
            out.update(self.fleet.stats())
        if self.audit is not None:
            out.update(self.audit.stats())
        if self.antientropy is not None:
            out.update(self.antientropy.stats())
        if self.faultnet is not None:
            out.update(self.faultnet.stats())
        return out


def available() -> bool:
    """Whether the native library builds and loads here."""
    return native.load() is not None
