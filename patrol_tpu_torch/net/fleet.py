"""patrol-fleet: cluster-wide metrics-lattice gossip (the observability
plane's *cluster* half).

patrol-scope (utils/histogram.py, utils/trace.py) made every node
observable; the paper's whole point is a cluster that eventually
converges ("AP in CAP"), and the views ROADMAP items 1-3 need — pod-wide
take/ingest attribution, fleet-level stage timing, trend inputs — exist
on no single node. The histograms are already G-Counter lattices (one
monotone count lane per node, join = per-lane max) and the profiling
counters are monotone scalars, so fleet aggregation is exactly the
delta-state CRDT move of Almeida et al. (arXiv:1410.2803) the wire-v2
data plane already uses for bucket state:

* a paced flusher absorbs the local registry into this node's lane of a
  :class:`FleetStore` and ships the store's CURRENT join-decompositions
  (per-bucket histogram counts, per-counter values — absolute monotone
  numbers) as ``\\x00pt!mtr`` control-channel datagrams to every peer,
  Tascade-style pairwise joins (arXiv:2311.15810) instead of a central
  scraper;
* receivers max-join every packet into their own store — dup, reorder
  and stale delivery are no-ops by the lattice laws, and a dropped
  packet is subsumed by the next flush (the gossip is stateless: no
  acks, no retransmit bookkeeping, CRDT-correct under drop/dup/reorder
  by construction);
* because each flush ships the MERGED store (not just the local lane),
  lanes propagate transitively — any node answers ``GET
  /cluster/metrics`` (merged Prometheus exposition with per-node
  labels) and ``GET /cluster/vars`` for the whole fleet.

The channel rides the reserved-name control namespace exactly like
``dv2``: v1 reference peers read an incast request for an impossible
bucket and stay silent; pre-fleet patrol builds ignore the unknown
control name (pinned by the mixed-cluster interop test).

Thread model: one flusher thread per replicator (started only when the
node has peers); ``on_packet`` runs on the rx thread; one lock guards
the store. Sends go through the owning replicator's thread-safe
``unicast`` AFTER the lock is released — the plane never holds its lock
across a send (no new lock-graph edges for patrol-race).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from patrol_tpu_torch.ops import wire
from patrol_tpu_torch.utils import histogram as hist
from patrol_tpu_torch.utils import profiling
from patrol_tpu_torch.utils import config
from patrol_tpu_torch.utils import slo as slo_mod

Addr = Tuple[str, int]


class FleetStore:
    """The per-node merged view of the fleet's metric lattices: one
    :class:`~patrol_tpu_torch.utils.histogram.LatticeHistogram` per histogram
    name whose lanes are CLUSTER node slots (joined with the existing
    ``join_lattice``), plus per-(counter, node) monotone values and the
    gossiped slot→name identity map."""

    def __init__(self, max_slots: int):
        self.max_slots = max_slots
        self._mu = threading.Lock()
        self._hists: Dict[str, hist.LatticeHistogram] = {}
        self._counters: Dict[str, Dict[int, int]] = {}
        self._node_names: Dict[int, str] = {}

    # -- joins (all idempotent/commutative/associative) ----------------------

    def join_counter(self, name: str, slot: int, value: int) -> None:
        if not 0 <= slot < self.max_slots:
            return
        with self._mu:
            lanes = self._counters.setdefault(name, {})
            if value > lanes.get(slot, 0):
                lanes[slot] = value

    def join_hist_lane(
        self,
        name: str,
        unit: str,
        slot: int,
        total: int,
        buckets,  # iterable of (bucket_index, count)
    ) -> None:
        """Max-join one lane's join-decomposition (possibly a bucket
        subset) into the fleet lattice, via the histogram's own
        ``join_lattice``."""
        if not 0 <= slot < self.max_slots:
            return
        counts = [0] * hist.NBUCKETS
        for b, c in buckets:
            if 0 <= b < hist.NBUCKETS:
                counts[b] = max(counts[b], c)
        lattice = {
            "counts": [[0] * hist.NBUCKETS] * slot + [counts],
            "sums": [0] * slot + [total],
        }
        with self._mu:
            h = self._hists.get(name)
            if h is None:
                h = hist.LatticeHistogram(name, nodes=slot + 1, unit=unit)
                self._hists[name] = h
            h.join_lattice(lattice)

    def note_node(self, slot: int, name: str) -> None:
        if name and 0 <= slot < self.max_slots:
            with self._mu:
                self._node_names.setdefault(slot, name)

    def absorb_packet(self, pkt: wire.MetricsPacket) -> int:
        """Join one decoded gossip datagram; returns lanes joined."""
        for slot, nm in pkt.node_names:
            self.note_node(slot, nm)
        for nm, slot, val in pkt.counters:
            self.join_counter(nm, slot, val)
        for lane in pkt.hists:
            self.join_hist_lane(
                lane.name, lane.unit, lane.slot, lane.sum, lane.buckets
            )
        return len(pkt.counters) + len(pkt.hists)

    def absorb_local(
        self,
        registry: hist.HistogramRegistry,
        counters: Dict[str, int],
        slot: int,
        node_name: str,
    ) -> None:
        """Re-home the local registry's merged view into this node's
        cluster lane. Exact because every local lane is monotone, so the
        lane-sum is monotone too — successive absorbs only grow."""
        self.note_node(slot, node_name)
        for name, h in registry.items():
            lat = h.to_lattice()
            counts = [sum(col) for col in zip(*lat["counts"])]
            total = sum(lat["sums"])
            if total == 0 and not any(counts):
                continue
            self.join_hist_lane(
                name, lat["unit"], slot, total,
                [(b, c) for b, c in enumerate(counts) if c],
            )
        for name, val in counters.items():
            if isinstance(val, int) and val > 0:
                self.join_counter(name, slot, val)

    # -- reads ---------------------------------------------------------------

    def lattice_snapshot(self) -> dict:
        """Full lattice state: ``hists[name][slot] = (counts, sum)``,
        ``counters[name][slot] = value``, ``node_names[slot] = name`` —
        the render/compare surface (bit-exact, no summarization)."""
        with self._mu:
            hists: Dict[str, Dict[int, tuple]] = {}
            for name, h in self._hists.items():
                lat = h.to_lattice()
                lanes = {}
                for slot, counts in enumerate(lat["counts"]):
                    if any(counts) or lat["sums"][slot]:
                        lanes[slot] = (list(counts), lat["sums"][slot])
                hists[name] = lanes
            return {
                "hists": hists,
                "counters": {n: dict(l) for n, l in self._counters.items()},
                "node_names": dict(self._node_names),
            }

    def export_lanes(self) -> Tuple[List[tuple], List[wire.MetricsLane]]:
        """The store's current join-decompositions, ready for the wire:
        (counter entries, histogram lane entries)."""
        snap = self.lattice_snapshot()
        counters = [
            (name, slot, val)
            for name, lanes in sorted(snap["counters"].items())
            for slot, val in sorted(lanes.items())
        ]
        hist_lanes = []
        for name, lanes in sorted(snap["hists"].items()):
            unit = "ns"
            with self._mu:
                h = self._hists.get(name)
                if h is not None:
                    unit = h.unit
            for slot, (counts, total) in sorted(lanes.items()):
                hist_lanes.append(
                    wire.MetricsLane(
                        name=name,
                        unit=unit,
                        slot=slot,
                        sum=total,
                        buckets=tuple(
                            (b, c) for b, c in enumerate(counts) if c
                        ),
                    )
                )
        return counters, hist_lanes

    def summary(self) -> dict:
        """`/cluster/vars`: per-node summaries (count/p50/p99/max) of
        every gossiped histogram lane plus the counter lanes and the
        identity map."""
        snap = self.lattice_snapshot()
        hists: Dict[str, dict] = {}
        for name, lanes in snap["hists"].items():
            per_node = {}
            for slot, (counts, total) in lanes.items():
                one = hist.LatticeHistogram(name, nodes=1)
                one._counts[0] = list(counts)
                one._sums[0] = total
                per_node[str(slot)] = one.summary()
            hists[name] = per_node
        return {
            "cluster_nodes_seen": len(snap["node_names"]),
            "node_names": {str(s): n for s, n in snap["node_names"].items()},
            "counters": {
                n: {str(s): v for s, v in l.items()}
                for n, l in snap["counters"].items()
            },
            "histograms": hists,
        }


class FleetPlane:
    """One per replicator (either backend): the paced metrics-gossip
    flusher plus the rx join path. Construction is cheap; the flusher
    thread starts only via :meth:`start` (the replicators start it when
    the node has peers) or lazily on first gossip rx."""

    def __init__(
        self,
        rep,
        registry: Optional[hist.HistogramRegistry] = None,
        counters=None,
        gossip_interval_s: Optional[float] = None,
        tx_mtu: int = wire.DELTA_PACKET_SIZE,
    ):
        self.rep = rep
        self.node_slot = rep.slots.self_slot
        self.registry = registry if registry is not None else hist.HISTOGRAMS
        self.counters = counters if counters is not None else profiling.COUNTERS
        self.store = FleetStore(rep.slots.max_slots)
        self.node_name = ""
        self.tx_mtu = min(tx_mtu, wire.DELTA_PACKET_SIZE)
        self.gossip_interval_s = (
            config.env_float("PATROL_FLEET_GOSSIP_MS") / 1000.0
            if gossip_interval_s is None
            else gossip_interval_s
        )
        self._mu = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stopped = threading.Event()
        self.packets_tx = 0
        self.packets_rx = 0
        self.rx_errors = 0
        self.lanes_rx = 0
        self.flushes = 0

    # -- lifecycle -----------------------------------------------------------

    def set_identity(self, name: str) -> None:
        self.node_name = name
        self.store.note_node(self.node_slot, name)

    def start(self) -> None:
        if self.gossip_interval_s <= 0 or self._thread is not None:
            return
        with self._mu:
            if self._thread is not None or self._stopped.is_set():
                return
            self._thread = threading.Thread(
                target=self._run, name="patrol-fleet-gossip", daemon=True
            )
            self._thread.start()

    def _run(self) -> None:
        while True:
            interval = self.gossip_interval_s
            if interval <= 0 or self._stopped.wait(interval):
                return
            try:
                self.flush()
            except Exception:  # pragma: no cover - gossip must not die
                if getattr(self.rep, "log", None):
                    self.rep.log.exception("fleet gossip flush failed")

    def close(self) -> None:
        self._stopped.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2)

    # -- gossip tick ---------------------------------------------------------

    def _peer_mtu(self, addr: Addr) -> int:
        """Pack to what the peer can receive: its delta-plane advertised
        rx bound when known, the v1 packet size otherwise (the gossip
        splits histogram lanes across packets, so a 256-B bound costs
        packets, never data)."""
        delta = getattr(self.rep, "delta", None)
        if delta is not None:
            with delta._mu:
                st = delta._peers.get(addr)
                if st is not None and st.capable:
                    return min(self.tx_mtu, st.max_rx)
        return min(self.tx_mtu, wire.PACKET_SIZE)

    def flush(self) -> int:
        """One gossip tick: absorb the local registry into this node's
        lane, run the SLO sentinel over the fresh local state, then ship
        the merged store's join-decompositions to every peer. Returns
        datagrams sent."""
        self.flushes += 1
        self.store.absorb_local(
            self.registry,
            self.counters.snapshot(),
            self.node_slot,
            self.node_name,
        )
        slo_mod.SENTINEL.check(self.registry)
        # GC-cadence backstop (ROADMAP 4e): the host-serve seams and the
        # native pump kick the feeder's lifecycle sweep at window
        # rollover, but an rx-absorb-only or fully idle node never runs
        # either seam — this standing timer is the one paced tick such a
        # node still has, so hang the sweep check off it. Two int reads
        # when the window hasn't rolled; the sweep itself runs on the
        # feeder.
        repo = getattr(self.rep, "repo", None)
        eng = getattr(repo, "engine", None) if repo is not None else None
        if eng is not None and hasattr(eng, "_kick_gc_if_due"):
            try:
                eng._kick_gc_if_due(eng.clock())
            except Exception:  # pragma: no cover - gossip must not die
                pass
        peers = list(getattr(self.rep, "peers", ()))
        if not peers:
            return 0
        counters, hist_lanes = self.store.export_lanes()
        snap_names = sorted(
            self.store.lattice_snapshot()["node_names"].items()
        )
        sent = 0
        by_mtu: Dict[int, List[bytes]] = {}
        for addr in peers:
            mtu = self._peer_mtu(addr)
            pkts = by_mtu.get(mtu)
            if pkts is None:
                pkts = by_mtu[mtu] = wire.encode_metrics_packets(
                    self.node_slot, snap_names, counters, hist_lanes, mtu
                )
            for data in pkts:
                self.rep.unicast(data, addr)
                sent += 1
        if sent:
            self.packets_tx += sent
            profiling.COUNTERS.inc("fleet_packets_tx", sent)
        return sent

    # -- rx ------------------------------------------------------------------

    def on_packet(self, data: bytes, addr: Addr) -> bool:
        """Decode + join one gossip datagram. False ⇒ malformed."""
        pkt = wire.decode_metrics_packet(data)
        if pkt is None:
            self.rx_errors += 1
            return False
        self.packets_rx += 1
        profiling.COUNTERS.inc("fleet_packets_rx")
        self.lanes_rx += self.store.absorb_packet(pkt)
        # A node that only LISTENS still re-gossips what it learned
        # (transitive propagation needs every member to forward).
        self.start()
        return True

    # -- observability -------------------------------------------------------

    def stats(self) -> dict:
        snap = self.store.lattice_snapshot()
        return {
            "fleet_packets_tx": self.packets_tx,
            "fleet_packets_rx": self.packets_rx,
            "fleet_rx_errors": self.rx_errors,
            "fleet_lanes_rx": self.lanes_rx,
            "fleet_flushes": self.flushes,
            "fleet_nodes_seen": len(snap["node_names"]),
            "fleet_hists": len(snap["hists"]),
        }
