"""patrol-audit: the live consistency observability plane — replication
lag, divergence gauges, and the measured AP-overshoot auditor.

patrol-scope made every node observable and patrol-fleet merged the
views cluster-wide; what neither answers is *how consistent
the cluster actually is right now*. The paper's defining tradeoff — AP
under partition, each side enforcing the limit independently so the
global limit is temporarily multiplied by the number of partition
sides — is model-checked (PTC003/PTC006 in analysis/protocol.py) but was
never *measured* on a live cluster. This plane closes that gap with
three always-on instruments, all read-only (it never repairs state —
that is anti-entropy's job):

* **Replication lag** — derived for free from the delta plane's interval
  log and ack vectors (arXiv:1410.2803): per-peer oldest-unacked-interval
  age and seq gap (``net/delta.py lag_stats``), per-peer
  time-since-last-absorb, and per-bucket staleness (how far the last
  local emission ran ahead of the last remote absorb, sampled from the
  engine's directory stamps).
* **Divergence meter** — a paced READ-ONLY digest exchange reusing the
  anti-entropy per-bucket digest codec (``\\x00pt!adt`` frames carry the
  same ``(fnv1a64(name), blake2b64(state))`` entries): receivers compare
  against their own state and gauge ``audit_divergent_buckets`` /
  ``audit_divergence_age_ms`` without ever triggering a resync. At a
  converged fixpoint the digests are bit-equal and the gauge reads zero —
  the chaos gate pins exactly this.
* **Over-admission auditor** — the runtime counterpart of
  replication-aware linearizability (arXiv:2502.19967, "behaves like the
  sequential limiter up to replication"): every admitted take books its
  nanotokens into the engine's windowed per-bucket admitted-token
  G-counter (:class:`patrol_tpu_torch.runtime.engine.AuditLedger`); the plane
  gossips each window's own-lane join-decompositions in the audit frame
  and max-joins received lanes (same lattice discipline as the
  patrol-fleet metrics gossip). Once a window's lanes quiesce
  cluster-wide, the plane compares global admitted against ``limit × 1``
  and reports the measured overshoot factor next to the concurrent
  PeerHealth-derived partition-sides estimate — the paper's AP bound as
  a live SLI on ``/metrics`` and ``/cluster/metrics``. The SLO sentinel
  (``PATROL_SLO_OVERSHOOT``, utils/slo.py) auto-fires a flight-recorder
  anomaly snapshot when the measured overshoot exceeds the sides
  estimate: admission multiplied beyond what the observed partition
  explains is evidence worth freezing.

Thread model: one paced flusher thread per replicator (started with
peers, or lazily on first audit rx) plus one worker for digest compares
(snapshot/digest work never runs on the rx path); ``on_packet`` runs on
the rx thread and does joins only. One leaf lock guards the store and
gauges; it is never held across a send or an engine snapshot. All sends
go through the owning replicator's thread-safe ``unicast``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from patrol_tpu_torch.ops import wire
from patrol_tpu_torch.net.antientropy import name_hash64, state_digest
from patrol_tpu_torch.utils import histogram as hist
from patrol_tpu_torch.utils import profiling
from patrol_tpu_torch.utils import slo as slo_mod
from patrol_tpu_torch.utils import trace as trace_mod
from patrol_tpu_torch.utils import config

Addr = Tuple[str, int]


class _Win:
    """One audit window's merged cluster view: per-bucket per-lane
    admitted nanotokens (G-counter, join = per-lane max), the max-joined
    limit view, the max-joined partition-sides estimate, and the quiesce
    bookkeeping. Guarded by the plane's ``_mu``."""

    __slots__ = (
        "lanes", "limits", "sides", "duration_ns", "closed",
        "last_change_tick", "evaluated",
    )

    def __init__(self, tick: int):
        self.lanes: Dict[str, Dict[int, int]] = {}
        self.limits: Dict[str, int] = {}
        self.sides = 1
        self.duration_ns = 0
        self.closed = False
        self.last_change_tick = tick
        self.evaluated = False


class AuditPlane:
    """One per replicator (either backend). The replicator routes
    ``\\x00pt!adt`` datagrams to :meth:`on_packet`; pacing lives on the
    plane's own thread (``PATROL_AUDIT_MS``, 0 = manual — tests and the
    bench drive :meth:`flush` explicitly, the same determinism precedent
    as the fleet gossip and GC cadence)."""

    def __init__(
        self,
        rep,
        interval_s: Optional[float] = None,
        max_buckets: int = 1024,
        max_lanes_per_window: int = 512,
        max_windows: int = 8,
        quiesce_ticks: int = 2,
        tx_mtu: int = wire.DELTA_PACKET_SIZE,
    ):
        self.rep = rep
        self.node_slot = rep.slots.self_slot
        self.interval_s = (
            config.env_float("PATROL_AUDIT_MS") / 1000.0
            if interval_s is None
            else interval_s
        )
        self.max_buckets = max_buckets
        self.max_lanes_per_window = max_lanes_per_window
        self.max_windows = max_windows
        self.quiesce_ticks = quiesce_ticks
        self.tx_mtu = min(tx_mtu, wire.DELTA_PACKET_SIZE)
        self._mu = threading.Lock()
        self._win: Dict[int, _Win] = {}
        self._tick = 0
        self._local_window = 0  # the engine ledger's current open window
        # Divergence meter (last completed compare round).
        self._divergent = 0
        self._divergence_since: Optional[float] = None
        self._compares = 0
        # Last evaluated overshoot.
        self._overshoot_factor = 0.0
        self._overshoot_window = -1
        self._overshoot_sides = 1
        self._evaluations = 0
        self._last_eval: List[dict] = []
        # Lag gauges (refreshed each flush).
        self._peer_lag_ms = 0
        self._peer_seq_gap = 0
        self._absorb_age_ms = 0
        self._staleness_ns = 0
        self._lag_samples = 0
        # Plumbing counters.
        self.packets_tx = 0
        self.packets_rx = 0
        self.rx_errors = 0
        self.flushes = 0
        # Digest-compare worker (AE's shape: jobs queue + one daemon).
        self._cond = threading.Condition(self._mu)
        self._jobs: deque = deque()
        self._jobs_cap = 256
        self._worker: Optional[threading.Thread] = None
        self._flusher: Optional[threading.Thread] = None
        self._stopped = False
        self._stop_evt = threading.Event()
        slo_mod.SENTINEL.watch_audit(self._slo_snapshot)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self.interval_s <= 0 or self._flusher is not None:
            return
        with self._mu:
            if self._flusher is not None or self._stopped:
                return
            self._flusher = threading.Thread(
                target=self._run, name="patrol-audit", daemon=True
            )
            self._flusher.start()

    def _run(self) -> None:
        while not self._stop_evt.wait(self.interval_s):
            try:
                self.flush()
            except Exception:  # pragma: no cover - flusher must not die
                if getattr(self.rep, "log", None):
                    self.rep.log.exception("audit flush failed")

    def close(self) -> None:
        self._stop_evt.set()
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
            worker = self._worker
        slo_mod.SENTINEL.unwatch_audit(self._slo_snapshot)
        if worker is not None:
            worker.join(timeout=2)
        t = self._flusher
        if t is not None:
            t.join(timeout=2)

    def _engine(self):
        repo = getattr(self.rep, "repo", None)
        return None if repo is None else repo.engine

    # -- lag + staleness (read-only derivations) -----------------------------

    def _sample_lag(self) -> None:
        """Refresh the replication-lag gauges from the delta plane's
        interval log and the health table; record one histogram sample
        per delta-exchanging peer (``audit_peer_lag_ns``)."""
        lag_ms = seq_gap = 0
        absorb_ms = 0
        samples = 0
        delta = getattr(self.rep, "delta", None)
        if delta is not None:
            for st in delta.lag_stats().values():
                age = st["oldest_unacked_age_ns"]
                hist.AUDIT_PEER_LAG.record(age)
                samples += 1
                lag_ms = max(lag_ms, age // 1_000_000)
                seq_gap = max(seq_gap, st["unacked"])
                rx_age = st["last_rx_data_age_ns"]
                if rx_age is not None:
                    absorb_ms = max(absorb_ms, rx_age // 1_000_000)
        if samples:
            profiling.COUNTERS.inc("audit_lag_samples", samples)
        stale_max = 0
        eng = self._engine()
        if eng is not None and hasattr(eng, "audit_staleness_samples"):
            for v in eng.audit_staleness_samples(self.max_buckets):
                hist.AUDIT_STALENESS.record(v)
                stale_max = max(stale_max, v)
        with self._mu:
            self._peer_lag_ms = lag_ms
            self._peer_seq_gap = seq_gap
            self._absorb_age_ms = absorb_ms
            self._staleness_ns = stale_max
            self._lag_samples += samples

    # -- admitted-window lattice ---------------------------------------------

    def _join_window_locked(
        self, wid: int, sides: int, closed: bool, dur_ns: int, lanes
    ) -> None:
        """Max-join one window report. Caller holds ``_mu``. ``lanes`` is
        an iterable of (name, slot, admitted_nt, limit_nt)."""
        w = self._win.get(wid)
        if w is None:
            if len(self._win) >= self.max_windows and wid < min(self._win):
                return  # older than everything tracked: ignore
            w = self._win[wid] = _Win(self._tick)
        changed = False
        if sides > w.sides:
            w.sides = sides
            changed = True
        if closed and not w.closed:
            w.closed = True
            changed = True
        if dur_ns > w.duration_ns:
            w.duration_ns = dur_ns
            changed = True
        for name, slot, admitted, limit in lanes:
            bucket = w.lanes.setdefault(name, {})
            if admitted > bucket.get(slot, 0):
                bucket[slot] = admitted
                changed = True
            if limit > w.limits.get(name, 0):
                w.limits[name] = limit
                changed = True
        if changed:
            w.last_change_tick = self._tick
            w.evaluated = False
        # Bound: drop the oldest windows beyond the cap (evaluated first
        # would be nicer, but oldest-id is deterministic and the cap is
        # generous next to the ledger's own deque(maxlen=4)).
        while len(self._win) > self.max_windows:
            del self._win[min(self._win)]

    def _absorb_ledger_locked(self, sides_now: int) -> None:
        eng = self._engine()
        if eng is None or not hasattr(eng, "audit_ledger"):
            return
        current, windows = eng.audit_ledger.export()
        self._local_window = max(self._local_window, current)
        for wid, dur, lanes in windows:
            self._join_window_locked(
                wid,
                sides_now if wid >= current else 1,
                wid < current,
                dur,
                (
                    (name, self.node_slot, adm, lim)
                    for name, (adm, lim) in lanes.items()
                ),
            )
        # The sides estimate belongs to the OPEN window even when no lane
        # landed yet — a partition with zero takes still has sides.
        w = self._win.get(current)
        if w is not None and sides_now > w.sides:
            w.sides = sides_now
            w.last_change_tick = self._tick

    def _sides_now(self) -> int:
        """PeerHealth-derived partition-sides estimate: this node's side
        plus every currently-unreachable peer as (at worst) its own side.
        An over-estimate by construction — the AP bound compares against
        the WORST partition the observed unreachability could explain."""
        health = getattr(self.rep, "health", None)
        if health is None:
            return 1
        with health._mu:
            dead = sum(
                1
                for p in health.peers.values()
                if not (
                    p.ever_heard
                    and health.clock() - p.last_rx <= health.alive_ttl_s
                )
            )
        return 1 + dead

    def _evaluate_locked(self) -> None:
        """Evaluate every closed, quiesced, not-yet-evaluated window:
        overshoot factor = max over buckets of global admitted / (limit ×
        1). Fires the SLO sentinel pass after the lock drops (the caller
        does) via the registered provider."""
        for wid in sorted(self._win):
            w = self._win[wid]
            if (
                w.evaluated
                or not (w.closed or wid < self._local_window)
                or wid >= self._local_window
                or self._tick - w.last_change_tick < self.quiesce_ticks
            ):
                continue
            detail = []
            factor = 0.0
            for name, bucket in w.lanes.items():
                limit = w.limits.get(name, 0)
                if limit <= 0:
                    continue
                admitted = sum(bucket.values())
                f = admitted / limit
                detail.append(
                    {
                        "bucket": name,
                        "admitted_nt": admitted,
                        "limit_nt": limit,
                        "lanes": len(bucket),
                        "factor": round(f, 4),
                    }
                )
                factor = max(factor, f)
            w.evaluated = True
            if not detail:
                continue
            detail.sort(key=lambda d: -d["factor"])
            self._overshoot_factor = factor
            self._overshoot_window = wid
            self._overshoot_sides = w.sides
            self._evaluations += 1
            self._last_eval = detail[:32]
            profiling.COUNTERS.inc("audit_windows_evaluated")
            profiling.COUNTERS.set_max(
                "audit_overshoot_millis", int(factor * 1000)
            )

    # -- flush (the pacing tick) ---------------------------------------------

    def flush(self) -> int:
        """One audit tick: refresh lag/staleness gauges, absorb the local
        ledger, evaluate quiesced windows, and ship the digest + window
        frame to every peer. Returns datagrams sent."""
        t0 = time.perf_counter_ns()
        self.flushes += 1
        self._sample_lag()
        sides_now = self._sides_now()
        eng = self._engine()
        if eng is not None and hasattr(eng, "audit_ledger"):
            eng.audit_ledger.roll(eng.clock())
        digests: List[Tuple[int, int]] = []
        if eng is not None:
            names = eng.directory.bound_names(self.max_buckets)
            for lo in range(0, len(names), 64):
                for name, states in eng.snapshot_many(
                    names[lo : lo + 64]
                ).items():
                    digests.append((name_hash64(name), state_digest(states)))
        with self._mu:
            self._tick += 1
            self._absorb_ledger_locked(sides_now)
            self._evaluate_locked()
            windows = [
                wire.AuditWindow(
                    window_id=wid,
                    sides=w.sides,
                    closed=w.closed or wid < self._local_window,
                    duration_ns=w.duration_ns,
                    lanes=tuple(
                        wire.AuditLane(
                            name=name,
                            slot=slot,
                            admitted_nt=adm,
                            limit_nt=w.limits.get(name, 0),
                        )
                        for name, bucket in w.lanes.items()
                        for slot, adm in bucket.items()
                    )[: self.max_lanes_per_window],
                )
                for wid, w in sorted(self._win.items())
            ]
        slo_mod.SENTINEL.check_audit()
        peers = list(getattr(self.rep, "peers", ()))
        sent = 0
        if peers and (digests or windows):
            packets = wire.encode_audit_packets(
                self.node_slot, digests, windows, self.tx_mtu
            )
            for addr in peers:
                for data in packets:
                    self.rep.unicast(data, addr)
                    sent += 1
        if sent:
            self.packets_tx += sent
            profiling.COUNTERS.inc("audit_packets_tx", sent)
        tr = trace_mod.TRACE
        if tr.enabled:
            tr.record(
                trace_mod.EV_AUDIT_TICK, time.perf_counter_ns() - t0, sent
            )
        return sent

    # -- rx ------------------------------------------------------------------

    def on_packet(self, data: bytes, addr: Addr) -> bool:
        """Decode + join one audit datagram; digest compares go to the
        worker (snapshot work never runs on the rx thread). False ⇒
        malformed."""
        pkt = wire.decode_audit_packet(data)
        if pkt is None:
            self.rx_errors += 1
            return False
        self.packets_rx += 1
        profiling.COUNTERS.inc("audit_packets_rx")
        with self._mu:
            for w in pkt.windows:
                self._join_window_locked(
                    w.window_id,
                    w.sides,
                    w.closed,
                    w.duration_ns,
                    (
                        (l.name, l.slot, l.admitted_nt, l.limit_nt)
                        for l in w.lanes
                        if l.slot < self.rep.slots.max_slots
                    ),
                )
        if pkt.digests:
            self._enqueue(("digest", list(pkt.digests)))
        self.start()
        return True

    def _enqueue(self, job) -> None:
        with self._cond:
            if self._stopped or len(self._jobs) >= self._jobs_cap:
                return
            self._jobs.append(job)
            if self._worker is None:
                self._worker = threading.Thread(
                    target=self._worker_run, name="patrol-audit-cmp",
                    daemon=True,
                )
                self._worker.start()
            self._cond.notify()

    def _worker_run(self) -> None:
        while True:
            with self._cond:
                while not self._jobs and not self._stopped:
                    self._cond.wait()
                if self._stopped and not self._jobs:
                    return
                job = self._jobs.popleft()
            try:
                if job[0] == "digest":
                    self._compare(job[1])
            except Exception:  # pragma: no cover - worker must not die
                if getattr(self.rep, "log", None):
                    self.rep.log.exception("audit digest compare failed")

    def _compare(self, entries: List[Tuple[int, int]]) -> None:
        """READ-ONLY divergence compare: the sender's per-bucket digests
        vs our own state. Unknown bucket or digest mismatch ⇒ divergent.
        Updates the gauge + age; never fetches, never pushes."""
        t0 = time.perf_counter_ns()
        eng = self._engine()
        own: Dict[int, int] = {}
        if eng is not None:
            names = eng.directory.bound_names(self.max_buckets)
            for lo in range(0, len(names), 64):
                for name, states in eng.snapshot_many(
                    names[lo : lo + 64]
                ).items():
                    own[name_hash64(name)] = state_digest(states)
        divergent = sum(1 for h, d in entries if own.get(h) != d)
        now = time.monotonic()
        with self._mu:
            self._divergent = divergent
            self._compares += 1
            if divergent:
                if self._divergence_since is None:
                    self._divergence_since = now
            else:
                self._divergence_since = None
        profiling.COUNTERS.inc("audit_divergence_checks")
        tr = trace_mod.TRACE
        if tr.enabled:
            tr.record(
                trace_mod.EV_AUDIT_COMPARE,
                time.perf_counter_ns() - t0,
                divergent,
            )

    # -- observability -------------------------------------------------------

    def _slo_snapshot(self) -> dict:
        """The SLO sentinel's overshoot provider (utils/slo.py
        ``watch_audit``): last evaluated window's factor vs its sides
        estimate."""
        with self._mu:
            return {
                "overshoot": self._overshoot_factor,
                "sides": self._overshoot_sides,
                "window": self._overshoot_window,
            }

    def last_evaluation(self) -> List[dict]:
        """Per-bucket detail of the last evaluated window (``/debug/audit``)."""
        with self._mu:
            return list(self._last_eval)

    def stats(self) -> dict:
        now = time.monotonic()
        with self._mu:
            age_ms = (
                int((now - self._divergence_since) * 1000)
                if self._divergence_since is not None
                else 0
            )
            return {
                "audit_divergent_buckets": self._divergent,
                "audit_divergence_age_ms": age_ms,
                "audit_divergence_compares": self._compares,
                "audit_overshoot_factor": round(self._overshoot_factor, 4),
                "audit_overshoot_window": self._overshoot_window,
                "audit_sides_estimate": self._overshoot_sides,
                "audit_windows_evaluated": self._evaluations,
                "audit_windows_tracked": len(self._win),
                "audit_peer_lag_ms": self._peer_lag_ms,
                "audit_peer_seq_gap": self._peer_seq_gap,
                "audit_absorb_age_ms": self._absorb_age_ms,
                "audit_staleness_ns": self._staleness_ns,
                "audit_lag_samples_total": self._lag_samples,
                "audit_packets_tx": self.packets_tx,
                "audit_packets_rx": self.packets_rx,
                "audit_rx_errors": self.rx_errors,
                "audit_flushes": self.flushes,
            }
