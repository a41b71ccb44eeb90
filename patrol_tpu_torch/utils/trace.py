"""patrol-scope flight recorder: per-thread ring buffers of ns-stamped
typed events, plus the cross-node take-span collector.

The reference's whole debug story is the pprof route set (api.go:29-39):
aggregate profiles, no *timeline*. The ingest wall (ROADMAP item 1) is
exactly the question aggregates cannot answer — where a delta spends its
time between the wire and the donated dispatch — so this module records
the pipeline's typed events (tick, staging lease/recycle, H2D put,
dispatch, completion, rx decode, fold, broadcast tx, anti-entropy
phases) into fixed-size per-thread rings:

* **Lock-free on the hot path.** Each ring has exactly one writer (its
  owning thread); recording is a handful of list stores behind a single
  ``if TRACE.enabled:`` branch at the call site — the disabled cost is
  one attribute load + branch, pinned by ``bench.py --smoke``'s
  ``trace_off_branch_ns`` micro-test and ``tests/test_trace.py``.
* **Bounded by construction.** ``PATROL_TRACE_RING`` events per thread
  (default 4096), oldest overwritten; a wedged consumer can never make
  the recorder grow.
* **Dumpable on demand** as Chrome-trace/Perfetto JSON via
  ``/debug/trace/ring`` (open in ``chrome://tracing`` or ui.perfetto.dev)
  and **auto-snapshotted on anomalies** — take stalls
  (``TakeTicket.wait`` timeout) and anti-entropy convergence-budget
  breaches call :func:`anomaly`, which freezes the rings into a bounded
  snapshot list served by ``/debug/trace/ring?snapshot=N``. Snapshots are
  damped to one per reason per second so a stall storm cannot turn the
  recorder into the bottleneck it is observing.

Cross-node take tracing (the span collector): a sampled take (1 in
``PATROL_TRACE_SAMPLE``; 0 disables) gets a process-unique trace id that
rides the replication datagram in a reserved trace trailer
(ops/wire.py) — invisible to v1 peers and to pre-trace patrol builds,
both of which ignore bytes past the trailers they know. The receiving
node stamps its decode and merge spans with the propagated id, so
``/debug/trace/spans?trace_id=N`` shows one take's full cross-node
story: local take span (node A) joined to the rx-decode and device-merge
spans (node B). Spans carry node slot + bucket name. The id rides the
python wire codec; the C++ batch encoder does not emit trace trailers
(native-backend broadcasts drop the id — tracing degrades, never
breaks).
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from patrol_tpu_torch.utils import profiling

# Event types (values are stable: they appear in dumps and snapshots).
EV_TICK = 1  # one engine tick's device work (arg = work rows)
EV_STAGING_LEASE = 2  # StagingPool.lease (arg = buffer elements)
EV_STAGING_RECYCLE = 3  # StagingPool.release
EV_H2D_PUT = 4  # host->device staging transfer shipped
EV_COMMIT_DISPATCH = 5  # donated kernel dispatch under _state_mu
EV_COMMIT_COMPLETE = 6  # completer-side result readback + fanout
EV_RX_DECODE = 7  # replication rx decode (arg = packets)
EV_FOLD = 8  # host-side tick fold (arg = deltas folded)
EV_BROADCAST_TX = 9  # replication broadcast fan-out (arg = datagrams)
EV_AE_PHASE = 10  # anti-entropy job (arg = phase code, see AE_PHASES)
EV_TAKE = 11  # one served take (sampled)
EV_ANOMALY = 12  # anomaly marker (snapshot trigger)
EV_DELTA_PACK = 13  # delta-plane flush: intervals packed (arg = datagrams)
EV_DELTA_ACK = 14  # delta ack vector sent/processed (arg = acks)
EV_DELTA_RETRANSMIT = 15  # expired intervals re-shipped (arg = intervals)
EV_DEVICE_READY = 16  # device dispatch→ready observed (arg = work rows)
EV_AUDIT_TICK = 17  # patrol-audit flush tick (arg = datagrams shipped)
EV_AUDIT_COMPARE = 18  # read-only divergence compare (arg = divergent buckets)
EV_TAKE_COALESCE = 19  # hot-key take-n rows in a tick (arg = tickets folded)

EVENT_NAMES = {
    EV_TICK: "engine.tick",
    EV_STAGING_LEASE: "staging.lease",
    EV_STAGING_RECYCLE: "staging.recycle",
    EV_H2D_PUT: "h2d.put",
    EV_COMMIT_DISPATCH: "commit.dispatch",
    EV_COMMIT_COMPLETE: "commit.complete",
    EV_RX_DECODE: "rx.decode",
    EV_FOLD: "fold",
    EV_BROADCAST_TX: "broadcast.tx",
    EV_AE_PHASE: "ae.phase",
    EV_TAKE: "take",
    EV_ANOMALY: "anomaly",
    EV_DELTA_PACK: "delta.pack",
    EV_DELTA_ACK: "delta.ack",
    EV_DELTA_RETRANSMIT: "delta.retransmit",
    EV_DEVICE_READY: "device.ready",
    EV_AUDIT_TICK: "audit.tick",
    EV_AUDIT_COMPARE: "audit.compare",
    EV_TAKE_COALESCE: "take.coalesce",
}

AE_PHASES = {"trigger": 1, "digest": 2, "fetch": 3}

RING_SIZE = max(64, int(os.environ.get("PATROL_TRACE_RING", 4096)))


class _Ring:
    """One thread's fixed-size event ring. Parallel plain lists, single
    writer (the owning thread); readers copy — a torn read corrupts at
    most the event being written, never the reader."""

    __slots__ = ("tid", "name", "size", "etype", "t_ns", "dur_ns", "arg", "pos", "count")

    def __init__(self, tid: int, name: str, size: int):
        self.tid = tid
        self.name = name
        self.size = size
        self.etype = [0] * size
        self.t_ns = [0] * size
        self.dur_ns = [0] * size
        self.arg = [0] * size
        self.pos = 0
        self.count = 0

    def events(self) -> List[tuple]:
        """Oldest-first copy of the live events (reader-side)."""
        et = list(self.etype)
        ts = list(self.t_ns)
        du = list(self.dur_ns)
        ar = list(self.arg)
        n = min(self.count, self.size)
        pos = self.pos
        out = []
        for k in range(n):
            i = (pos - n + k) % self.size
            if et[i]:
                out.append((et[i], ts[i], du[i], ar[i]))
        return out


class FlightRecorder:
    """The process-wide recorder. ``enabled`` is the single hot-path
    gate: call sites read it once and skip the record call entirely when
    off (``if TRACE.enabled: TRACE.record(...)``)."""

    def __init__(self, size: int = RING_SIZE):
        self.enabled = os.environ.get("PATROL_TRACE", "1") != "0"
        self.size = size
        self._tls = threading.local()
        self._reg_mu = threading.Lock()
        self._rings: List[_Ring] = []
        self._snap_mu = threading.Lock()
        self._snapshots: deque = deque(maxlen=4)
        self._last_anomaly: Dict[str, float] = {}

    def _ring(self) -> _Ring:
        ring = getattr(self._tls, "ring", None)
        if ring is None:
            t = threading.current_thread()
            ring = _Ring(t.ident or 0, t.name, self.size)
            self._tls.ring = ring
            with self._reg_mu:
                self._rings.append(ring)
        return ring

    def record(self, etype: int, dur_ns: int = 0, arg: int = 0) -> None:
        """Record one completed event on the calling thread's ring.
        Lock-free: this thread is the ring's only writer."""
        if not self.enabled:
            return
        ring = self._ring()
        i = ring.pos
        ring.etype[i] = etype
        ring.t_ns[i] = time.perf_counter_ns()
        ring.dur_ns[i] = dur_ns
        ring.arg[i] = arg
        ring.pos = (i + 1) % ring.size
        ring.count += 1

    # -- dump / snapshot -----------------------------------------------------

    def dump(self) -> List[dict]:
        """All rings' live events as plain dicts (oldest-first per ring)."""
        with self._reg_mu:
            rings = list(self._rings)
        out = []
        for ring in rings:
            for etype, t_ns, dur_ns, arg in ring.events():
                out.append(
                    {
                        "type": EVENT_NAMES.get(etype, str(etype)),
                        "t_ns": t_ns,
                        "dur_ns": dur_ns,
                        "arg": arg,
                        "tid": ring.tid,
                        "thread": ring.name,
                    }
                )
        return out

    def chrome_trace(self, events: Optional[List[dict]] = None) -> bytes:
        """Chrome-trace/Perfetto JSON ('X' complete events, µs scale)."""
        evs = self.dump() if events is None else events
        trace_events = [
            {
                "name": e["type"],
                "ph": "X",
                "ts": e["t_ns"] / 1000.0,
                "dur": e["dur_ns"] / 1000.0,
                "pid": os.getpid(),
                "tid": e["tid"],
                "args": {"arg": e["arg"], "thread": e["thread"]},
            }
            for e in evs
        ]
        return json.dumps(
            {"traceEvents": trace_events, "displayTimeUnit": "ms"}
        ).encode()

    def snapshot(self, reason: str) -> Optional[dict]:
        """Freeze the current rings under a reason tag (bounded, newest
        kept). Damped to one per reason per second — an anomaly storm
        must not turn the recorder into its own hot path."""
        now = time.monotonic()
        with self._snap_mu:
            if now - self._last_anomaly.get(reason, -1e9) < 1.0:
                return None
            self._last_anomaly[reason] = now
        snap = {
            "reason": reason,
            "at_ns": time.perf_counter_ns(),
            "events": self.dump(),
        }
        with self._snap_mu:
            self._snapshots.append(snap)
        profiling.COUNTERS.inc("trace_anomaly_snapshots")
        return snap

    def snapshots(self) -> List[dict]:
        with self._snap_mu:
            return list(self._snapshots)


TRACE = FlightRecorder()


def anomaly(reason: str) -> None:
    """Anomaly hook: mark the ring and auto-snapshot it (take stall,
    convergence-budget breach, engine tick failure)."""
    if TRACE.enabled:
        TRACE.record(EV_ANOMALY, 0, 0)
    TRACE.snapshot(reason)


# -- cross-node take spans ---------------------------------------------------


class SpanCollector:
    """Bounded collector of completed spans (local takes + remote
    decode/merge joined by the propagated trace id). One per process —
    in-process multi-node tests see both nodes' spans here, disambiguated
    by the ``node`` field."""

    def __init__(self, cap: int = 4096):
        self._mu = threading.Lock()
        self._spans: deque = deque(maxlen=cap)

    def add(
        self,
        trace_id: int,
        node: int,
        kind: str,
        bucket: str,
        t_ns: int,
        dur_ns: int,
    ) -> None:
        with self._mu:
            self._spans.append(
                {
                    "trace_id": trace_id,
                    "node": node,
                    "kind": kind,
                    "bucket": bucket,
                    "t_ns": t_ns,
                    "dur_ns": dur_ns,
                }
            )

    def export(self, trace_id: Optional[int] = None) -> List[dict]:
        with self._mu:
            spans = list(self._spans)
        if trace_id is not None:
            spans = [s for s in spans if s["trace_id"] == trace_id]
        return spans

    def clear(self) -> None:
        with self._mu:
            self._spans.clear()


SPANS = SpanCollector()

# Take sampling: 0 = off (default), N = every Nth take gets a trace id.
_take_sample = int(os.environ.get("PATROL_TRACE_SAMPLE", "0"))
_take_counter = itertools.count(1)
# Process tag keeps ids from colliding across real multi-process nodes;
# the monotone counter keeps them unique within one process (shared by
# every in-process node).
_ID_TAG = (os.getpid() & 0x7FFF) << 48


def set_take_sampling(n: int) -> None:
    """1-in-``n`` take sampling; 0 disables. Runtime-settable (tests,
    operator resync debugging)."""
    global _take_sample
    _take_sample = max(0, int(n))


def take_sampling() -> int:
    return _take_sample


def sample_take() -> Optional[int]:
    """Next take's trace id, or None when unsampled/off. Called once per
    ticket creation; the off path is one global read + branch."""
    n = _take_sample
    if not n:
        return None
    c = next(_take_counter)
    if c % n:
        return None
    profiling.COUNTERS.inc("trace_take_samples")
    return _ID_TAG | (c & 0xFFFFFFFFFFFF)
