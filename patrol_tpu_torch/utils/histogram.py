"""patrol-scope metrics plane: mergeable log-bucketed latency histograms
and the Prometheus text exposition behind ``/metrics``.

Aggregate counters (utils/profiling.py ``COUNTERS``) say *how much*; the
ingest-wall question (ROADMAP item 1) is *where time goes* — so the
pipeline's stages each feed a latency histogram: staging wait, H2D put,
kernel dispatch, completion, replication rx decode, the rx batch, and the
tick fold, plus take service time end-to-end, and the two queue times
only the program sees: a datagram's wait in the socket before the rx
thread picks it up, and an interval's ack held for the flush tick. Each
histogram's exact ``_sum`` and ``_count`` are on ``/metrics`` and
``/debug/vars``; the benchmark's per-layer readers take their means from
them (the log2 buckets are too coarse for quantiles).

**The lattice.** Buckets are powers of two (bucket *b* holds values with
``bit_length == b``, i.e. ``[2^(b-1), 2^b)``; bucket 0 holds 0), and each
bucket is a **G-Counter**: one monotone count lane per node, observed
value = lane sum, join = per-lane max. That is exactly the limiter
state's merge discipline (PN lanes under max/sum), so per-node histograms
combine associatively/commutatively/idempotently — node histograms can be
shipped and joined by an aggregator with the same convergence guarantees
as the bucket state itself. A process records into its own lane only;
the in-process fast path is one lock + two integer adds (the
CounterRegistry's own cost argument: call sites are per-take/per-tick,
kHz-class).

**Exposition.** :func:`render_exposition` produces real Prometheus text
format (``# TYPE`` lines, cumulative ``_bucket{le=...}`` /``_sum``/
``_count`` series) for ``/metrics`` on both HTTP fronts, replacing the
gauge-only dump.
"""

from __future__ import annotations

import re
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

# 64 log2 buckets cover the full non-negative int64 ns range.
NBUCKETS = 64


def bucket_of(value: int) -> int:
    """Log2 bucket index: bit_length, clamped. Bucket 0 holds value 0."""
    if value < 0:
        value = 0
    b = value.bit_length()
    return b if b < NBUCKETS else NBUCKETS - 1


class LatticeHistogram:
    """One named histogram: ``nodes`` G-Counter lanes per bucket plus a
    per-lane monotone value sum. ``record`` writes this process's lane;
    ``join`` max-merges another histogram's lanes in (idempotent,
    commutative, associative — the CRDT laws the tests pin)."""

    __slots__ = ("name", "unit", "nodes", "node_slot", "_mu", "_counts", "_sums")

    def __init__(self, name: str, nodes: int = 1, node_slot: int = 0, unit: str = "ns"):
        if not 0 <= node_slot < nodes:
            raise ValueError(f"node_slot {node_slot} outside {nodes} lanes")
        self.name = name
        self.unit = unit
        self.nodes = nodes
        self.node_slot = node_slot
        self._mu = threading.Lock()
        self._counts = [[0] * NBUCKETS for _ in range(nodes)]
        self._sums = [0] * nodes

    # -- hot path ------------------------------------------------------------

    def record(self, value: int) -> None:
        v = int(value)
        if v < 0:
            v = 0
        b = bucket_of(v)
        with self._mu:
            self._counts[self.node_slot][b] += 1
            self._sums[self.node_slot] += v

    def record_many(self, values: np.ndarray) -> None:
        """Record every value of an integer array under one lock (negative
        values count as 0)."""
        v = np.maximum(np.asarray(values, np.int64), 0)
        if not v.size:
            return
        # bit_length via the float exponent: exact below 2**53 ns (104 days).
        b = np.minimum(np.frexp(v.astype(np.float64))[1], NBUCKETS - 1)
        per = np.bincount(b, minlength=NBUCKETS)
        total = int(v.sum())
        with self._mu:
            lane = self._counts[self.node_slot]
            for i in np.flatnonzero(per).tolist():
                lane[i] += int(per[i])
            self._sums[self.node_slot] += total

    # -- lattice -------------------------------------------------------------

    def _grow(self, nodes: int) -> None:
        while len(self._counts) < nodes:
            self._counts.append([0] * NBUCKETS)
            self._sums.append(0)
        self.nodes = len(self._counts)

    def join(self, other: "LatticeHistogram") -> None:
        """Max-join ``other``'s lanes into this histogram (both sides may
        have recorded concurrently; lanes are monotone, so the join is
        exact for disjoint writers — the same single-writer-per-lane rule
        as the PN state)."""
        with other._mu:
            o_counts = [list(lane) for lane in other._counts]
            o_sums = list(other._sums)
        with self._mu:
            self._grow(len(o_counts))
            for lane, (mine, theirs) in enumerate(zip(self._counts, o_counts)):
                for b in range(NBUCKETS):
                    if mine[b] < theirs[b]:
                        mine[b] = theirs[b]
                if self._sums[lane] < o_sums[lane]:
                    self._sums[lane] = o_sums[lane]

    def to_lattice(self) -> dict:
        """Serializable lattice state (what a node would ship to an
        aggregator); :meth:`join_lattice` is its receiving half."""
        with self._mu:
            return {
                "name": self.name,
                "unit": self.unit,
                "counts": [list(lane) for lane in self._counts],
                "sums": list(self._sums),
            }

    def join_lattice(self, lattice: dict) -> None:
        o_counts = lattice["counts"]
        o_sums = lattice["sums"]
        with self._mu:
            self._grow(len(o_counts))
            for lane, theirs in enumerate(o_counts):
                mine = self._counts[lane]
                for b in range(min(NBUCKETS, len(theirs))):
                    if mine[b] < theirs[b]:
                        mine[b] = theirs[b]
                if self._sums[lane] < o_sums[lane]:
                    self._sums[lane] = o_sums[lane]

    # -- reading -------------------------------------------------------------

    def _merged_counts(self) -> List[int]:
        with self._mu:
            out = [0] * NBUCKETS
            for lane in self._counts:
                for b, c in enumerate(lane):
                    out[b] += c
            return out

    @property
    def count(self) -> int:
        return sum(self._merged_counts())

    @property
    def total(self) -> int:
        with self._mu:
            return sum(self._sums)

    def quantile(self, q: float) -> int:
        """Upper edge (2^b - 1) of the bucket holding quantile ``q``;
        0 for an empty histogram."""
        counts = self._merged_counts()
        n = sum(counts)
        if n == 0:
            return 0
        target = max(1, int(q * n + 0.999999))
        acc = 0
        for b, c in enumerate(counts):
            acc += c
            if acc >= target:
                return (1 << b) - 1
        return (1 << NBUCKETS) - 1

    def max_edge(self) -> int:
        """Upper edge of the highest non-empty bucket (≥ true max)."""
        counts = self._merged_counts()
        for b in range(NBUCKETS - 1, -1, -1):
            if counts[b]:
                return (1 << b) - 1
        return 0

    def summary(self) -> dict:
        n = self.count
        return {
            "count": n,
            "sum": self.total,
            "p50": self.quantile(0.50),
            "p99": self.quantile(0.99),
            "max": self.max_edge(),
            "unit": self.unit,
        }


class HistogramRegistry:
    """Process-wide named histograms (the /metrics + /debug/vars field
    set). ``get`` is idempotent; hot paths hold the returned object so
    recording never re-enters the registry lock."""

    def __init__(self):
        self._mu = threading.Lock()
        self._h: Dict[str, LatticeHistogram] = {}

    def get(self, name: str, unit: str = "ns") -> LatticeHistogram:
        with self._mu:
            h = self._h.get(name)
            if h is None:
                h = LatticeHistogram(name, unit=unit)
                self._h[name] = h
            return h

    def observe(self, name: str, value: int) -> None:
        self.get(name).record(value)

    def items(self) -> List[Tuple[str, LatticeHistogram]]:
        with self._mu:
            return sorted(self._h.items())

    def snapshot(self) -> Dict[str, dict]:
        """name → summary for every registered histogram (the
        /debug/vars ``histograms`` field), plus a reserved ``node`` key
        carrying this process's cluster identity (slot + configured
        name; :func:`set_node_identity`) so merged fleet views can
        attribute the lanes without guessing — no histogram can collide
        with it (stage/kernel names never equal ``node``)."""
        out: Dict[str, dict] = {"node": node_identity()}
        out.update({name: h.summary() for name, h in self.items()})
        return out


HISTOGRAMS = HistogramRegistry()

# Pre-created stage histograms: the hot paths record through these module
# attributes, never through a registry lookup.
STAGE_STAGING_WAIT = HISTOGRAMS.get("ingest_staging_wait_ns")
STAGE_H2D = HISTOGRAMS.get("ingest_h2d_ns")
STAGE_DISPATCH = HISTOGRAMS.get("ingest_dispatch_ns")
STAGE_COMPLETION = HISTOGRAMS.get("ingest_completion_ns")
STAGE_RX_DECODE = HISTOGRAMS.get("ingest_rx_decode_ns")
STAGE_FOLD = HISTOGRAMS.get("ingest_fold_ns")
TAKE_SERVICE = HISTOGRAMS.get("take_service_ns")
RX_APPLY = HISTOGRAMS.get("replication_rx_apply_ns")
# One rx batch of the native backend, from the recv's return to the end of
# its handling (net/native_replication.py); its sum over a window is the
# rx thread's busy time.
RX_BATCH = HISTOGRAMS.get("rx_batch_ns")
# Per such batch, the rx thread's wait in recv for its first datagram (a
# poll that times out empty is no batch): with rx_batch_ns, the rx
# thread's time while traffic arrives, split into work and wait.
RX_WAIT = HISTOGRAMS.get("rx_wait_ns")
# Per datagram, the native rx thread's pickup less the kernel's receive
# timestamp (SO_TIMESTAMP; both CLOCK_REALTIME): the socket queue.
DELTA_RX_QUEUE = HISTOGRAMS.get("delta_rx_queue_ns")
# Per acknowledged interval seq, from the pickup of the datagram that
# carried it to the flush handing the ack's datagram to the socket
# (net/delta.py): the node's own share of an ack's latency.
DELTA_ACK_HOLD = HISTOGRAMS.get("delta_ack_hold_ns")
# One delta flush tick (net/delta.py DeltaPlane.flush), whole: every
# peer's datagrams built under DeltaPlane._mu, then their sends.
DELTA_FLUSH = HISTOGRAMS.get("delta_flush_ns")
# Per rx batch, the rx thread's wait to take DeltaPlane._mu for the
# batch's ack bookkeeping (net/delta.py _ingest_walk): what the flush and
# the other takers of the lock cost the receive path.
DELTA_MU_WAIT = HISTOGRAMS.get("delta_mu_wait_ns")
# Datagram planes per raw decode+fold launch (runtime/engine.py
# ingest_raw_planes): 1 on the asyncio backend, up to the rx ring's
# batch (512) on the native one.
RAW_PLANES = HISTOGRAMS.get("ingest_raw_planes", unit="planes")
# Per raw decode+fold launch, its directory pass: the hashed lookup of
# every entry's name and the binding of the names it misses.
INGEST_DIRECTORY = HISTOGRAMS.get("ingest_directory_ns")
AE_JOB = HISTOGRAMS.get("ae_job_ns")
FRONT_WAIT = HISTOGRAMS.get("http_front_wait_ns")
# Device-side stage histograms (patrol-fleet, ROADMAP item 1's r06
# capture): dispatch→ready wall time of the engine's commit and take
# kernels, measured on the completion pipeline (block_until_ready /
# result-readback deltas in runtime/engine.py).
STAGE_DEVICE_COMMIT = HISTOGRAMS.get("device_commit_ns")
STAGE_DEVICE_TAKE = HISTOGRAMS.get("device_take_ns")
# Bucket-lifecycle sweep duration (idle-bucket GC, runtime/engine.py
# gc_sweep): candidate selection + IsZero probe + reclaim, end to end.
# Not an ingest/device stage column — the sweep is a maintenance path,
# so it must not gate the smoke's every-stage-has-samples assertion.
GC_SWEEP = HISTOGRAMS.get("gc_sweep_ns")
# patrol-audit (net/audit.py): per-peer replication lag (oldest unacked
# delta interval's age, one sample per delta-exchanging peer per audit
# tick) and per-bucket staleness (ns the last local emission ran ahead
# of the last remote absorb). Both are G-Counter lattices like every
# histogram here, so the fleet gossip merges them cluster-wide for free.
AUDIT_PEER_LAG = HISTOGRAMS.get("audit_peer_lag_ns")
AUDIT_STALENESS = HISTOGRAMS.get("audit_bucket_staleness_ns")

# The per-stage attribution set the SLO sentinel (utils/slo.py) watches.
INGEST_STAGES = (
    "ingest_staging_wait_ns",
    "ingest_h2d_ns",
    "ingest_dispatch_ns",
    "ingest_completion_ns",
    "ingest_rx_decode_ns",
    "ingest_fold_ns",
)

# Device-side columns of the same breakdown (the r06 capture evidence:
# what the DEVICE spent, not what the host waited).
DEVICE_STAGES = (
    "device_commit_ns",
    "device_take_ns",
)

# Per-kernel device-duration histograms (``device_kernel_<name>_ns``):
# one per dispatched kernel family, created on first dispatch and cached
# here so hot paths never re-enter the registry lock per tick.
_kernel_mu = threading.Lock()
_kernel_hists: Dict[str, LatticeHistogram] = {}


def kernel_histogram(kernel: str) -> LatticeHistogram:
    h = _kernel_hists.get(kernel)
    if h is None:
        with _kernel_mu:
            h = _kernel_hists.get(kernel)
            if h is None:
                h = HISTOGRAMS.get(f"device_kernel_{kernel}_ns")
                _kernel_hists[kernel] = h
    return h


# -- node identity (patrol-fleet lane attribution) ---------------------------

_node_identity = {"slot": 0, "name": ""}


def set_node_identity(slot: int, name: str) -> None:
    """Declare this process's cluster identity (node slot + configured
    name). Carried by the ``/debug/vars`` histogram summaries and the
    metrics gossip so merged fleet views attribute lanes without
    guessing. Settable once at startup (command.py)."""
    _node_identity["slot"] = int(slot)
    _node_identity["name"] = str(name)


def node_identity() -> dict:
    return dict(_node_identity)


# -- Prometheus text exposition ----------------------------------------------

_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


def _metric_name(key: str) -> Optional[str]:
    name = "patrol_" + key
    return name if _NAME_OK.match(name) else None


def render_exposition(
    stats: dict,
    registry: HistogramRegistry = HISTOGRAMS,
    uptime_s: Optional[float] = None,
) -> str:
    """Prometheus text exposition (format 0.0.4): every numeric stat as a
    gauge, every registered histogram as a real cumulative histogram
    (only non-empty buckets below the top occupied edge are emitted —
    64 log2 buckets would otherwise dominate the scrape)."""
    lines: List[str] = []
    for key in sorted(stats):
        val = stats[key]
        if isinstance(val, bool) or not isinstance(val, (int, float)):
            continue
        name = _metric_name(key)
        if name is None:
            continue
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {val}")
    for hname, h in registry.items():
        name = _metric_name(hname)
        if name is None:
            continue
        counts = h._merged_counts()
        total = h.total
        n = sum(counts)
        lines.append(f"# TYPE {name} histogram")
        acc = 0
        top = max((b for b, c in enumerate(counts) if c), default=-1)
        for b in range(top + 1):
            acc += counts[b]
            lines.append(f'{name}_bucket{{le="{(1 << b) - 1}"}} {acc}')
        lines.append(f'{name}_bucket{{le="+Inf"}} {n}')
        lines.append(f"{name}_sum {total}")
        lines.append(f"{name}_count {n}")
    if uptime_s is not None:
        lines.append("# TYPE patrol_uptime_seconds gauge")
        lines.append(f"patrol_uptime_seconds {uptime_s:.3f}")
    return "\n".join(lines) + "\n"


# -- fleet exposition (GET /cluster/metrics) ---------------------------------

_LABEL_SAFE = re.compile(r"[^0-9A-Za-z_.:\-]")


def _label_value(raw: str) -> str:
    """Sanitized label value: the exposition's label grammar is read
    without escape sequences, so identity labels are reduced to a safe
    subset."""
    return _LABEL_SAFE.sub("_", raw)[:64]


def render_fleet_exposition(store) -> str:
    """Prometheus text exposition of a :class:`patrol_tpu_torch.net.fleet.
    FleetStore`: every gossiped counter lane as a ``node``-labeled gauge
    and every histogram lane as a ``node``-labeled cumulative histogram.
    Only non-empty lanes are emitted."""
    lines: List[str] = []
    snap = store.lattice_snapshot()
    node_names = snap["node_names"]

    def node_label(slot: int) -> str:
        nm = node_names.get(slot)
        if nm:
            return f'node="{slot}",node_name="{_label_value(nm)}"'
        return f'node="{slot}"'

    if node_names:
        lines.append("# TYPE patrol_cluster_node_info gauge")
        for slot in sorted(node_names):
            lines.append(f"patrol_cluster_node_info{{{node_label(slot)}}} 1")
    for cname in sorted(snap["counters"]):
        name = _metric_name("cluster_" + cname)
        if name is None:
            continue
        lines.append(f"# TYPE {name} gauge")
        for slot in sorted(snap["counters"][cname]):
            val = snap["counters"][cname][slot]
            lines.append(f"{name}{{{node_label(slot)}}} {val}")
    for hname in sorted(snap["hists"]):
        name = _metric_name("cluster_" + hname)
        if name is None:
            continue
        lanes = snap["hists"][hname]
        emitted_type = False
        for slot in sorted(lanes):
            counts, total = lanes[slot]
            n = sum(counts)
            if n == 0:
                continue
            if not emitted_type:
                lines.append(f"# TYPE {name} histogram")
                emitted_type = True
            lbl = node_label(slot)
            acc = 0
            top = max((b for b, c in enumerate(counts) if c), default=-1)
            for b in range(top + 1):
                acc += counts[b]
                lines.append(
                    f'{name}_bucket{{{lbl},le="{(1 << b) - 1}"}} {acc}'
                )
            lines.append(f'{name}_bucket{{{lbl},le="+Inf"}} {n}')
            lines.append(f"{name}_sum{{{lbl}}} {total}")
            lines.append(f"{name}_count{{{lbl}}} {n}")
    return "\n".join(lines) + "\n"
