"""Device engine: the microbatching feeder between concurrent host callers
and single-device kernel launches (counterpart of the DEVICE PATH of
``patrol_tpu/runtime/engine.py``).

All mutation of limiter state happens on one feeder thread that drains two
queues — take tickets and replication deltas — into kernel launches:

    submit_take()/ingest_delta()  →  queues  →  feeder tick:
        join kernel (merge_batch / folded / row-dense / commit ring)
        take-n kernel (one packed [8, K] request matrix)
    completion pipeline (completer thread):
        wait for the tick's results, complete tickets, emit broadcasts

Wire-v2 replication ingests on the receiving thread instead:
:meth:`DeviceEngine.ingest_raw_planes` launches the decode+fold kernel on
raw datagram byte planes (a batch of up to 512 from the native rx ring,
shipped straight from its page-locked plane), and
:meth:`DeviceEngine.ingest_interval` one join of a decoded interval. The
native rx loop queues classic datagrams through
:meth:`DeviceEngine.ingest_wire_batch` (one C++ classify pass over the
decoded batch). Every launch of the engine, from any thread,
goes to the device's default stream, so launches that mutate state run in
the order they were issued (under ``_state_mu``); a row recycled by
eviction is zeroed behind any fold already queued for it.

The feeder never synchronises with the device (but for the one gather of
an idle demotion, see below). Each take tick enqueues
ONE non-blocking device→host copy of its ``[7, K]`` result matrix into
pinned memory right behind the kernel and records a CUDA event; the
completer waits on that event, reads the results and fans them out, so
host-side completion overlaps the next tick's device work. Host→device
operands are staged in pinned buffers (:class:`StagingPool`) and shipped
with non-blocking copies; a buffer is leased again only once a CUDA event
shows its copy has finished. Device state is updated in place by the
kernels (where the JAX engine donated buffers).

Hot buckets are coalesced algebraically (see ops/take.py): identical
(bucket, rate, count) tickets become one kernel row with ``nreq``; a
bucket appearing with a different rate/count in the same tick is deferred
one tick to preserve the unique-rows kernel invariant.

The tick fold runs in C++ (``pt_fold_hybrid``) for large clustered
batches and in numpy otherwise (:func:`fold_hybrid`).

Host fast path (``HOST_FASTPATH``, on unless ``PATROL_HOST_FASTPATH=0``):
a fresh or host-resident bucket is served in-process from its
:class:`HostLanes` (numpy and integer arithmetic, step for step the
take-n kernel), with no launch at all. Rx deltas for a hosted row
max-join into its lanes (on the raw path, driven by the ``decode_fold``
kernel's ``hosted_mask``). A bucket past ``HOST_PROMOTE_TAKES`` takes or
absorbed rx deltas per window, or hit by a scalar (v1) delta, is promoted:
the feeder joins its lanes into the device planes through the join
kernel before the same tick's take-n launch. A promoted row that stays
quiet for a demote window moves back (one gather seeds its lanes, then
its device row is zeroed). With ``native_host=True`` the lanes live in
the C++ store of ``runtime/hoststore.py``, which the native HTTP front
serves takes from without entering Python.

Bucket lifecycle (on by default, ``GC_WINDOW_NS``): the feeder tick
sweeps full, idle buckets at the GC window's cadence. Device-resident
candidates go through one launch of the lifecycle probe kernel
(ops/lifecycle.py), host-resident ones through its numpy twin; a
reclaimed bucket leaves the device plane, the host lanes and the
directory, and its own lane goes into a directory tombstone that
re-seeds the row when the name is bound again, on every entry point.
Under a memory budget (``MAX_BUCKETS``, ``STATE_BYTES_BUDGET``) sweeps
run eight times as often past the soft watermark, and new names are shed
with :class:`OverloadedError` at the hard one.

The certified families (:meth:`DeviceEngine.gcra_take`,
:meth:`~DeviceEngine.conc_acquire`, :meth:`~DeviceEngine.quota_take`) are
synchronous microbatch entry points on the caller's thread: one packed
request shipped in one copy, the family's one launch under
``_state_mu`` on the same stream as the feeder's ticks, one readback.

Scrape mirror (``SCRAPE_MIRROR``): the stats and debug reads
(``row_view``, ``snapshot``, ``snapshot_many``, ``tokens_if_known``) of
device rows answer from a host copy of the low row window, stamped with
the ``(_ticks, _state_gen)`` epoch it reflects and exact while that epoch
holds. Every device-state write bumps one of the two: a tick, ingest or
promotion launch bumps ``_ticks``; a row zeroed (eviction, GC reclaim,
demotion, ``release_bucket``), a family call and a checkpoint restore
bump ``_state_gen``.
"""

from __future__ import annotations

import logging
import math
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from patrol_tpu_torch.models.limiter import (
    NANO,
    LimiterConfig,
    LimiterState,
    init_state,
    resolve_device,
    state_to_numpy,
)
from patrol_tpu_torch.ops import _build
from patrol_tpu_torch.ops import cert_kernel
from patrol_tpu_torch.ops import commit as commit_mod
from patrol_tpu_torch.ops import concurrency as conc_ops
from patrol_tpu_torch.ops import delta as delta_ops
from patrol_tpu_torch.ops import gcra as gcra_ops
from patrol_tpu_torch.ops import hierquota as quota_ops
from patrol_tpu_torch.ops import ingest as ingest_ops
from patrol_tpu_torch.ops import ingest_kernel
from patrol_tpu_torch.ops import join_kernel
from patrol_tpu_torch.ops import lifecycle as lifecycle_ops
from patrol_tpu_torch.ops import lifecycle_kernel
from patrol_tpu_torch.ops import merge as merge_mod
from patrol_tpu_torch.ops import wire
from patrol_tpu_torch.ops.merge import MergeBatch, merge_batch, merge_scalar_batch
from patrol_tpu_torch.ops.rate import Rate
from patrol_tpu_torch.ops.take import (
    TAKE_PACK_ROWS,
    TAKE_RESULT_ROWS,
    remaining_for_request,
    split_grant,
    take_n_batch,
)
from patrol_tpu_torch.runtime.bucket import ClockFn, system_clock
from patrol_tpu_torch.runtime.directory import (
    BucketDirectory,
    DirectoryFullError,
    OverloadedError,
)
from patrol_tpu_torch.utils import histogram as hist
from patrol_tpu_torch.utils import profiling
from patrol_tpu_torch.utils import slo as slo_mod
from patrol_tpu_torch.utils import trace as trace_mod

log = logging.getLogger("patrol.engine")

# Per-tick caps: at most this many take rows / merge rows per device call;
# the rest stays queued for the next tick (the loop runs back-to-back).
MAX_TAKE_ROWS = 4096


def _take_fold_enabled() -> bool:
    """Hot-key take coalescing (rx-side fold): same-(row, rate, count)
    takes fold into ONE queue entry at submit time. Read at call time so a
    per-ticket replay can flip it without forking the engine; "0" also
    makes _group_tickets serve one ticket per row per tick — the
    pre-coalescing reference path."""
    return os.environ.get("PATROL_TAKE_FOLD", "1") != "0"


# Merge rows per engine tick (one join block).
MAX_MERGE_ROWS = int(os.environ.get("PATROL_MAX_MERGE_ROWS", 8192))
# Device-commit pipeline: how many MAX_MERGE_ROWS blocks one tick may drain
# and fold into a SINGLE commit launch (ops/commit.py). ``auto`` (default)
# sizes the drain per tick from the queue backlog, capped by the measured
# per-row device-commit cost; a number pins it.
_COMMIT_BLOCKS_ENV = os.environ.get("PATROL_COMMIT_BLOCKS", "auto")
COMMIT_BLOCKS_AUTO = _COMMIT_BLOCKS_ENV.strip().lower() == "auto"
COMMIT_BLOCKS = 4 if COMMIT_BLOCKS_AUTO else max(1, int(_COMMIT_BLOCKS_ENV))
COMMIT_BLOCKS_MAX = max(1, int(os.environ.get("PATROL_COMMIT_BLOCKS_MAX", 8)))
COMMIT_BUDGET_NS = int(float(os.environ.get("PATROL_COMMIT_BUDGET_MS", 50)) * 1e6)
# In-flight device ticks the feeder may dispatch ahead of the completer.
DISPATCH_AHEAD = max(2, int(os.environ.get("PATROL_DISPATCH_AHEAD", 8)))
# Device-commit timing on the completion pipeline (device_commit_ns,
# device_take_ns and per-kernel histograms).
DEVICE_TIMING = os.environ.get("PATROL_DEVICE_TIMING", "1") != "0"
# patrol-audit (net/audit.py): the admitted-token audit window. 0 = manual
# windows (tests close them via roll(force=True)).
AUDIT_WINDOW_NS = int(float(os.environ.get("PATROL_AUDIT_WINDOW_MS", 5000)) * 1e6)

# Host fast path: serve cold and low-QPS buckets from an in-process lane
# model (HostLanes), with no device launch, and promote a bucket to the
# device path when it gets hot. Module globals, read at call time, so
# tests monkeypatch them.
HOST_FASTPATH = os.environ.get("PATROL_HOST_FASTPATH", "1") != "0"
# Promote when a bucket sees more than this many host takes (or absorbed
# rx deltas) inside one window: below that rate one bucket's takes are
# cheaper in-process than through a device tick.
HOST_PROMOTE_TAKES = int(os.environ.get("PATROL_HOST_PROMOTE_TAKES", 4096))
HOST_PROMOTE_WINDOW_NS = int(
    float(os.environ.get("PATROL_HOST_PROMOTE_WINDOW_MS", 100)) * 1e6
)
# Idle demotion: a promoted bucket whose device-path takes fall below this
# count per demote window moves back to host residency (exact: gather the
# row, seed host lanes, zero the device row). The demote rate sits ~8x
# below the promote rate (a quarter of the takes over twice the window),
# so residency cannot flap on a steady workload.
HOST_DEMOTE_TAKES = int(
    os.environ.get("PATROL_HOST_DEMOTE_TAKES", max(HOST_PROMOTE_TAKES // 4, 1))
)
HOST_DEMOTE_WINDOW_NS = int(
    float(os.environ.get("PATROL_HOST_DEMOTE_WINDOW_MS", 200)) * 1e6
)

# Scrape mirror: a host copy of the low row window for the stats and debug
# reads, exact while the (_ticks, _state_gen) epoch it is stamped with
# holds, so a scrape of unchanged state costs no device gather. A stale
# scrape re-arms it with one window gather; rows past the window (or with
# the mirror off) are gathered one call each.
SCRAPE_MIRROR = os.environ.get("PATROL_SCRAPE_MIRROR", "1") != "0"
SCRAPE_MIRROR_ROWS = int(os.environ.get("PATROL_SCRAPE_MIRROR_ROWS", 4096))

# Bucket lifecycle: idle-bucket GC on the feeder tick. A bound bucket whose
# reconstructed balance reaches its capacity (the IsZero predicate,
# ops/lifecycle.py) is reclaimed from the device plane, the host lanes and
# the directory. 0 turns the feeder's cadence off (gc_sweep() still runs
# when called). Module globals, read when an engine is built; an engine
# keeps its own copies (configure_lifecycle).
GC_WINDOW_NS = int(float(os.environ.get("PATROL_GC_WINDOW_MS", 500)) * 1e6)
# Buckets untouched this long are candidates at zero budget pressure;
# pressure (and a forced sweep) drops the idleness requirement: the
# predicate alone makes a reclaim safe, idleness keeps sweeps off warm rows.
GC_IDLE_NS = int(float(os.environ.get("PATROL_GC_IDLE_MS", 1000)) * 1e6)
# Candidates probed per sweep (one padded launch).
GC_SWEEP_MAX = int(os.environ.get("PATROL_GC_SWEEP_MAX", 8192))
# Memory budget: bound buckets and/or bytes (0: unenforced). Past the soft
# watermark (GC_SOFT_FRAC of a budget) sweeps ignore idleness and run at
# window/8; at the hard one new names are shed with OverloadedError (HTTP
# 429 "overloaded") instead of growing state.
MAX_BUCKETS = int(os.environ.get("PATROL_MAX_BUCKETS", 0))
STATE_BYTES_BUDGET = int(os.environ.get("PATROL_STATE_BYTES_BUDGET", 0))
GC_SOFT_FRAC = float(os.environ.get("PATROL_GC_SOFT_FRAC", 0.85))

# Host-side directory bytes attributed to one bound row (name bytes and
# the per-row columns): the byte budget's row class.
_ROW_HOST_BYTES = 256 + 64

BroadcastFn = Callable[[List[wire.WireState]], None]


class StagingPool:
    """(dtype, shape)-bucketed reusable host staging tensors for packed
    device operands and result readbacks (int64 matrices, uint8 datagram
    planes) — pinned memory when the engine runs on CUDA, so copies in
    both directions are truly asynchronous.

    ``release(buf, event)`` returns a buffer together with the CUDA event
    recorded after the copy that reads it; ``lease`` hands out only
    buffers whose event has completed (``event.query()``), else allocates
    a fresh one — the feeder never waits on the device here. Bounded per
    shape so a burst can't pin unbounded host memory."""

    __slots__ = ("_free", "_mu", "_max_per_shape", "_pin")

    def __init__(self, pin: bool, max_per_shape: int = 8):
        self._free: Dict[tuple, list] = {}
        self._mu = threading.Lock()
        self._max_per_shape = max_per_shape
        self._pin = pin

    def lease(self, shape, dtype: torch.dtype = torch.int64) -> torch.Tensor:
        t0 = time.perf_counter_ns()
        key = (dtype, *shape)
        buf = None
        with self._mu:
            stack = self._free.get(key)
            if stack:
                for i in range(len(stack) - 1, -1, -1):
                    cand, ev = stack[i]
                    if ev is None or ev.query():
                        buf = cand
                        del stack[i]
                        break
        if buf is not None:
            profiling.COUNTERS.inc("staging_reuse_hits")
        else:
            profiling.COUNTERS.inc("staging_leases_fresh")
            buf = torch.empty(tuple(shape), dtype=dtype, pin_memory=self._pin)
        dur = time.perf_counter_ns() - t0
        hist.STAGE_STAGING_WAIT.record(dur)
        tr = trace_mod.TRACE
        if tr.enabled:
            tr.record(trace_mod.EV_STAGING_LEASE, dur, buf.numel())
        return buf

    def release(self, buf: torch.Tensor, event=None) -> None:
        with self._mu:
            stack = self._free.setdefault((buf.dtype, *buf.shape), [])
            if len(stack) < self._max_per_shape:
                stack.append((buf, event))
        tr = trace_mod.TRACE
        if tr.enabled:
            tr.record(trace_mod.EV_STAGING_RECYCLE, 0, buf.numel())


class AuditLedger:
    """Own-lane half of the AP-overshoot auditor: a windowed per-bucket
    admitted-token G-counter. Each admitted take books its nanotokens
    under the CURRENT window id; a window's per-bucket totals are monotone
    within the window, so they gossip as join-decompositions exactly like
    the metrics lattices (net/fleet.py) — receivers max-join per (window,
    bucket, lane). Window ids are engine-clock derived (``clock //
    window_ns``), so clock-synced nodes agree on attribution; with
    ``window_ns == 0`` windows only close via ``roll(force=True)`` and the
    id is a lockstep epoch counter (the deterministic test/bench mode).

    Alongside the admitted count the ledger keeps each bucket's limit
    view: capacity base plus the rate-derived refill over the window's
    observed span — the ``limit × 1`` denominator of the overshoot
    factor. Thread-safe; one leaf lock, never held across other locks."""

    def __init__(self, window_ns: int = 0):
        self._mu = threading.Lock()
        self.window_ns = window_ns
        self._window = 0
        self._start_ns: Optional[int] = None
        # name -> [admitted_nt, cap_nt(max), per_ns(max)] for the open window.
        self._cur: Dict[str, list] = {}
        self._closed: deque = deque(maxlen=4)
        self.windows_closed = 0

    def _clock_window(self, now: int) -> int:
        return now // self.window_ns if self.window_ns > 0 else self._window

    def _close_locked(self, now: int, next_window: int) -> None:
        start = self._start_ns if self._start_ns is not None else now
        dur = max(0, now - start)
        if self._cur:
            lanes = {
                name: (
                    v[0],
                    # limit×1: capacity base + refill over the window span.
                    v[1] + (v[1] * dur // v[2] if v[2] > 0 else 0),
                )
                for name, v in self._cur.items()
            }
            self._closed.append((self._window, dur, lanes))
            self.windows_closed += 1
        self._cur = {}
        self._window = next_window
        self._start_ns = now

    def note(
        self, name: str, admitted_nt: int, cap_nt: int, per_ns: int, now: int
    ) -> None:
        """Book one admitted take into the open window (self-rolling on
        clock-derived window ids)."""
        if admitted_nt <= 0:
            return
        with self._mu:
            if self._start_ns is None:
                self._start_ns = now
                self._window = self._clock_window(now)
            elif self.window_ns > 0:
                w = self._clock_window(now)
                if w > self._window:
                    self._close_locked(now, w)
            ent = self._cur.get(name)
            if ent is None:
                self._cur[name] = [admitted_nt, max(cap_nt, 0), max(per_ns, 0)]
            else:
                ent[0] += admitted_nt
                ent[1] = max(ent[1], cap_nt)
                ent[2] = max(ent[2], per_ns)

    def roll(self, now: int, force: bool = False) -> None:
        """Close the open window when its span lapsed (or ``force``)."""
        with self._mu:
            if self._start_ns is None:
                self._start_ns = now
                self._window = self._clock_window(now)
                return
            if force:
                self._close_locked(now, self._window + 1)
            elif self.window_ns > 0:
                w = self._clock_window(now)
                if w > self._window:
                    self._close_locked(now, w)

    def export(self):
        """→ (current window id, closed windows) where each closed window
        is ``(window_id, duration_ns, {name: (admitted_nt, limit_nt)})``
        and the OPEN window rides along too (monotone — shipping partial
        progress is join-safe). The open window's limit uses the span so
        far."""
        with self._mu:
            out = list(self._closed)
            if self._cur and self._start_ns is not None:
                # The open window's partial view (duration so far unknown
                # to a frozen clock ⇒ 0 refill, conservative).
                out.append(
                    (
                        self._window,
                        0,
                        {
                            name: (v[0], v[1])
                            for name, v in self._cur.items()
                        },
                    )
                )
            return self._window, out


class HostLanes:
    """Host-resident PN lanes of one bucket row: the fast-path twin of one
    row of ``LimiterState`` (int64 nanotoken lanes and the elapsed
    G-counter), plus the promotion window's counters. All mutation happens
    under the engine's ``_host_mu``.

    :meth:`take` is the take-n kernel's step for one row with ``nreq=1``,
    step for step: lazy capacity base, monotonic-time guard, float64
    refill grant, floor, capacity clamp (possibly negative, booked as a
    forfeit), conditional commit. So a bucket answers the same whether it
    is served here or on the device, and the promotion join (lanes are
    monotone, max-merged) is exact."""

    __slots__ = (
        "added", "taken", "elapsed_ns", "win_start_ns", "win_takes", "win_rx"
    )

    def __init__(self, nodes: int):
        self.added = np.zeros(nodes, np.int64)
        self.taken = np.zeros(nodes, np.int64)
        self.elapsed_ns = 0
        self.win_start_ns = 0
        self.win_takes = 0
        self.win_rx = 0  # rx deltas absorbed this window (promotion signal)

    def roll_window(self, now_ns: int) -> None:
        """Reset the promotion window when it lapsed. Both counters roll
        together: an rx count that survived take-window rolls would count
        one peer echo per take and promote every replicated bucket after
        HOST_PROMOTE_TAKES takes in total, at any rate."""
        if now_ns - self.win_start_ns > HOST_PROMOTE_WINDOW_NS:
            self.win_start_ns = now_ns
            self.win_takes = 0
            self.win_rx = 0

    def take(
        self,
        cap_base_nt: int,
        created_ns: int,
        now_ns: int,
        rate: Rate,
        count: int,
        node_slot: int,
    ) -> Tuple[int, bool]:
        """One take; → (remaining_tokens, ok), as take-n with nreq=1."""
        cap_now_nt = rate.freq * NANO
        sum_a = int(self.added.sum())
        sum_t = int(self.taken.sum())
        tokens_nt = cap_base_nt + sum_a - sum_t

        last = min(created_ns + self.elapsed_ns, now_ns)
        delta = now_ns - last

        interval = rate.per_ns // rate.freq if rate.freq else 0
        if rate.freq == 0 or rate.per_ns == 0 or interval == 0:
            grant_nt = 0
        else:
            # float64(delta)/float64(interval) tokens, then x1e9, floored:
            # the kernel's expression in the kernel's order.
            grant_f = (float(delta) / float(interval)) * float(NANO)
            grant_nt = math.floor(min(max(grant_f, 0.0), float(2**62)))
        grant_nt = min(grant_nt, cap_now_nt - tokens_nt)

        have_nt = tokens_nt + grant_nt
        count_nt = count * NANO
        if count_nt > 0:
            k = min(max(have_nt // count_nt, 0), 1)
        else:
            k = 0
        if k >= 1:
            forfeit = max(-grant_nt, 0)
            self.added[node_slot] += max(grant_nt, 0)
            self.taken[node_slot] += count_nt + forfeit
            self.elapsed_ns += delta
        return remaining_for_request(have_nt, k, count_nt, 0)


class TakeTicket:
    """One pending take request. Completion is observable both from threads
    (:meth:`wait`) and event loops (:meth:`add_done_callback`), so the
    asyncio HTTP front never blocks on the engine thread."""

    __slots__ = (
        "name",
        "row",
        "rate",
        "count",
        "now_ns",
        "_event",
        "_mu",
        "_callbacks",
        "remaining",
        "ok",
        "deferred",
        "shed",
        "t0_ns",
        "trace_id",
    )

    def __init__(self, name: str, row: int, rate: Rate, count: int, now_ns: int):
        self.name = name
        self.row = row
        self.rate = rate
        self.count = count
        self.now_ns = now_ns
        self._event = threading.Event()
        self._mu = threading.Lock()
        self._callbacks: List[Callable[[], None]] = []
        self.remaining: int = 0
        self.ok: bool = False
        # True while re-queued by _group_tickets (rate-key conflict): such a
        # ticket is still live in the queue — failure paths must not
        # complete/unpin it (engine thread only; no lock needed).
        self.deferred = False
        # Overload shed marker read by the multi-take HTTP front; this
        # package has no memory budget yet, so it stays False.
        self.shed = False
        # Service-latency stamp (take_service_ns histogram) and the
        # sampled cross-node trace id (None when unsampled).
        self.t0_ns = time.perf_counter_ns()
        self.trace_id = trace_mod.sample_take()

    def complete(self, remaining: int, ok: bool) -> bool:
        """Returns True on the first completion (False if already done) —
        the engine unpins the ticket's directory row exactly on that
        transition."""
        with self._mu:
            if self._event.is_set():
                return False
            self.remaining = remaining
            self.ok = ok
            self._event.set()
            callbacks, self._callbacks = self._callbacks, []
        for cb in callbacks:
            cb()
        return True

    def add_done_callback(self, cb: Callable[[], None]) -> None:
        """Invoke ``cb`` once completed (immediately if already done).
        ``cb`` must be thread-safe — it runs on the engine thread."""
        with self._mu:
            if not self._event.is_set():
                self._callbacks.append(cb)
                return
        cb()

    def wait(self, timeout: Optional[float] = None) -> bool:
        ok = self._event.wait(timeout)
        if not ok:
            trace_mod.anomaly("take-stall")
        return ok


class _TakeFold:
    """One coalesced take-queue entry: every ticket with the same
    (row, freq, per_ns, count) key that arrived while the entry waited
    for a tick, in arrival order. The feeder's drain counts ENTRIES
    (future packed rows), so a hot-key flood costs one row of the
    per-tick budget; the grant still splits FIFO per ticket. Created and
    appended-to only under the work condvar's lock."""

    __slots__ = ("key", "tickets")

    def __init__(self, key: tuple, first: TakeTicket):
        self.key = key
        self.tickets = [first]


class _Delta:
    __slots__ = (
        "row", "slot", "added_nt", "taken_nt", "elapsed_ns", "scalar",
        "trace_id", "trace_name",
    )

    def __init__(
        self,
        row: int,
        slot: int,
        added_nt: int,
        taken_nt: int,
        elapsed_ns: int,
        scalar: bool = False,
    ):
        self.trace_id = None
        self.trace_name = None
        self.row = row
        self.slot = slot
        # Ingest clamp: device state is non-negative by invariant; hostile or
        # corrupt packets must not be able to poison the max-merge.
        self.added_nt = max(added_nt, 0)
        self.taken_nt = max(taken_nt, 0)
        self.elapsed_ns = max(elapsed_ns, 0)
        # True ⇒ from a scalar-semantics (reference) peer: goes through the
        # deficit-attribution merge (merge_scalar_batch).
        self.scalar = scalar


class _DeltaChunk:
    """A pre-vectorized batch of deltas: parallel int64 numpy arrays,
    already clamped non-negative and slot-validated, plus a per-delta
    scalar-semantics flag."""

    __slots__ = ("rows", "slots", "added_nt", "taken_nt", "elapsed_ns", "scalar", "n")

    def __init__(self, rows, slots, added_nt, taken_nt, elapsed_ns, scalar=None):
        self.rows = rows
        self.slots = slots
        self.added_nt = added_nt
        self.taken_nt = taken_nt
        self.elapsed_ns = elapsed_ns
        self.scalar = (
            scalar if scalar is not None else np.zeros(len(rows), dtype=bool)
        )
        self.n = len(rows)


class DeltaArrays(NamedTuple):
    """One tick's drained replication deltas, in arrival order, as flat
    numpy arrays."""

    rows: np.ndarray
    slots: np.ndarray
    added_nt: np.ndarray
    taken_nt: np.ndarray
    elapsed_ns: np.ndarray
    scalar: np.ndarray  # bool[K]: deficit-attribution (reference peer) deltas

    def __len__(self) -> int:
        return len(self.rows)


_FOLD_PAD_ROW = merge_mod.FOLD_PAD_ROW

# Fold-to-dense hybrid: a tick row touching at least this many lanes
# commits its full lane plane as ONE row-window join (0 = auto:
# max(4, nodes // 3)).
ROW_DENSE_MIN = int(os.environ.get("PATROL_ROW_DENSE_MIN", 0))
MAX_ROW_DENSE = 512  # padded-shape ceiling of the row-dense batch


def _pad_size(n: int, lo: int = 8, hi: int = MAX_MERGE_ROWS) -> int:
    """Next power of two ≥ n, bounded — keeps the staging shapes few."""
    size = lo
    while size < n and size < hi:
        size <<= 1
    return size


def _obs_stage(h, t0_ns: int, ev: int, arg: int = 0) -> int:
    """Close a stage opened at ``t0_ns`` into its latency histogram and
    (when enabled) the flight recorder."""
    dur = time.perf_counter_ns() - t0_ns
    h.record(dur)
    tr = trace_mod.TRACE
    if tr.enabled:
        tr.record(ev, dur, arg)
    return dur


def fold_core(deltas: DeltaArrays):
    """The tick fold: → (unique-pair rows, slots, added, taken,
    per-unique-row rows, elapsed), all sorted, duplicates max-joined."""
    order = np.lexsort((deltas.slots, deltas.rows))
    r = deltas.rows[order]
    s = deltas.slots[order]
    new_key = np.empty(len(r), bool)
    new_key[0] = True
    np.logical_or(r[1:] != r[:-1], s[1:] != s[:-1], out=new_key[1:])
    starts = np.flatnonzero(new_key)
    a = np.maximum.reduceat(deltas.added_nt[order], starts)
    t = np.maximum.reduceat(deltas.taken_nt[order], starts)
    el_sorted = deltas.elapsed_ns[order]
    new_row = np.empty(len(r), bool)
    new_row[0] = True
    np.not_equal(r[1:], r[:-1], out=new_row[1:])
    row_starts = np.flatnonzero(new_row)
    er = r[row_starts]
    e = np.maximum.reduceat(el_sorted, row_starts)
    return r[starts], s[starts], a, t, er, e


def pack_folded(ur, us, ua, ut, er, e) -> Optional[np.ndarray]:
    """Sentinel-padded int64[6, k] tick matrix from folded arrays (None
    when empty). Sentinel tail: rows above every live row keep the keys
    sorted; distinct slots keep them unique; the join drops them."""
    n = len(ur)
    if n == 0:
        return None
    ne = len(er)
    k = _pad_size(n)
    packed = np.empty((6, k), dtype=np.int64)
    packed[0, :n] = ur
    packed[1, :n] = us
    packed[2, :n] = ua
    packed[3, :n] = ut
    packed[0, n:] = _FOLD_PAD_ROW
    packed[1, n:] = np.arange(k - n)
    packed[2, n:] = 0
    packed[3, n:] = 0
    packed[4, :ne] = er
    packed[5, :ne] = e
    packed[4, ne:] = _FOLD_PAD_ROW + np.arange(k - ne)
    packed[5, ne:] = 0
    return packed


def _live(rows: np.ndarray) -> int:
    """Live entries of a packed row: those before its ``FOLD_PAD_ROW``
    sentinel tail."""
    return int(np.count_nonzero(rows < _FOLD_PAD_ROW))


# Distinct-row bound for the native fold: past this the per-row lane
# blocks stop paying for themselves (the uniform shape is scatter-bound
# anyway) and the numpy fold takes over.
FOLD_NATIVE_MAX_DISTINCT = 4096

# Per-thread reusable output buffers for the native fold (the feeder is
# the caller; two engines in one process each fold on their own feeder,
# so thread-local keeps them from sharing).
_fold_tls = threading.local()


def _fold_buffers(nodes: int, cap_pairs: int):
    cached = getattr(_fold_tls, "bufs", None)
    if cached is not None and cached[0][0] == nodes and cached[0][1] >= cap_pairs:
        return cached[1]
    cap_pairs = 1 << max(cap_pairs - 1, 1).bit_length()  # grow-once sizes
    cap_rows = min(cap_pairs, FOLD_NATIVE_MAX_DISTINCT)
    bufs = (
        np.empty(MAX_ROW_DENSE, np.int64),
        np.empty((MAX_ROW_DENSE, nodes, 2), np.int64),
        np.empty(MAX_ROW_DENSE, np.int64),
        np.empty(cap_pairs, np.int64),
        np.empty(cap_pairs, np.int64),
        np.empty(cap_pairs, np.int64),
        np.empty(cap_pairs, np.int64),
        np.empty(cap_rows, np.int64),
        np.empty(cap_rows, np.int64),
        np.zeros(3, np.int64),
    )
    _fold_tls.bufs = ((nodes, cap_pairs), bufs)
    return bufs


def _fold_hybrid_native(deltas: DeltaArrays, nodes: int, row_dense_min: int):
    """C++ fold (pt_fold_hybrid): one hash pass into per-row lane blocks,
    threaded across cores for large batches, in place of the numpy
    lexsort + reduceat fold. Returns :func:`fold_hybrid`'s exact result,
    or None to fall back to numpy (library unavailable, a batch under
    1024 deltas, or a distinct-row set past the bound)."""
    n = len(deltas.rows)
    if n < 1024:
        return None  # per-call buffers beat numpy only at batch scale
    # Cheap shape probe before any native work: a mostly-distinct sample
    # means the uniform shape, where the native fold would only discover
    # it must bail. A clustered batch's sample cannot trip it: its unique
    # count is bounded by the true distinct-row count.
    sample = deltas.rows[:: max(1, n // 2048)][:2048]
    if len(np.unique(sample)) >= 0.85 * len(sample):
        return None
    from patrol_tpu_torch import native as native_mod

    lib = native_mod.load()
    if lib is None:
        return None
    rows = np.ascontiguousarray(deltas.rows, np.int64)
    slots = np.ascontiguousarray(deltas.slots, np.int64)
    added = np.ascontiguousarray(deltas.added_nt, np.int64)
    taken = np.ascontiguousarray(deltas.taken_nt, np.int64)
    elapsed = np.ascontiguousarray(deltas.elapsed_ns, np.int64)
    bufs = _fold_buffers(nodes, min(n, FOLD_NATIVE_MAX_DISTINCT * nodes))
    (d_rows, d_upd, d_el, sp_rows, sp_slots, sp_a, sp_t, sp_er, sp_e,
     counts) = bufs
    counts[:] = 0
    rc = lib.pt_fold_hybrid(
        rows, slots, added, taken, elapsed, n, nodes, row_dense_min,
        FOLD_NATIVE_MAX_DISTINCT, d_rows, d_upd, d_el, MAX_ROW_DENSE,
        sp_rows, sp_slots, sp_a, sp_t, sp_er, sp_e, counts,
    )
    if rc != 0:
        return None
    n_pairs, n_rows, n_dense = int(counts[0]), int(counts[1]), int(counts[2])
    packed = pack_folded(
        sp_rows[:n_pairs], sp_slots[:n_pairs], sp_a[:n_pairs],
        sp_t[:n_pairs], sp_er[:n_rows], sp_e[:n_rows],
    )
    if n_dense == 0:
        return packed, None
    return packed, _pad_dense(d_rows[:n_dense], d_upd[:n_dense], d_el[:n_dense], nodes)


def _pad_dense(d_rows, upd, el, nodes: int):
    """The dense half at its padded shape: ``FOLD_PAD_ROW`` sentinel rows
    (out of range, unique) and zero updates past the live ``len(d_rows)``."""
    r = len(d_rows)
    rp = _pad_size(r, lo=8, hi=MAX_ROW_DENSE)
    rows_p = np.empty(rp, dtype=np.int64)
    rows_p[:r] = d_rows
    rows_p[r:] = _FOLD_PAD_ROW + np.arange(rp - r)
    upd_p = np.zeros((rp, nodes, 2), dtype=np.int64)
    upd_p[:r] = upd
    el_p = np.zeros(rp, dtype=np.int64)
    el_p[:r] = el
    return rows_p, upd_p, el_p


def fold_hybrid(deltas: DeltaArrays, nodes: int, row_dense_min: int):
    """Fold-to-dense hybrid split: rows whose tick touches ≥
    ``row_dense_min`` lanes commit their FULL lane plane as one row-window
    join; the sparse remainder rides the pair join. Returns
    (packed|None, (rows, updates, elapsed)|None). Large clustered batches
    fold in C++ (:func:`_fold_hybrid_native`, counted in
    ``fold_native_ticks``); the numpy fold below is the reference
    implementation and the uniform-shape path."""
    native_res = _fold_hybrid_native(deltas, nodes, row_dense_min)
    if native_res is not None:
        profiling.COUNTERS.inc("fold_native_ticks")
        return native_res
    return fold_hybrid_numpy(deltas, nodes, row_dense_min)


def fold_hybrid_numpy(deltas: DeltaArrays, nodes: int, row_dense_min: int):
    """:func:`fold_hybrid` by numpy alone (lexsort + reduceat)."""
    ur, us, ua, ut, er, e = fold_core(deltas)
    nrow = np.empty(len(ur), bool)
    nrow[0] = True
    np.not_equal(ur[1:], ur[:-1], out=nrow[1:])
    rstart = np.flatnonzero(nrow)
    counts = np.diff(np.append(rstart, len(ur)))
    dense_sel = counts >= row_dense_min
    if not dense_sel.any():
        return pack_folded(ur, us, ua, ut, er, e), None
    di = np.flatnonzero(dense_sel)
    if len(di) > MAX_ROW_DENSE:
        # Cap the dense batch at its padded-shape ceiling; the overflow
        # rides the sparse join (correct, just more pairs).
        dense_sel = np.zeros_like(dense_sel)
        dense_sel[di[:MAX_ROW_DENSE]] = True
    pair_dense = np.repeat(dense_sel, counts)
    d_rows = er[dense_sel]  # unique + sorted (er follows ur's order)
    R = len(d_rows)
    upd = np.zeros((R, nodes, 2), dtype=np.int64)
    pr_idx = np.repeat(np.arange(R), counts[dense_sel])
    upd[pr_idx, us[pair_dense], 0] = ua[pair_dense]
    upd[pr_idx, us[pair_dense], 1] = ut[pair_dense]
    sparse = ~pair_dense
    packed = pack_folded(
        ur[sparse], us[sparse], ua[sparse], ut[sparse],
        er[~dense_sel], e[~dense_sel],
    )
    return packed, _pad_dense(d_rows, upd, e[dense_sel], nodes)


class DeviceEngine:
    """Owns device state and the feeder thread. Thread-safe entry points:
    :meth:`submit_take` / :meth:`take`, :meth:`ingest_delta`,
    :meth:`snapshot`, :meth:`tokens_if_known`, :meth:`stop`.

    ``device`` defaults to ``"cuda"``; pass ``"cpu"`` to run the plain
    versions of the kernels on the host (the tests do). Asking for CUDA
    without a card raises. ``native_host=True`` keeps the host lanes in
    the C++ store (``runtime/hoststore.py``) when the host library loads,
    so the native HTTP front serves host-resident takes in C++."""

    # Raw-plane ingest (ops/ingest.py; the delta plane routes wire-v2
    # datagrams to ingest_raw_planes when set) and the inline interval
    # fold (ingest_interval's join launch on the rx thread; when unset the
    # interval queues for the feeder instead). The mesh engine
    # (runtime/mesh_engine.py) opts out of both, as the reference's does.
    _raw_ingest_capable = True
    _interval_fold_capable = True
    # Idle demotion of promoted rows back to host lanes; the mesh engine
    # opts out (its stats say ``mesh_demotion: unsupported``).
    _demotion_capable = True
    # Adaptive commit-block sizing (PATROL_COMMIT_BLOCKS=auto); the mesh
    # engine pins the static default.
    _commit_blocks_auto = COMMIT_BLOCKS_AUTO
    # The tick fold, shared with the mesh engine, whose round-robin
    # replica of each delta follows the fold's output order.
    _fold_core = staticmethod(fold_core)

    def __init__(
        self,
        config: LimiterConfig,
        node_slot: int = 0,
        clock: ClockFn = system_clock,
        on_broadcast: Optional[BroadcastFn] = None,
        device="cuda",
        native_host: bool = False,
    ):
        self.config = config
        self.node_slot = node_slot
        self.clock = clock
        self.on_broadcast = on_broadcast
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        if self._cuda and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._row_dense_min = ROW_DENSE_MIN or max(4, config.nodes // 3)
        self.directory = BucketDirectory(config.buckets)
        self.state: LimiterState = init_state(config, device=self.device)

        self._cond = profiling.ProfiledCondition("engine.work")
        # Serializes kernel launches against introspection gathers.
        self._state_mu = profiling.ProfiledLock("engine.state")
        # Serializes evictions (pick victims → zero device rows → recycle).
        self._evict_mu = threading.Lock()
        self._takes: deque = deque()
        self._deltas: deque = deque()
        # Hot-key coalescer index: take-fold key → its OPEN _TakeFold entry
        # in _takes (removed when the feeder drains the entry).
        self._open_folds: Dict[tuple, _TakeFold] = {}
        self._stopped = False
        self._busy = False
        # Set under _cond to hold the feeder between ticks (the mesh
        # engine's resize); queues keep absorbing work meanwhile.
        self._tick_paused = False
        self._ticks = 0  # kernel ticks issued (observability)
        # Device-state writes that ride no _ticks bump (rows zeroed, the
        # certified families, checkpoint restore), bumped under _state_mu.
        # (_ticks, _state_gen) is the scrape mirror's epoch.
        self._state_gen = 0
        # (epoch, pn[W, N, 2], elapsed[W]) or None, swapped as one tuple.
        self._scrape_mirror: Optional[Tuple[Tuple[int, int], np.ndarray, np.ndarray]] = None
        self._mirror_window = min(config.buckets, SCRAPE_MIRROR_ROWS) if SCRAPE_MIRROR else 0
        self._mirror_want = False  # a scrape found it stale: the completer refreshes
        self._tick_traced: List[Tuple[int, str]] = []
        self._evictions = 0
        self._scalar_dropped = 0
        # Recently-broadcast bucket names (insertion-ordered, bounded): the
        # graceful-shutdown flush re-broadcasts these buckets' FINAL state
        # so a lost last broadcast does not shed a stopping node's most
        # recent takes. Names, not rows: a row may be recycled between the
        # broadcast and the flush.
        self._dirty_mu = threading.Lock()
        self._dirty_names: Dict[str, None] = {}
        self._dirty_cap = 4096
        # patrol-audit: the admitted-token window ledger (net/audit.py
        # reads it on the audit plane's pace).
        self._audit = AuditLedger(AUDIT_WINDOW_NS)
        # Completion pipeline: the feeder DISPATCHES ticks and hands
        # (thunk, tickets) to this queue; the completer waits for the
        # device and fans results out. Bounded by the dispatch-ahead depth.
        self._pcond = profiling.ProfiledCondition("engine.completion")
        self._pending: deque = deque()
        self._completing = False
        self._feeder_done = False
        self._staging = StagingPool(pin=self._cuda)
        # One all-false ``hosted`` operand per raw-ingest entry width E on
        # the device (under _state_mu), as many planes deep as the widest
        # batch yet; a launch with no host-resident entry reads its [:P]
        # prefix. The kernel only reads it, so it is made once instead of
        # zeroed (one more launch) per batch.
        self._no_hosted: Dict[int, torch.Tensor] = {}
        # Host fast path: row → HostLanes of the buckets served in-process.
        # The flag array is the vectorized residency probe of the rx paths;
        # dict and flags change together, under _host_mu, as do
        # _promote_pending (rows the feeder's next tick promotes) and
        # _promoting (lanes popped by a promotion drain whose device join
        # has not landed yet: readers join them, so the spend is never in
        # neither place).
        self._hosted: Dict[int, HostLanes] = {}
        self._hosted_flag = np.zeros(config.buckets, dtype=bool)
        self._promote_pending: set = set()
        self._promoting: Dict[int, HostLanes] = {}
        self._host_mu = threading.Lock()
        # Native host-lane store: the lanes live in C++ blocks the native
        # HTTP front serves takes from without entering Python; the engine
        # sees the same bytes through numpy views, and _host_mu becomes
        # the store's mutex, so both sides serialize on one lock.
        self._native_store = None
        if native_host and HOST_FASTPATH:
            from patrol_tpu_torch.runtime import hoststore

            # The epoll thread's clock is CLOCK_REALTIME plus the injected
            # clock's offset at init (exact for the CLI's offset clocks).
            self._native_store = hoststore.NativeHostStore.create(
                nodes=config.nodes,
                node_slot=node_slot,
                directory=self.directory,
                clock_offset_ns=int(self.clock()) - time.time_ns(),
                window_ns=HOST_PROMOTE_WINDOW_NS,
            )
            if self._native_store is not None:
                self._host_mu = self._native_store.mutex()
        self._host_takes = 0  # takes served by the Python host path
        self._promotions = 0  # host → device residency transitions
        self._demotions = 0  # device → host residency transitions (idle)
        # Idle demotion (feeder): promoted rows still bound, their promotion
        # clock time, device-path takes per row in the current demote
        # window, and the window's start.
        self._promoted_rows: set = set()
        self._promoted_at: Dict[int, int] = {}
        self._dev_window: Dict[int, int] = {}
        self._demote_win_start: Optional[int] = None
        # Checkpoint restore pauses idle demotion across its flush, load
        # and join: a demotion's gather and zero in between would strand
        # the restored spend in zeroed device rows.
        self._demotion_paused = False
        # Bucket lifecycle: the knobs are per-engine copies
        # (configure_lifecycle); the sweep's counters change under
        # _evict_mu, the lock that serializes every unbind/zero/recycle.
        self._gc_window_ns = GC_WINDOW_NS
        self._gc_idle_ns = GC_IDLE_NS
        self._gc_sweep_max = GC_SWEEP_MAX
        self._max_buckets = MAX_BUCKETS
        self._bytes_budget = STATE_BYTES_BUDGET
        self._gc_soft_frac = GC_SOFT_FRAC
        self._gc_win_start: Optional[int] = None
        self._gc_reclaimed = 0
        self._gc_shed = 0
        self._gc_sweeps = 0
        self._gc_compactions = 0
        # Set (under _cond) by the host-served paths at the GC window's
        # rollover: they queue no feeder work, so without this wake-up a
        # workload served from host lanes would never sweep.
        self._gc_due = False
        if self._max_buckets or self._bytes_budget:
            slo_mod.SENTINEL.watch_budget(self._budget_snapshot)
        self._dispatch_ahead = DISPATCH_AHEAD
        self._commit_row_ns_ewma = 0.0
        self._commit_blocks = COMMIT_BLOCKS
        self._completer = threading.Thread(
            target=self._complete_loop, name="patrol-engine-complete", daemon=True
        )
        self._completer.start()
        self._thread = threading.Thread(target=self._run, name="patrol-engine", daemon=True)
        self._thread.start()

    # -- eviction -----------------------------------------------------------

    def _evict(self, need: int) -> int:
        """Reclaim at least ``need`` rows: unbind the LRU unpinned rows,
        zero their device state, recycle the slots. Caller holds
        ``_evict_mu``. Returns rows reclaimed (0 ⇒ everything is pinned)."""
        swath = min(4096, max(1, self.config.buckets // 8))
        victims = self.directory.pick_victims(max(need, swath))
        if victims.size == 0:
            return 0
        self._drop_hosted_rows(victims)
        rows = torch.from_numpy(victims.astype(np.int64)).to(self.device)
        with self._state_mu:
            merge_mod.zero_rows(self.state, rows)
            self._state_gen += 1
        self.directory.recycle(victims)
        self._evictions += int(victims.size)
        log.info("evicted %d idle buckets (pool pressure)", victims.size)
        return int(victims.size)

    def _with_evict_retry(self, call, need: int):
        """Fast path, then evict-and-retry under ``_evict_mu``. Returns
        None when every row is mid-flight (nothing evictable)."""
        try:
            return call()
        except DirectoryFullError:
            pass
        with self._evict_mu:
            while True:
                try:
                    return call()
                except DirectoryFullError:
                    if self._evict(need) == 0:
                        return None

    def assign_row(self, name: str, now: int, pin: bool = False) -> Tuple[int, bool]:
        """Directory assign with second-chance eviction on a spent pool.
        Raises DirectoryFullError only when every row is mid-flight."""
        res = self._with_evict_retry(
            lambda: self.directory.assign(name, now, pin=pin), 1
        )
        if res is None:
            raise DirectoryFullError("every bucket row is mid-flight")
        row, fresh = res
        # Unpinned creations re-seed here; the take path (pin=True) pops
        # the tombstone itself, to write the seed into fresh host lanes
        # before the first take commits.
        if fresh and not pin and self.directory.has_tombstones():
            seed = self._pop_tombstone_seed(name, row)
            if seed is not None:
                with self._cond:
                    self._deltas.append(_Delta(row, self.node_slot, *seed))
                    self._cond.notify()
        return res

    def _assign_pinned(self, name: str, now: int) -> Tuple[int, bool]:
        return self.assign_row(name, now, pin=True)

    def _assign_many_pinned(self, names: Sequence[str], now: int, with_fresh=False):
        """Batch form of :meth:`_assign_pinned`; None when the pool is
        spent with every row pinned."""
        return self._with_evict_retry(
            lambda: self.directory.assign_many(
                names, now, pin=True, with_fresh=with_fresh
            ),
            len(names),
        )

    # -- bucket lifecycle: idle-bucket GC and the memory budget -------------

    def configure_lifecycle(
        self,
        window_ms: Optional[float] = None,
        idle_ms: Optional[float] = None,
        sweep_max: Optional[int] = None,
        max_buckets: Optional[int] = None,
        bytes_budget: Optional[int] = None,
        soft_frac: Optional[float] = None,
    ) -> None:
        """Tune the lifecycle knobs of a live engine. Setting a budget
        registers the engine with the SLO sentinel, so a watermark breach
        fires its anomaly snapshot."""
        if window_ms is not None:
            self._gc_window_ns = int(window_ms * 1e6)
        if idle_ms is not None:
            self._gc_idle_ns = int(idle_ms * 1e6)
        if sweep_max is not None:
            self._gc_sweep_max = sweep_max
        if max_buckets is not None:
            self._max_buckets = max_buckets
        if bytes_budget is not None:
            self._bytes_budget = bytes_budget
        if soft_frac is not None:
            self._gc_soft_frac = soft_frac
        if self._max_buckets or self._bytes_budget:
            slo_mod.SENTINEL.watch_budget(self._budget_snapshot)

    def state_bytes_in_use(self) -> int:
        """Bytes of limiter state attributed to live buckets: device rows
        (pn and elapsed), directory metadata, host-resident lanes and
        tombstones -- what the byte budget is enforced against."""
        n = self.config.nodes
        row_bytes = n * 16 + 8 + _ROW_HOST_BYTES
        _t_n, t_bytes = self.directory.tombstone_stats()
        return (
            len(self.directory) * row_bytes
            + len(self._hosted) * (n * 16 + 64)
            + t_bytes
        )

    def _budget_pressure(self) -> int:
        """0: under budget, 1: soft watermark (GC ramps), 2: hard
        watermark (new names shed)."""
        hard = soft = False
        if self._max_buckets:
            bound = len(self.directory)
            hard |= bound >= self._max_buckets
            soft |= bound >= int(self._max_buckets * self._gc_soft_frac)
        if self._bytes_budget:
            in_use = self.state_bytes_in_use()
            hard |= in_use >= self._bytes_budget
            soft |= in_use >= int(self._bytes_budget * self._gc_soft_frac)
        return 2 if hard else (1 if soft else 0)

    def _budget_snapshot(self) -> dict:
        """The SLO sentinel's budget provider (utils/slo.py)."""
        return {
            "state_bytes_in_use": self.state_bytes_in_use(),
            "state_bytes_budget": self._bytes_budget,
            "buckets_bound": len(self.directory),
            "max_buckets": self._max_buckets,
            "over": self._budget_pressure() >= 2,
        }

    def _shed_new_names(self, now: int, n: int = 1) -> bool:
        """Hard-watermark check for NEW names: one emergency sweep (at most
        one per window/8) may free budget; if the pressure holds, the
        caller sheds the admission. Known names are never shed."""
        if self._budget_pressure() < 2:
            return False
        start = self._gc_win_start
        if start is None or now - start > self._gc_window_ns // 8:
            self.gc_sweep(now, force=True)
            if self._budget_pressure() < 2:
                return False
        with self._evict_mu:
            self._gc_shed += n
        profiling.COUNTERS.inc("gc_pressure_shed", n)
        trace_mod.anomaly("budget-shed")
        return True

    def _kick_gc_if_due(self, now: int) -> None:
        """Wake the feeder for a sweep when the GC window has rolled over
        (host-served takes queue no feeder work). Two int reads on the
        serving path; the sweep runs on the feeder."""
        if not self._gc_window_ns:
            return
        start = self._gc_win_start
        if start is not None and now - start <= self._gc_window_ns:
            return
        with self._cond:
            self._gc_due = True
            self._cond.notify()

    def _maybe_gc(self) -> None:
        """The feeder's cadence: sweep at the window's rollover, or at
        window/8 under budget pressure (GC ramps before admission sheds)."""
        if not self._gc_window_ns:
            return
        now = self.clock()
        start = self._gc_win_start
        if start is None:
            with self._evict_mu:
                self._gc_win_start = now
            return
        window = self._gc_window_ns
        if (self._max_buckets or self._bytes_budget) and self._budget_pressure():
            window //= 8
        if now - start > window:
            self.gc_sweep(now)

    def gc_sweep(self, now_ns: Optional[int] = None, force: bool = False) -> int:
        """One lifecycle sweep: probe up to ``_gc_sweep_max`` idle
        candidates (one kernel launch for the device-resident ones, the
        numpy twin for host-resident lanes), reclaim the full ones from the
        device plane, the host lanes and the directory, and compact the
        free list. → buckets reclaimed. Callable from any thread: each
        verdict is re-verified at reclaim (pins and an unchanged
        ``last_used_ns`` stamp, see :meth:`_gc_reclaim`), so a row that saw
        traffic after its probe is kept.

        Conservation: a reclaimed bucket's own lane and refill clock go
        into a directory tombstone and re-seed the row when the name is
        bound again, so the own lane stays monotone across reclaims and a
        peer's stale echo of the old lane cannot absorb later spend."""
        now = self.clock() if now_ns is None else now_ns
        pressure = self._budget_pressure()
        idle_ns = 0 if (force or pressure) else self._gc_idle_ns
        t0 = time.perf_counter_ns()
        cands, stamps = self.directory.gc_candidates(now, idle_ns, self._gc_sweep_max)
        reclaimed = 0
        if cands.size:
            reclaimed = self._gc_reclaim(cands, stamps, now)
        with self._evict_mu:
            self._gc_sweeps += 1
            self._gc_win_start = now
        profiling.COUNTERS.inc("gc_sweeps")
        profiling.COUNTERS.set_max("state_bytes_in_use", self.state_bytes_in_use())
        hist.GC_SWEEP.record(time.perf_counter_ns() - t0)
        return reclaimed

    def _probe_device_rows(self, rows, now: int, per, cap, created):
        """One padded launch of the lifecycle probe over device-resident
        rows; its four outputs come back with one copy. → numpy (full,
        own_added, own_taken, elapsed), each of ``len(rows)``."""
        m = len(rows)
        k = _pad_size(m, lo=8, hi=1 << 20)
        buf = self._staging.lease((5, k))
        cols = buf.numpy()
        cols[:] = 0  # padding: row 0 with capacity 0, never full
        cols[0, :m] = rows
        cols[1, :m] = now
        cols[2, :m] = per
        cols[3, :m] = cap
        cols[4, :m] = created
        dev = self._ship(buf)
        out = None
        if self._cuda:
            out = torch.empty(
                lifecycle_kernel.output_bytes(k), dtype=torch.uint8, device=self.device
            )
        with self._state_mu:
            view = lifecycle_ops.lifecycle_probe(
                self.state, lifecycle_ops.LifecycleProbe(*dev.unbind(0)),
                self.node_slot, out=out,
            )
        if out is None:
            return tuple(t.numpy()[:m].copy() for t in view)
        # One readback a sweep, on the stream behind the launch.
        res = self._staging.lease((lifecycle_kernel.output_bytes(k),), torch.uint8)
        res.copy_(out, non_blocking=True)
        self._device_event().synchronize()
        got = tuple(a[:m].copy() for a in lifecycle_kernel.split_outputs(res.numpy(), k))
        self._staging.release(res)
        return got

    def _gc_reclaim(self, cands: np.ndarray, stamps: np.ndarray, now: int) -> int:
        """Probe and reclaim body of :meth:`gc_sweep`.

        Host-resident victims are reclaimed under ``_host_mu``, and only
        while their own lane and elapsed still read as probed. The native
        front's in-front take pins nothing: it stamps ``last_used_ns`` and
        commits under that lock. So a take that lands after the probe
        either changed the lanes (the row is kept) or comes after the
        unbind (it misses; the Python path binds the name again and
        re-seeds it from the tombstone). Without the lock, a take admitted
        between the stamp check and the unbind, or at the stamp's own
        nanosecond, was dropped with the lanes. Device-resident victims
        are reclaimed outside it: the front serves no device row, and the
        directory's unbind of a full sweep takes tens of milliseconds."""
        n = len(cands)
        cap = self.directory.cap_base_nt[cands]
        per = self.directory.rate_per_ns[cands]
        created = self.directory.created_ns[cands]
        full = np.zeros(n, bool)
        own_a = np.zeros(n, np.int64)
        own_t = np.zeros(n, np.int64)
        el = np.zeros(n, np.int64)
        slot = self.node_slot
        # Rows mid-promotion live in neither plane completely (lanes
        # popped, join not landed): never probe or reclaim them. A
        # promotion requested after this snapshot is caught by the
        # reclaim's stamp check: the takes behind it refreshed the row.
        with self._host_mu:
            promo = set(self._promote_pending) | set(self._promoting)
            hosted_sel = self._hosted_flag[cands].copy()
        keep = np.ones(n, bool)
        if promo:
            keep = np.array([int(r) not in promo for r in cands], bool)
        host_idx = np.flatnonzero(hosted_sel & keep)
        if host_idx.size:
            with self._host_mu:
                for i in host_idx:
                    lanes = self._hosted.get(int(cands[i]))
                    if lanes is None:
                        continue
                    full[i] = bool(lifecycle_ops.host_lifecycle_full(
                        int(lanes.added.sum()), int(lanes.taken.sum()),
                        lanes.elapsed_ns, cap[i], created[i], now, per[i],
                    ))
                    own_a[i] = int(lanes.added[slot])
                    own_t[i] = int(lanes.taken[slot])
                    el[i] = lanes.elapsed_ns
        dev_idx = np.flatnonzero(~hosted_sel & keep)
        if dev_idx.size:
            full[dev_idx], own_a[dev_idx], own_t[dev_idx], el[dev_idx] = (
                self._probe_device_rows(
                    cands[dev_idx], now, per[dev_idx], cap[dev_idx], created[dev_idx]
                )
            )
        vict = np.flatnonzero(full)
        if not vict.size:
            return 0
        tombs = [(own_a[i], own_t[i], el[i]) for i in range(n)]
        with self._evict_mu:
            # Under _evict_mu residency holds still (promotion and demotion
            # both take it), so the victims split into rows hosted now, whose
            # reclaim runs under _host_mu, and device rows, which the front
            # never serves.
            with self._host_mu:
                hosted_now = self._hosted_flag[cands[vict]]
                host_v = []
                for i in vict[hosted_now]:
                    lanes = self._hosted.get(int(cands[i]))
                    if lanes is not None and (
                        int(lanes.added[slot]), int(lanes.taken[slot]), lanes.elapsed_ns,
                    ) == (own_a[i], own_t[i], el[i]):
                        host_v.append(i)  # else served since the probe: keep
                kept_h = self.directory.reclaim_rows(
                    cands[host_v], stamps[host_v], [tombs[i] for i in host_v]
                )
                self._drop_hosted_rows_locked(kept_h)
            dev_v = vict[~hosted_now]
            kept_d = self.directory.reclaim_rows(
                cands[dev_v], stamps[dev_v], [tombs[i] for i in dev_v]
            )
            self._drop_hosted_rows(kept_d)
            kept = np.concatenate([kept_h, kept_d])
            if not kept.size:
                return 0
            rows_z = torch.as_tensor(kept, device=self.device)
            with self._state_mu:
                merge_mod.zero_rows(self.state, rows_z)
                self._state_gen += 1
            if self.directory.recycle_compact(kept):
                self._gc_compactions += 1
                profiling.COUNTERS.inc("directory_compactions")
            self._gc_reclaimed += int(kept.size)
        profiling.COUNTERS.inc("gc_buckets_reclaimed", int(kept.size))
        log.debug("lifecycle GC reclaimed %d full idle buckets", kept.size)
        return int(kept.size)

    def _pop_tombstone_seed(self, name: str, row: int):
        """Consume a reclaimed bucket's tombstone when its name is bound
        again: → (own_added_nt, own_taken_nt, elapsed_ns) or None, and the
        row gets its original creation stamp back (the refill clock then
        reconstructs exactly). The seed must land before the row's first
        take commits: callers put it into fresh host lanes or into the
        same tick's merge phase."""
        tomb = self.directory.pop_tombstone(name, row)
        if tomb is None:
            return None
        return tomb[0], tomb[1], tomb[2]

    def _reseed_fresh_rows(self, names, rows, fresh_mask) -> None:
        """Bulk-ingest tail: queue the tombstone seeds of freshly bound rows
        (their order against the deltas that bound them is free: joins
        commute)."""
        if not self.directory.has_tombstones():
            return
        seeds = []
        seen = set()
        for i in np.flatnonzero(fresh_mask):
            row = int(rows[i])
            if row in seen:
                continue
            seen.add(row)
            seed = self._pop_tombstone_seed(names[i], row)
            if seed is not None:
                seeds.append(_Delta(row, self.node_slot, *seed))
        if seeds:
            with self._cond:
                self._deltas.extend(seeds)
                self._cond.notify()

    def lifecycle_stats(self) -> Dict[str, object]:
        """The bucket-lifecycle block of ``/debug/vars``."""
        t_n, _t_bytes = self.directory.tombstone_stats()
        return {
            "engine_gc_reclaimed": self._gc_reclaimed,
            "engine_gc_shed": self._gc_shed,
            "engine_gc_sweeps": self._gc_sweeps,
            "engine_gc_compactions": self._gc_compactions,
            "engine_gc_tombstones": t_n,
            "engine_state_bytes": self.state_bytes_in_use(),
            "engine_state_bytes_budget": self._bytes_budget,
            "engine_max_buckets": self._max_buckets,
            "engine_buckets_bound": len(self.directory),
            "engine_budget_pressure": self._budget_pressure(),
        }

    # -- entry points -------------------------------------------------------

    def _enqueue_take_locked(self, ticket: TakeTicket) -> None:
        """Queue one take (caller holds ``_cond``). With the hot-key fold
        on, a ticket whose (row, rate, count) key already has an OPEN
        queue entry rides that entry instead of appending its own."""
        if _take_fold_enabled():
            key = (ticket.row, ticket.rate.freq, ticket.rate.per_ns, ticket.count)
            fold = self._open_folds.get(key)
            if fold is not None:
                fold.tickets.append(ticket)
                profiling.COUNTERS.inc("take_tickets_folded")
                return
            fold = _TakeFold(key, ticket)
            self._open_folds[key] = fold
            self._takes.append(fold)
            return
        self._takes.append(ticket)

    def submit_take(
        self, name: str, rate: Rate, count: int, now_ns: Optional[int] = None
    ) -> Tuple[TakeTicket, bool]:
        """Queue a take; returns (ticket, created). ``created`` is the
        get-or-create miss signal that triggers incast. A fresh or
        host-resident bucket is served in-process and the ticket comes back
        completed. Raises :class:`OverloadedError` for a NEW name when the
        memory budget's hard watermark holds after an emergency sweep."""
        now = self.clock() if now_ns is None else now_ns
        if (
            (self._max_buckets or self._bytes_budget)
            and self.directory.lookup(name) is None
            and self._shed_new_names(now)
        ):
            raise OverloadedError(
                f"memory budget spent and nothing reclaimable; new bucket {name!r} shed"
            )
        row, fresh = self._assign_pinned(name, now)
        seed = self._pop_tombstone_seed(name, row) if fresh else None
        # First *local* take on the row (capacity still unset) counts as a
        # miss even when replication created the row first.
        created = fresh or int(self.directory.cap_base_nt[row]) == 0
        self.directory.init_cap_base(row, rate.freq * NANO)
        self.directory.note_rate(row, rate.per_ns)
        if HOST_FASTPATH and (fresh or self._hosted_flag[row]):
            ticket = self._try_host_take(name, row, rate, count, now, fresh, seed=seed)
            if ticket is not None:
                self._kick_gc_if_due(now)
                return ticket, created
        ticket = TakeTicket(name, row, rate, count, now)
        with self._cond:
            if seed is not None:
                # The re-seed rides the same tick's merge phase, which runs
                # before its takes: the first take commits on top of it.
                self._deltas.append(_Delta(row, self.node_slot, *seed))
            self._enqueue_take_locked(ticket)
            self._cond.notify()
        return ticket, created

    # -- host fast path -----------------------------------------------------

    def _try_host_take(
        self,
        name: str,
        row: int,
        rate: Rate,
        count: int,
        now: int,
        fresh: bool,
        out_broadcasts: Optional[List[wire.WireState]] = None,
        seed: Optional[Tuple[int, int, int]] = None,
    ) -> Optional[TakeTicket]:
        """Serve one take from the host lanes; → the completed ticket, or
        None when the row is (or just became) device-resident and the
        caller takes the device path."""
        ticket = TakeTicket(name, row, rate, count, now)
        served = self._host_serve_ticket(ticket, fresh, out_broadcasts, seed)
        return ticket if served else None

    def _host_serve_ticket(
        self,
        ticket: TakeTicket,
        fresh: bool,
        out_broadcasts: Optional[List[wire.WireState]] = None,
        seed: Optional[Tuple[int, int, int]] = None,
    ) -> bool:
        """Complete a ticket from the host lanes; False ⇒ the row is
        device-resident and the caller keeps the device path. A bucket
        whose window passes HOST_PROMOTE_TAKES is marked for promotion
        here. Batch callers pass ``out_broadcasts`` so a whole batch fans
        out through one ``on_broadcast`` call. ``seed`` (a tombstone's own
        lane and elapsed) goes into fresh lanes before the take commits.

        Known creation race, accepted as in the reference: between the
        directory bind and the flag flip, a concurrent rx delta or take on
        the same brand-new name can route to the device row, which the
        host lanes do not read; the promotion max-join then keeps the
        larger of the two own-lane debits. Closing it would need bind and
        host atomic across the directory and host locks, whose order would
        deadlock against eviction (_evict_mu, then _host_mu)."""
        row, rate, now = ticket.row, ticket.rate, ticket.now_ns
        with self._host_mu:
            lanes = self._hosted.get(row)
            if lanes is None:
                if not fresh:
                    return False  # promoted by a concurrent rx or take
                if self._native_store is not None:
                    # A C++ block (we hold _host_mu, the store's mutex):
                    # from here the epoll thread serves this row in front.
                    lanes = self._native_store.host_locked(row)
                else:
                    lanes = HostLanes(self.config.nodes)
                if seed is not None:
                    lanes.added[self.node_slot] = seed[0]
                    lanes.taken[self.node_slot] = seed[1]
                    lanes.elapsed_ns = seed[2]
                self._hosted[row] = lanes
                self._hosted_flag[row] = True
            lanes.roll_window(now)
            lanes.win_takes += 1
            # The cap is read while the caller's pin still holds the row:
            # after the unpin below an eviction could re-bind it.
            cap = int(self.directory.cap_base_nt[row])
            remaining, ok = lanes.take(
                cap, int(self.directory.created_ns[row]), now, rate,
                ticket.count, self.node_slot,
            )
            self._host_takes += 1
            own_a = int(lanes.added[self.node_slot])
            own_t = int(lanes.taken[self.node_slot])
            sum_a = int(lanes.added.sum())
            sum_t = int(lanes.taken.sum())
            elapsed = lanes.elapsed_ns
            if lanes.win_takes > HOST_PROMOTE_TAKES:
                self._promote_locked(row)
        if ticket.complete(remaining, ok):
            self.directory.unpin_rows([row])
        done_ns = time.perf_counter_ns()
        hist.TAKE_SERVICE.record(done_ns - ticket.t0_ns)
        if ok:
            # patrol-audit: the admitted tokens go into the open window.
            self._audit.note(ticket.name, ticket.count * NANO, cap, rate.per_ns, now)
        if ticket.trace_id:
            trace_mod.SPANS.add(
                ticket.trace_id, self.node_slot, "take", ticket.name,
                ticket.t0_ns, done_ns - ticket.t0_ns,
            )
            tr = trace_mod.TRACE
            if tr.enabled:
                tr.record(trace_mod.EV_TAKE, done_ns - ticket.t0_ns, 1)
        # Replicate as the device completion does (an all-zero state is the
        # incast request marker and never broadcasts).
        if (own_a or own_t or elapsed or cap) and self.on_broadcast is not None:
            ws = wire.from_nanotokens(
                ticket.name, cap + sum_a, sum_t, elapsed,
                origin_slot=self.node_slot, cap_nt=cap,
                lane_added_nt=own_a, lane_taken_nt=own_t,
                trace_id=ticket.trace_id,
            )
            if out_broadcasts is not None:
                out_broadcasts.append(ws)
            else:
                self._emit_broadcasts([ws])
        return True

    def _promote_locked(self, row: int) -> None:
        """Mark a bucket for promotion (caller holds ``_host_mu``). The row
        keeps serving host-side until the feeder's next tick joins every
        pending row's lanes in one batched launch (:meth:`_drain_promotions`)
        before that tick's own launches, so no device round trip runs
        under ``_host_mu`` and a take routed device-ward after the flag
        flips always runs against the joined planes."""
        if row in self._hosted:
            self._promote_pending.add(row)
            with self._cond:
                self._cond.notify()

    def _drain_promotions(self) -> None:
        """Complete pending promotions: pop the lanes and flip the flags
        under ``_host_mu``, then join them into the device planes under
        ``_state_mu``. Callers: the feeder at tick start (before _apply, so
        the tick's take-n launch follows the join on the same stream) and
        :meth:`flush_hosted` on a stopped engine. The pop → join window
        runs under ``_evict_mu``: an eviction in between would zero and
        recycle the row, and the join would then resurrect the dead
        bucket's lanes into the next bucket bound there."""
        with self._host_mu:
            if not self._promote_pending:
                return
        with self._evict_mu:
            self._drain_promotions_locked()

    def _drain_promotions_locked(self) -> None:
        """Body of :meth:`_drain_promotions`; caller holds ``_evict_mu``."""
        with self._host_mu:
            if not self._promote_pending:
                return
            popped: List[Tuple[int, HostLanes]] = []
            for row in self._promote_pending:
                lanes = self._hosted.pop(row, None)
                self._hosted_flag[row] = False
                if self._native_store is not None:
                    # Stop in-front serving in the same critical section
                    # (the block's data stays valid for the join below).
                    self._native_store.unhost_locked(row)
                if lanes is not None:
                    self._promotions += 1
                    popped.append((row, lanes))
                    self._promoted_rows.add(row)  # idle-demotion candidate
                    self._promoted_at[row] = self.clock()
                    self._promoting[row] = lanes
            self._promote_pending.clear()
        if not popped:
            return
        rows_l: List[int] = []
        slots_l: List[int] = []
        added_l: List[int] = []
        taken_l: List[int] = []
        elapsed_l: List[int] = []
        for row, lanes in popped:
            slots = np.flatnonzero(lanes.added | lanes.taken)
            if slots.size == 0 and not lanes.elapsed_ns:
                continue
            if slots.size == 0:
                slots = np.array([self.node_slot])
            for slot in slots:
                rows_l.append(row)
                slots_l.append(int(slot))
                added_l.append(int(lanes.added[slot]))
                taken_l.append(int(lanes.taken[slot]))
                elapsed_l.append(lanes.elapsed_ns)
        for lo in range(0, len(rows_l), MAX_MERGE_ROWS):
            hi = lo + MAX_MERGE_ROWS
            n = len(rows_l[lo:hi])
            buf = self._staging.lease((5, _pad_size(n)))
            packed = buf.numpy()
            packed[:] = 0  # padding: (row 0, slot 0, zeros) is a no-op max
            packed[0, :n] = rows_l[lo:hi]
            packed[1, :n] = slots_l[lo:hi]
            packed[2, :n] = added_l[lo:hi]
            packed[3, :n] = taken_l[lo:hi]
            packed[4, :n] = elapsed_l[lo:hi]
            dev = self._ship(buf)
            with self._state_mu:
                merge_batch(self.state, MergeBatch(*dev.unbind(0)))
            self._ticks += 1
        # Every join is queued on the stream ahead of any later read, so
        # the staged lanes may go (pop: an eviction may have dropped some).
        with self._host_mu:
            for row, _lanes in popped:
                self._promoting.pop(row, None)

    def _host_absorb_ingest(
        self,
        rows: np.ndarray,
        slots: np.ndarray,
        added: np.ndarray,
        taken: np.ndarray,
        elapsed: np.ndarray,
        scalar,
    ) -> Optional[np.ndarray]:
        """Fold rx deltas addressed to host-resident rows into their lanes
        (the elementwise max-join the device computes, so exact). → a
        keep-mask for the caller's chunk (False ⇒ absorbed here; the caller
        unpins those rows), or None when nothing in the chunk is hosted.

        Absorb, not promote: in a cluster a bucket's own state is echoed
        back within one round trip, so promoting on any rx would end every
        hosted bucket after its first take. A scalar (v1) delta, which
        needs the device's deficit attribution, promotes the row and rides
        the tick; so does rx pressure past HOST_PROMOTE_TAKES a window."""
        if not self._hosted:
            return None
        keep = np.ones(len(rows), dtype=bool)
        now = self.clock()
        with self._host_mu:
            # The residency mask is read under the lock: an idle demotion
            # flips flags inside its own _host_mu section after checking
            # pins, and our caller pinned these rows first, so a row is
            # either seen hosted here or skipped by the demotion.
            mask = self._hosted_flag[rows]
            if not mask.any():
                return None
            for i in np.flatnonzero(mask):
                row = int(rows[i])
                lanes = self._hosted.get(row)
                if lanes is None:
                    continue  # promoted since the mask was read: keep
                if scalar is not None and scalar[i]:
                    # The delta rides the tick; the feeder joins the lanes
                    # (_drain_promotions) before applying it.
                    self._promote_locked(row)
                    continue
                slot = int(slots[i])
                if lanes.added[slot] < added[i]:
                    lanes.added[slot] = added[i]
                if lanes.taken[slot] < taken[i]:
                    lanes.taken[slot] = taken[i]
                if lanes.elapsed_ns < elapsed[i]:
                    lanes.elapsed_ns = int(elapsed[i])
                keep[i] = False
                lanes.roll_window(now)
                lanes.win_rx += 1
                if lanes.win_rx > HOST_PROMOTE_TAKES:
                    self._promote_locked(row)
        return keep

    def _drop_hosted_rows(self, rows) -> None:
        """Forget host-side state of rows leaving service (eviction,
        release): after the unbind and before the recycle, or a later bind
        of the row would inherit a dead bucket's lanes."""
        if not self._hosted and not self._promoted_rows and not self._promoting:
            return
        with self._host_mu:
            self._drop_hosted_rows_locked(rows)

    def _drop_hosted_rows_locked(self, rows) -> None:
        """Body of :meth:`_drop_hosted_rows`; caller holds ``_host_mu``."""
        for row in rows:
            row = int(row)
            self._promoted_rows.discard(row)
            self._promoted_at.pop(row, None)
            if self._hosted_flag[row]:
                self._hosted.pop(row, None)
                self._hosted_flag[row] = False
                if self._native_store is not None:
                    self._native_store.unhost_locked(row)
            # A stale pending entry would promote the next bucket bound
            # here; a staged one would show the dead bucket's lanes.
            self._promote_pending.discard(row)
            self._promoting.pop(row, None)

    def _maybe_demote(self, tickets, deltas) -> None:
        """Feeder only: at the demote window's rollover, move quiet
        promoted rows back to host residency. Exact: the rows' device
        state is gathered into fresh lanes, the flags flip, then the device
        rows are zeroed (a read in between max-joins equal values).

        Safety against concurrent work: rows with deltas in this tick's
        hands are skipped; any other queued or in-flight work holds a
        directory pin, so a row qualifies only while its pins equal those
        of this tick's own tickets (which the re-route then serves from
        the host). The pin re-check runs under ``_host_mu``, where every rx
        path reads residency; the gather → flip → zero runs under
        ``_evict_mu``, so no eviction or release recycles a row
        mid-demotion."""
        if not (HOST_FASTPATH and self._demotion_capable) or self._demotion_paused:
            return
        now = self.clock()
        if self._demote_win_start is None:
            self._demote_win_start = now
            return
        if now - self._demote_win_start <= HOST_DEMOTE_WINDOW_NS:
            return
        counts, self._dev_window = self._dev_window, {}
        self._demote_win_start = now
        with self._host_mu:
            # A row must have been device-resident for one whole window: a
            # row promoted mid-window has only a truncated count.
            cands = [
                r for r in self._promoted_rows
                if counts.get(r, 0) < HOST_DEMOTE_TAKES
                and now - self._promoted_at.get(r, now) >= HOST_DEMOTE_WINDOW_NS
            ]
        if not cands:
            return
        own_pins: Dict[int, int] = {}
        for t in tickets:
            own_pins[t.row] = own_pins.get(t.row, 0) + 1
        delta_rows = set(int(r) for r in deltas.rows) if deltas is not None else set()
        with self._evict_mu:
            elig = []
            for row in cands:
                if row in delta_rows:
                    continue
                if not self.directory._bound[row]:
                    self._promoted_rows.discard(row)
                    self._promoted_at.pop(row, None)
                    continue
                if int(self.directory.pins[row]) != own_pins.get(row, 0):
                    continue  # queued work beyond this tick pins the row
                elig.append(row)
            if not elig:
                return
            pn, el = self.read_rows(elig)  # one gather
            demoted: List[int] = []
            with self._host_mu:
                # Re-checked under the lock: a checkpoint restore sets the
                # pause, then reads the host lanes under this lock, so no
                # demotion commits after its read.
                if self._demotion_paused:
                    return
                for i, row in enumerate(elig):
                    if int(self.directory.pins[row]) != own_pins.get(row, 0):
                        continue  # pinned since the outer check
                    if self._hosted_flag[row]:
                        continue
                    if self._native_store is not None:
                        lanes = self._native_store.host_locked(row)
                    else:
                        lanes = HostLanes(self.config.nodes)
                    lanes.added[:] = pn[i][:, 0]
                    lanes.taken[:] = pn[i][:, 1]
                    lanes.elapsed_ns = int(el[i])
                    lanes.win_start_ns = now
                    self._hosted[row] = lanes
                    self._hosted_flag[row] = True
                    self._promoted_rows.discard(row)
                    self._promoted_at.pop(row, None)
                    demoted.append(row)
            if demoted:
                rows_t = torch.as_tensor(np.asarray(demoted, np.int64), device=self.device)
                with self._state_mu:
                    merge_mod.zero_rows(self.state, rows_t)
                    self._state_gen += 1
                self._demotions += len(demoted)
                log.debug("demoted %d idle buckets to host residency", len(demoted))

    def flush_hosted(self, timeout: float = 10.0) -> int:
        """Promote every host-resident bucket to the device path (an exact
        batched join). → rows promoted; raises ``TimeoutError`` when the
        feeder's join has not landed within ``timeout`` (a silent partial
        flush would let the caller read planes without the lanes). The
        drain runs on the feeder (here we only mark and wait), because only
        the feeder orders the flag flip, the join and the tick's launches."""
        with self._host_mu:
            rows = list(self._hosted.keys())
            self._promote_pending.update(rows)
        if not rows:
            return 0
        if self._stopped:
            # No feeder, and no traffic can race a stopped engine.
            self._drain_promotions()
            return len(rows)
        with self._cond:
            self._cond.notify()
        deadline = time.monotonic() + timeout
        ours = set(rows)
        while time.monotonic() < deadline:
            with self._host_mu:
                # A row leaves _promote_pending at the drain's pop and
                # _promoting once its join is queued: absence from both is
                # exactly "visible in the device planes". Scoped to our
                # rows, since live traffic keeps promoting others.
                if not (ours & self._promote_pending) and not (
                    ours & self._promoting.keys()
                ):
                    return len(rows)
            time.sleep(0.0005)
        raise TimeoutError(
            f"flush_hosted: promotion join for {len(rows)} rows did not "
            f"land within {timeout}s"
        )

    def drain_native_promotions(self) -> None:
        """Promotions-only drain of the native store: the front's pump
        calls it when a poll wake finds the store's promotion-event counter
        moved while the broadcast cadence gate is still closed, so a
        take-pressure-hot bucket joins the device path promptly. Dirty rows
        keep their queue entries for the cadence-gated drain."""
        st = self._native_store
        if st is None:
            return
        with self._host_mu:
            for row in st.drain_promotes_locked():
                if row in self._hosted:
                    self._promote_locked(row)

    def drain_native_broadcasts(self) -> None:
        """Turn the C++ front's coalesced take effects into replication:
        emit each dirty row's latest full state once (a later state
        subsumes every earlier one) and mark take-pressure promotions.
        Called by the native front's pump each cycle."""
        st = self._native_store
        if st is None:
            return
        # The C++ front's takes never enter Python: the pump's drain cycle
        # is the one periodic seam that keeps the GC cadence alive then.
        self._kick_gc_if_due(self.clock())
        if self.on_broadcast is None:
            # Standalone node: drain both queues (promotion marks matter,
            # dirty flags must clear) without building states.
            with self._host_mu:
                while True:
                    dirty, _snap, promotes = st.drain_locked()
                    for row in promotes:
                        if row in self._hosted:
                            self._promote_locked(row)
                    if not dirty and not promotes:
                        return
        n = self.config.nodes
        while True:
            # The work under the lock is minimal (the epoll thread's takes
            # block on it): the C++ drain copies each dirty row's lanes
            # into a buffer, Python captures (index, name, cap) per row,
            # and the states are built outside against the copies. Loop
            # until both queues drain (one buffer's worth per call).
            meta: List[Tuple[int, str, int]] = []
            with self._host_mu:
                dirty, lanes_snap, promotes = st.drain_locked()
                for row in promotes:
                    if row in self._hosted:
                        self._promote_locked(row)
                for i, row in enumerate(dirty):
                    if not self._hosted_flag[row]:
                        continue  # promoted or evicted since marked
                    name = self.directory.name_of(row)
                    if name is None:
                        continue
                    meta.append((i, name, int(self.directory.cap_base_nt[row])))
            states: List[wire.WireState] = []
            for i, name, cap in meta:
                row_snap = lanes_snap[i]
                own_a = int(row_snap[self.node_slot])
                own_t = int(row_snap[n + self.node_slot])
                elapsed = int(row_snap[2 * n])
                if not (own_a or own_t or elapsed or cap):
                    continue  # an all-zero state is the incast marker
                states.append(
                    wire.from_nanotokens(
                        name, cap + int(row_snap[:n].sum()),
                        int(row_snap[n : 2 * n].sum()), elapsed,
                        origin_slot=self.node_slot, cap_nt=cap,
                        lane_added_nt=own_a, lane_taken_nt=own_t,
                    )
                )
            if states:
                self._emit_broadcasts(states)
            if not dirty and not promotes:
                return

    def take(
        self, name: str, rate: Rate, count: int, now_ns: Optional[int] = None
    ) -> Tuple[int, bool, bool]:
        """Blocking take: returns (remaining, ok, created)."""
        ticket, created = self.submit_take(name, rate, count, now_ns)
        ticket.wait()
        return ticket.remaining, ticket.ok, created

    def submit_takes_batch(
        self,
        names: Sequence[str],
        rates: Sequence[Rate],
        counts: Sequence[int],
        now_ns: Optional[int] = None,
    ) -> Optional[List[Tuple[TakeTicket, bool]]]:
        """Batched :meth:`submit_take` (the native HTTP pump's path): ONE
        directory pass, one capacity init, host-resident and fresh rows
        served in-process in batch order, one queue append + wake-up for
        the rest. Returns [(ticket, created), ...] in request order, or
        None when the pool is spent with every row pinned. Under the memory
        budget's hard watermark, requests for NEW names come back as
        completed shed tickets (ok False, ``shed`` set): per-request 429s,
        never a failed batch."""
        now = self.clock() if now_ns is None else now_ns
        if self._max_buckets or self._bytes_budget:
            unknown = [i for i, n in enumerate(names) if self.directory.lookup(n) is None]
            if unknown and self._shed_new_names(now, len(unknown)):
                out: List = [None] * len(names)
                for i in unknown:
                    t = TakeTicket(names[i], 0, rates[i], int(counts[i]), now)
                    t.shed = True  # an overload shed, not a rate deny
                    t.complete(0, False)  # never pinned, never queued
                    out[i] = (t, False)
                shed = set(unknown)
                keep = [i for i in range(len(names)) if i not in shed]
                if keep:
                    sub = self._submit_takes_batch_inner(
                        [names[i] for i in keep], [rates[i] for i in keep],
                        [counts[i] for i in keep], now,
                    )
                    if sub is None:
                        return None
                    for i, r in zip(keep, sub):
                        out[i] = r
                return out
        return self._submit_takes_batch_inner(list(names), list(rates), list(counts), now)

    def _submit_takes_batch_inner(
        self,
        names: Sequence[str],
        rates: Sequence[Rate],
        counts: Sequence[int],
        now: int,
    ) -> Optional[List[Tuple[TakeTicket, bool]]]:
        res = self._assign_many_pinned(names, now, with_fresh=True)
        if res is None:
            return None
        rows, bind_fresh = res
        created_arr = self.directory.cap_base_nt[rows] == 0
        # Sequential parity: only the FIRST occurrence of a row in the
        # batch counts as the creating miss.
        first = np.zeros(len(rows), dtype=bool)
        first[np.unique(rows, return_index=True)[1]] = True
        created = (created_arr & first).tolist()
        self.directory.init_cap_base_many(
            rows, np.asarray([r.freq for r in rates], np.int64) * NANO
        )
        self.directory.note_rate_many(
            rows, np.asarray([r.per_ns for r in rates], np.int64)
        )
        # Tombstone re-seeds of rows this batch bound fresh (one per first
        # occurrence): into the fresh host lanes below, or into the tick's
        # merge phase for the device path.
        fresh_first = bind_fresh & first
        seeds: Dict[int, Tuple[int, int, int]] = {}
        if fresh_first.any() and self.directory.has_tombstones():
            for i in np.flatnonzero(fresh_first):
                s = self._pop_tombstone_seed(names[i], int(rows[i]))
                if s is not None:
                    seeds[int(rows[i])] = s
        # Host fast path, in batch order. The flag is re-read per request:
        # a fresh row hosted by its first occurrence must catch its later
        # occurrences in this batch. Eligibility is the directory's
        # bind-fresh signal (a cap == 0 proxy would host rows that already
        # hold replicated device lanes).
        host_served: Dict[int, TakeTicket] = {}
        if HOST_FASTPATH:
            bc: List[wire.WireState] = []
            for i in np.flatnonzero(self._hosted_flag[rows] | bind_fresh):
                if self._hosted_flag[rows[i]] or fresh_first[i]:
                    t = self._try_host_take(
                        names[i], int(rows[i]), rates[i], int(counts[i]), now,
                        bool(fresh_first[i]), out_broadcasts=bc,
                        seed=seeds.get(int(rows[i])),
                    )
                    if t is not None:
                        host_served[int(i)] = t
                        if fresh_first[i]:
                            seeds.pop(int(rows[i]), None)  # in the lanes
            self._emit_broadcasts(bc)
        tickets = [
            host_served.get(i)
            or TakeTicket(names[i], int(rows[i]), rates[i], int(counts[i]), now)
            for i in range(len(names))
        ]
        queued = [t for i, t in enumerate(tickets) if i not in host_served]
        if host_served and not queued:
            # No feeder work queued: keep the GC cadence alive.
            self._kick_gc_if_due(now)
        if queued or seeds:
            with self._cond:
                for srow, s in seeds.items():
                    # Fresh binds left on the device path: the seed rides
                    # the same tick's merge phase, ahead of the takes.
                    self._deltas.append(_Delta(srow, self.node_slot, *s))
                for t in queued:
                    self._enqueue_take_locked(t)
                self._cond.notify()
        return list(zip(tickets, created))

    def ingest_delta(self, state: wire.WireState, slot: int, scalar: bool = False) -> bool:
        """Queue one replication delta for merge; returns the created flag.
        Dropped (not an error) if the pool is spent with everything pinned.

        Wire semantics (see ops/wire.py): a lane trailer merges the exact
        PN lane values (and adopts ``cap_nt`` as the row's cap base when
        unset); ``cap_nt`` alone subtracts the wire cap and routes through
        the deficit-attribution merge; ``scalar=True`` (v1, no trailer)
        subtracts OUR cap base (dropped while it is unknown) and uses the
        deficit-attribution merge; otherwise the header carries raw
        own-lane values for a plain lane max-merge."""
        now = self.clock()
        if not 0 <= slot < self.config.nodes:
            log.warning("delta slot %d out of range, dropped", slot)
            return False
        try:
            row, created = self._assign_pinned(state.name, now)
        except DirectoryFullError:
            log.warning("pool spent (all pinned); delta for %r dropped", state.name)
            return False
        if created and self.directory.has_tombstones():
            seed = self._pop_tombstone_seed(state.name, row)
            if seed is not None:
                with self._cond:
                    self._deltas.append(_Delta(row, self.node_slot, *seed))
                    self._cond.notify()
        self.directory.last_remote_ns[row] = now
        added_nt = state.added_nt
        taken_nt = state.taken_nt
        if state.cap_nt is not None:
            if state.cap_nt > 0:
                self.directory.init_cap_base(row, state.cap_nt)
            if state.lane_added_nt is not None and state.lane_taken_nt is not None:
                added_nt = state.lane_added_nt
                taken_nt = state.lane_taken_nt
                scalar = False
            else:
                added_nt = max(added_nt - state.cap_nt, 0)
                scalar = True
        elif scalar:
            base = int(self.directory.cap_base_nt[row])
            if base == 0:
                # Capacity unknown on this row: drop; the reference peer's
                # next full-state broadcast re-delivers.
                self.directory.unpin_rows([row])
                self._scalar_dropped += 1
                return created
            added_nt = max(added_nt - base, 0)
        if HOST_FASTPATH and self._hosted_flag[row]:
            # The per-packet twin of _host_absorb_ingest: same join.
            absorbed = False
            with self._host_mu:
                lanes = self._hosted.get(row)
                if lanes is not None:
                    if scalar:
                        self._promote_locked(row)  # the delta rides the tick
                    else:
                        if lanes.added[slot] < added_nt:
                            lanes.added[slot] = added_nt
                        if lanes.taken[slot] < taken_nt:
                            lanes.taken[slot] = taken_nt
                        if lanes.elapsed_ns < state.elapsed_ns:
                            lanes.elapsed_ns = state.elapsed_ns
                        lanes.roll_window(now)
                        lanes.win_rx += 1
                        if lanes.win_rx > HOST_PROMOTE_TAKES:
                            self._promote_locked(row)
                        absorbed = True
            if absorbed:
                self.directory.unpin_rows([row])
                if state.trace_id:
                    # The merge span of a host-absorbed remote delta.
                    trace_mod.SPANS.add(
                        state.trace_id, self.node_slot, "merge", state.name,
                        time.perf_counter_ns(), 0,
                    )
                return created
        delta = _Delta(row, slot, added_nt, taken_nt, state.elapsed_ns, scalar)
        if state.trace_id:
            delta.trace_id = state.trace_id
            delta.trace_name = state.name
        with self._cond:
            self._deltas.append(delta)
            self._cond.notify()
        return created

    def ingest_deltas_batch(
        self,
        names: Sequence[str],
        slots: Sequence[int],
        added_nt: Sequence[int],
        taken_nt: Sequence[int],
        elapsed_ns: Sequence[int],
        caps_nt: Optional[Sequence[int]] = None,
        lane_added_nt: Optional[Sequence[int]] = None,
        lane_taken_nt: Optional[Sequence[int]] = None,
        scalar: Optional[Sequence[bool]] = None,
    ) -> int:
        """Bulk ingest: one vectorized directory pass, one queue append,
        one wake-up. Returns deltas accepted (the whole batch is dropped
        only when the pool is spent with every row pinned).

        Per-delta wire semantics (−1 = field absent; see ingest_delta):
        lane values ≥0 ⇒ exact PN lane merge; cap ≥0 only ⇒ header minus
        wire cap, deficit-attribution merge; neither ⇒ ``scalar[i]`` picks
        between v1 scalar state (deficit-attribution merge against OUR
        cap_base, dropped while that capacity is unknown) and a
        base-trailer peer's raw own-lane header (plain lane merge; the
        default when ``scalar`` is omitted). ``caps_nt=None`` entirely ⇒
        raw lane values."""
        now = self.clock()
        slots_a = np.asarray(slots, dtype=np.int64)
        keep = (slots_a >= 0) & (slots_a < self.config.nodes)
        caps_a = None if caps_nt is None else np.asarray(caps_nt, dtype=np.int64)
        lane_a = None if lane_added_nt is None else np.asarray(lane_added_nt, np.int64)
        lane_t = None if lane_taken_nt is None else np.asarray(lane_taken_nt, np.int64)
        scalar_a = None if scalar is None else np.asarray(scalar, dtype=bool)
        if caps_a is None and scalar_a is not None:
            # Honor the scalar flags even without a caps array (parity with
            # ingest_delta(..., scalar=True)): all caps absent.
            caps_a = np.full(len(slots_a), -1, dtype=np.int64)
        added_a = np.asarray(added_nt, dtype=np.int64)
        taken_a = np.asarray(taken_nt, dtype=np.int64)
        elapsed_a = np.asarray(elapsed_ns, dtype=np.int64)
        if not keep.all():
            idx = np.flatnonzero(keep)
            names = [names[i] for i in idx]
            slots_a = slots_a[idx]
            added_a, taken_a, elapsed_a = added_a[idx], taken_a[idx], elapsed_a[idx]
            if caps_a is not None:
                caps_a = caps_a[idx]
            if lane_a is not None:
                lane_a, lane_t = lane_a[idx], lane_t[idx]
            if scalar_a is not None:
                scalar_a = scalar_a[idx]
        if not len(names):
            return 0
        accepted = 0
        # Split oversize batches so one chunk never exceeds a tick's budget.
        for lo in range(0, len(names), MAX_MERGE_ROWS):
            hi = lo + MAX_MERGE_ROWS
            chunk_names = names[lo:hi]
            res = self._assign_many_pinned(chunk_names, now, with_fresh=True)
            if res is None:
                log.warning(
                    "pool spent (all pinned); %d deltas dropped", len(chunk_names)
                )
                continue
            rows, fresh = res
            if fresh.any():
                self._reseed_fresh_rows(chunk_names, rows, fresh)
            accepted += self._classify_queue_chunk(
                rows,
                slots_a[lo:hi],
                added_a[lo:hi],
                taken_a[lo:hi],
                elapsed_a[lo:hi],
                None if caps_a is None else caps_a[lo:hi],
                None if lane_a is None else lane_a[lo:hi],
                None if lane_t is None else lane_t[lo:hi],
                None if scalar_a is None else scalar_a[lo:hi],
            )
        return accepted

    def _classify_queue_chunk(
        self,
        rows: np.ndarray,
        slots_c: np.ndarray,
        added_c: np.ndarray,
        taken_c: np.ndarray,
        elapsed_c: np.ndarray,
        caps_c: Optional[np.ndarray],
        lane_ac: Optional[np.ndarray],
        lane_tc: Optional[np.ndarray],
        scalar_c_in: Optional[np.ndarray],
    ) -> int:
        """Shared tail of the bulk-ingest paths: wire-semantics
        classification (see ingest_deltas_batch) over a chunk whose rows
        are already assigned+pinned, then one queue append + wake-up.
        Returns deltas queued; unpins any it drops."""
        added_c = np.maximum(added_c, 0)
        taken_c = np.maximum(taken_c, 0)
        elapsed_c = np.maximum(elapsed_c, 0)
        # patrol-audit staleness stamp (remote absorb; racy by design).
        self.directory.last_remote_ns[rows] = self.clock()
        scalar_c = None
        if caps_c is not None:
            has_cap = caps_c >= 0
            # Adopt peer capacities first, so same-batch v1 deltas for
            # rows initialized here already see the base.
            self.directory.init_cap_base_many(
                rows[has_cap & (caps_c > 0)], caps_c[has_cap & (caps_c > 0)]
            )
            # v1 (no trailer) ⇒ capacity-included scalar aggregates; a
            # cap-less base trailer ⇒ raw own-lane header (no subtract).
            v1 = (
                ~has_cap & scalar_c_in
                if scalar_c_in is not None
                else np.zeros_like(has_cap)
            )
            base = self.directory.cap_base_nt[rows]
            sub = np.where(has_cap, np.maximum(caps_c, 0), np.where(v1, base, 0))
            added_c = np.maximum(added_c - sub, 0)
            lane_ok = np.zeros_like(has_cap)
            if lane_ac is not None:
                # Lane-trailer packets: the exact PN lane values replace
                # the header-derived approximation.
                lane_ok = has_cap & (lane_ac >= 0) & (lane_tc >= 0)
                added_c = np.where(lane_ok, lane_ac, added_c)
                taken_c = np.where(lane_ok, lane_tc, taken_c)
            # Deficit attribution for every aggregate-header delta: v1
            # packets and cap-without-lane trailers alike.
            scalar_c = v1 | (has_cap & ~lane_ok)
            # v1 deltas on rows with unknown capacity: drop (the peer's
            # next full-state broadcast re-delivers).
            unknown = v1 & (base == 0)
            if unknown.any():
                self._scalar_dropped += int(unknown.sum())
                self.directory.unpin_rows(rows[unknown])
                keep_c = ~unknown
                rows, slots_c = rows[keep_c], slots_c[keep_c]
                added_c, taken_c = added_c[keep_c], taken_c[keep_c]
                elapsed_c, scalar_c = elapsed_c[keep_c], scalar_c[keep_c]
                if not len(rows):
                    return 0
        absorbed_n = 0
        if HOST_FASTPATH:
            keep_h = self._host_absorb_ingest(
                rows, slots_c, added_c, taken_c, elapsed_c, scalar_c
            )
            if keep_h is not None and not keep_h.all():
                self.directory.unpin_rows(rows[~keep_h])
                absorbed_n = int((~keep_h).sum())
                rows, slots_c = rows[keep_h], slots_c[keep_h]
                added_c, taken_c = added_c[keep_h], taken_c[keep_h]
                elapsed_c = elapsed_c[keep_h]
                if scalar_c is not None:
                    scalar_c = scalar_c[keep_h]
                if not len(rows):
                    return absorbed_n
        chunk = _DeltaChunk(rows, slots_c, added_c, taken_c, elapsed_c, scalar_c)
        with self._cond:
            self._deltas.append(chunk)
            self._cond.notify()
        return chunk.n + absorbed_n

    def ingest_deltas_batch_raw(
        self,
        n: int,
        name_buf: np.ndarray,
        name_lens: np.ndarray,
        name_hashes: np.ndarray,
        slots: np.ndarray,
        added_nt: np.ndarray,
        taken_nt: np.ndarray,
        elapsed_ns: np.ndarray,
        caps_nt: np.ndarray,
        lane_added_nt: np.ndarray,
        lane_taken_nt: np.ndarray,
        scalar: np.ndarray,
    ) -> int:
        """Zero-materialization bulk ingest (the native rx loop's path
        when the directory has no native table). Names arrive as raw
        zero-padded byte rows + FNV hashes (native.decode_batch_raw);
        known buckets resolve through the directory's vectorized hash
        table without creating a Python string, and only directory misses
        (new buckets, once per bucket lifetime) materialize names and take
        the evicting assign path. Wire-semantics classification is shared
        with :meth:`ingest_deltas_batch`."""
        now = self.clock()
        keep = (
            (slots[:n] >= 0)
            & (slots[:n] < self.config.nodes)
            & (name_lens[:n] >= 0)
        )
        idx_all = np.flatnonzero(keep)
        # Gather names as u64 words, not bytes: fancy-indexing cost scales
        # with element count, and the directory verifies on the word view.
        name_words = np.ascontiguousarray(name_buf).view(np.uint64)
        accepted = 0
        for lo in range(0, len(idx_all), MAX_MERGE_ROWS):
            idx = idx_all[lo : lo + MAX_MERGE_ROWS]
            rows = self.directory.lookup_hashed_pinned(
                name_hashes[idx], name_words[idx], name_lens[idx], now
            )
            miss = np.flatnonzero(rows < 0)
            if miss.size:
                miss_rows = self._bind_wire_misses_pinned(
                    name_buf, name_lens, name_hashes, idx[miss], now
                )
                if miss_rows is None:
                    hit = rows >= 0
                    idx, rows = idx[hit], rows[hit]
                    if not idx.size:
                        continue
                else:
                    rows[miss] = miss_rows
            accepted += self._classify_queue_chunk(
                rows,
                slots[idx].astype(np.int64),
                added_nt[idx],
                taken_nt[idx],
                elapsed_ns[idx],
                caps_nt[idx],
                lane_added_nt[idx],
                lane_taken_nt[idx],
                scalar[idx],
            )
        return accepted

    def ingest_wire_batch(
        self,
        dbuf,
        n: int,
        slots: np.ndarray,
        no_trailer: np.ndarray,
    ) -> int:
        """The native rx loop's fused path: raw decode buffers
        (native.DecodeBuffers: float64 wire headers, zero-padded name
        rows, FNV hashes) → classified delta queue in ONE native call
        (pt_rx_classify: resolve + sanitize + wire-semantics classify +
        per-batch (row, slot) dedup). Python touches only the leftovers:
        directory misses (bound via the wire bind path, classified by the
        numpy tail) and v1 deltas whose row capacity was unknown at native
        classify time. Falls back to :meth:`ingest_deltas_batch_raw` when
        the directory has no native table. Returns deltas queued."""
        now = self.clock()
        slots = np.ascontiguousarray(slots[:n], np.int64)
        res = self.directory.rx_classify(
            n, dbuf.hashes, dbuf.names, dbuf.name_lens, dbuf.added,
            dbuf.taken, dbuf.elapsed, slots, self.config.nodes,
            dbuf.caps, dbuf.lane_a, dbuf.lane_t, no_trailer, now,
        )
        if res is None:
            return self.ingest_deltas_batch_raw(
                n, dbuf.names, dbuf.name_lens, dbuf.hashes, slots,
                wire.sanitize_nt_array(dbuf.added[:n]),
                wire.sanitize_nt_array(dbuf.taken[:n]),
                np.maximum(dbuf.elapsed[:n].astype(np.int64), 0),
                dbuf.caps[:n], dbuf.lane_a[:n], dbuf.lane_t[:n],
                no_trailer[:n].astype(bool),
            )
        rows, out_a, out_t, out_e, out_s = res
        accepted = 0
        miss = rows == -1
        if miss.any():
            # First sight of these buckets (once per bucket lifetime):
            # bind, then classify through the numpy tail.
            mi = np.flatnonzero(miss)
            miss_rows = self._bind_wire_misses_pinned(
                dbuf.names, dbuf.name_lens, dbuf.hashes, mi, now
            )
            if miss_rows is not None:
                accepted += self._classify_queue_chunk(
                    miss_rows,
                    slots[mi],
                    wire.sanitize_nt_array(dbuf.added[mi]),
                    wire.sanitize_nt_array(dbuf.taken[mi]),
                    np.maximum(dbuf.elapsed[mi].astype(np.int64), 0),
                    dbuf.caps[mi],
                    dbuf.lane_a[mi],
                    dbuf.lane_t[mi],
                    no_trailer[mi].astype(bool),
                )
        live = rows >= 0
        recheck = live & (out_s == 2)
        if recheck.any():
            # v1 deltas on rows whose capacity was 0 during the native
            # pass; the miss binds above may have adopted caps since.
            idx2 = np.flatnonzero(recheck)
            base = self.directory.cap_base_nt[rows[idx2]]
            known = base > 0
            ki = idx2[known]
            out_a[ki] = np.maximum(out_a[ki] - base[known], 0)
            out_s[ki] = 1
            drop = idx2[~known]
            if drop.size:
                self._scalar_dropped += int(drop.size)
                self.directory.unpin_rows(rows[drop])
                live[drop] = False
        idx = np.flatnonzero(live)
        for lo in range(0, len(idx), MAX_MERGE_ROWS):
            sl = idx[lo : lo + MAX_MERGE_ROWS]
            if HOST_FASTPATH:
                keep_h = self._host_absorb_ingest(
                    rows[sl], slots[sl], out_a[sl], out_t[sl], out_e[sl],
                    out_s[sl] == 1,
                )
                if keep_h is not None and not keep_h.all():
                    self.directory.unpin_rows(rows[sl][~keep_h])
                    accepted += int((~keep_h).sum())
                    sl = sl[keep_h]
                    if not sl.size:
                        continue
            chunk = _DeltaChunk(
                rows[sl], slots[sl], out_a[sl], out_t[sl], out_e[sl],
                out_s[sl] == 1,
            )
            with self._cond:
                self._deltas.append(chunk)
                self._cond.notify()
            accepted += chunk.n
        return accepted

    def ingest_interval(
        self,
        names: Sequence[str],
        slots: Sequence[int],
        caps_nt: Sequence[int],
        added_nt: Sequence[int],
        taken_nt: Sequence[int],
        elapsed_ns: Sequence[int],
    ) -> int:
        """Bulk ingest of ONE decoded delta-interval datagram (wire v2,
        net/delta.py's python-decode path): exact absolute PN-lane values
        only, so no deficit attribution and no capacity gating. One
        vectorized directory pass, then a SINGLE sentinel-padded join
        launch (ops/delta.delta_fold) on the calling thread. Returns
        deltas accepted; drops are loss-tolerant by CRDT design."""
        if not self._interval_fold_capable:
            # An engine that opts out of launching on the rx thread: the
            # entries are exact PN lane values with caps — the lane-trailer
            # case of the classify path — so they queue for the feeder.
            return self.ingest_deltas_batch(
                names, slots, added_nt, taken_nt, elapsed_ns, caps_nt=caps_nt,
                lane_added_nt=added_nt, lane_taken_nt=taken_nt,
            )
        now = self.clock()
        slots_a = np.asarray(slots, dtype=np.int64)
        keep = (slots_a >= 0) & (slots_a < self.config.nodes)
        caps_a = np.asarray(caps_nt, dtype=np.int64)
        added_a = np.asarray(added_nt, dtype=np.int64)
        taken_a = np.asarray(taken_nt, dtype=np.int64)
        elapsed_a = np.asarray(elapsed_ns, dtype=np.int64)
        if not keep.all():
            idx = np.flatnonzero(keep)
            names = [names[i] for i in idx]
            slots_a, caps_a = slots_a[idx], caps_a[idx]
            added_a, taken_a, elapsed_a = added_a[idx], taken_a[idx], elapsed_a[idx]
        if not len(names):
            return 0
        accepted = 0
        for lo in range(0, len(names), MAX_MERGE_ROWS):
            hi = lo + MAX_MERGE_ROWS
            chunk_names = names[lo:hi]
            res = self._assign_many_pinned(chunk_names, now, with_fresh=True)
            if res is None:
                log.warning(
                    "pool spent (all pinned); %d interval deltas dropped",
                    len(chunk_names),
                )
                continue
            rows, fresh_c = res
            # patrol-audit staleness stamp: these rows just absorbed
            # remote-lane state (racy int64 write, sampler-only reader).
            self.directory.last_remote_ns[rows] = now
            if fresh_c.any():
                self._reseed_fresh_rows(chunk_names, rows, fresh_c)
            slots_c = slots_a[lo:hi]
            caps_c = np.maximum(caps_a[lo:hi], 0)
            added_c = np.maximum(added_a[lo:hi], 0)
            taken_c = np.maximum(taken_a[lo:hi], 0)
            elapsed_c = np.maximum(elapsed_a[lo:hi], 0)
            pos = caps_c > 0
            if pos.any():
                self.directory.init_cap_base_many(rows[pos], caps_c[pos])
            if HOST_FASTPATH:
                keep_h = self._host_absorb_ingest(
                    rows, slots_c, added_c, taken_c, elapsed_c, None
                )
                if keep_h is not None and not keep_h.all():
                    self.directory.unpin_rows(rows[~keep_h])
                    accepted += int((~keep_h).sum())
                    rows, slots_c = rows[keep_h], slots_c[keep_h]
                    added_c, taken_c = added_c[keep_h], taken_c[keep_h]
                    elapsed_c = elapsed_c[keep_h]
            n = len(rows)
            if n == 0:
                continue
            k = _pad_size(n)
            buf = self._staging.lease((5, k))
            packed = buf.numpy()
            packed[0, :n] = rows
            packed[0, n:] = _FOLD_PAD_ROW
            packed[1, :n] = slots_c
            packed[2, :n] = added_c
            packed[3, :n] = taken_c
            packed[4, :n] = elapsed_c
            packed[1:, n:] = 0
            dev = self._ship(buf)
            t0 = time.perf_counter_ns()
            with self._state_mu:
                delta_ops.delta_fold(self.state, delta_ops.DeltaBatch(*dev.unbind(0)))
            self._observe_device_commit("delta_fold", t0, n)
            self._ticks += 1
            # The join is queued on the default stream ahead of any
            # launch that could recycle these rows, so the pins may go now.
            self.directory.unpin_rows(rows)
            accepted += n
        return accepted

    def ingest_raw_planes(
        self,
        planes: np.ndarray,
        lengths: np.ndarray,
        walk=None,
        release: Optional[Callable[[], None]] = None,
    ) -> int:
        """Raw dv2 datagram byte planes → joined state in ONE launch of the
        decode+fold kernel (ops/ingest.py). Framing walk, entry
        extraction, checksum/validation verdicts, sentinel padding of
        invalid packets and the scatter-max fold all run in the kernel;
        the host contributes the directory pass that resolves entry names
        to rows (vectorized, through the walk's name offsets and hashes —
        Python strings materialize only for first-seen buckets) and the
        host-lane split: entries of host-resident rows are marked
        ``hosted``, the kernel leaves them out of the fold, and its
        ``hosted_mask`` and decoded fields come back in one copy to be
        absorbed into the host lanes.

        ``planes`` is uint8[P, ROW]; ``walk`` is the caller's
        :func:`ops.ingest.host_walk` result when it already ran one;
        ``release`` is invoked on the completion pipeline once the planes'
        copy to the device has finished — or inline if nothing is
        launched. Returns deltas accepted (folded and host-absorbed).

        On CUDA, planes in page-locked memory (the native rx ring's, see
        ``native.RxRing.pin``) ship as they lie with one non-blocking
        copy; other planes are first copied into a pinned staging lease.
        Either way ``release`` runs only once that copy has finished. The
        calling (rx) thread synchronises with the device only for a batch
        that holds a host-resident entry, to read the kernel's verdict on
        it. Each launch records its plane count P in the
        ``ingest_raw_planes`` histogram."""
        released = release is None

        def _release_inline() -> None:
            nonlocal released
            if not released:
                released = True
                release()

        try:
            planes = np.asarray(planes)
            lengths = np.ascontiguousarray(lengths, np.int32)
            if walk is None:
                walk = ingest_ops.host_walk(planes, lengths)
            if not walk.ok.any():
                # Every row failed the framing walk: the kernel would fold
                # nothing, so nothing is launched (a garbage flood must not
                # burn launches); the finally releases the planes inline.
                return 0
            P, row_w = planes.shape
            E = walk.name_len.shape[1]
            now = self.clock()
            live = walk.ok[:, None] & (np.arange(E)[None, :] < walk.count[:, None])
            pi, ei = np.nonzero(live)
            rows_pe = np.full((P, E), _FOLD_PAD_ROW, np.int32)
            hosted_pe = np.zeros((P, E), dtype=bool)
            pinned: Optional[np.ndarray] = None
            if pi.size:
                # Entry filter the python rx path applies per entry:
                # out-of-range slots and control-channel names never reach
                # the directory (nor the fold — their rows stay sentinels).
                slots_f = walk.slot[pi, ei]
                off_f = walk.name_off[pi, ei].astype(np.int64)
                len_f = walk.name_len[pi, ei].astype(np.int32)
                first = planes[pi, np.clip(off_f, 0, row_w - 1)]
                ctrl = (len_f > 0) & (first == 0)
                keep = (slots_f >= 0) & (slots_f < self.config.nodes) & ~ctrl
                pi, ei = pi[keep], ei[keep]
                off_f, len_f = off_f[keep], len_f[keep]
            if pi.size:
                # The directory pass, raw form: vectorized hashed lookup
                # (pins hits), misses bound once per bucket lifetime.
                hashes_f = walk.name_hash[pi, ei]
                name_buf = ingest_ops.gather_name_rows(planes, pi, off_f, len_f)
                rows_f = self.directory.lookup_hashed_pinned(
                    hashes_f, name_buf, len_f, now
                )
                miss = np.flatnonzero(rows_f < 0)
                for lo in range(0, miss.size, MAX_MERGE_ROWS):
                    mi = miss[lo : lo + MAX_MERGE_ROWS]
                    got = self._bind_wire_misses_pinned(
                        name_buf, len_f, hashes_f, mi, now
                    )
                    if got is not None:
                        rows_f[mi] = got
                bound = rows_f >= 0
                if bound.any():
                    b_rows = rows_f[bound].astype(np.int64)
                    pinned = b_rows
                    # patrol-audit staleness stamp (remote absorb; racy by
                    # design, sampler-only reader).
                    self.directory.last_remote_ns[b_rows] = now
                    caps_b = np.maximum(walk.cap[pi, ei][bound], 0)
                    pos = caps_b > 0
                    if pos.any():
                        self.directory.init_cap_base_many(b_rows[pos], caps_b[pos])
                    rows_pe[pi[bound], ei[bound]] = b_rows
                    if HOST_FASTPATH and self._hosted:
                        # Residency is read under the lock, after the pins:
                        # an idle demotion either flipped these rows first
                        # (they read hosted) or sees the pins and skips them.
                        with self._host_mu:
                            hosted_pe[pi[bound], ei[bound]] = self._hosted_flag[b_rows]
            any_hosted = bool(hosted_pe.any())

            # ONE launch for the whole batch. entry_off is the walk's
            # framing proposal the kernel RE-VALIDATES; rows and hosted are
            # the host plan.
            entry_off = np.maximum(walk.name_off - 1, 0)
            t0 = time.perf_counter_ns()
            out_dev = None
            if self._cuda:
                src = None
                if planes.flags.c_contiguous and planes.flags.writeable:
                    src = torch.from_numpy(planes)
                if src is not None and src.is_pinned():
                    # Straight from the caller's page-locked plane.
                    planes_dev = src.to(self.device, non_blocking=True)
                    copied = self._device_event()
                    profiling.COUNTERS.inc("ingest_raw_pinned_ships")
                else:
                    buf = self._staging.lease((P, row_w), torch.uint8)
                    buf.numpy()[...] = planes
                    planes_dev = buf.to(self.device, non_blocking=True)
                    copied = self._device_event()
                    self._staging.release(buf, copied)
                plan = self._staging.lease((2 * P * E + P,), torch.int32)
                flat = plan.numpy()
                flat[: P * E] = entry_off.reshape(-1)
                flat[P * E : 2 * P * E] = rows_pe.reshape(-1)
                flat[2 * P * E :] = lengths
                plan_dev = self._ship(plan)
                eoff_dev = plan_dev[: P * E].view(P, E)
                rows_dev = plan_dev[P * E : 2 * P * E].view(P, E)
                lengths_dev = plan_dev[2 * P * E :]
                hosted_dev = None
                if any_hosted:
                    hb = self._staging.lease((P, E), torch.uint8)
                    hb.numpy()[...] = hosted_pe
                    hosted_dev = self._ship(hb).view(torch.bool)
                    out_dev = torch.empty(
                        ingest_kernel.output_bytes(P, E), dtype=torch.uint8,
                        device=self.device,
                    )
            else:
                copied = None
                planes_dev = torch.from_numpy(np.ascontiguousarray(planes))
                eoff_dev = torch.from_numpy(entry_off.astype(np.int32))
                rows_dev = torch.from_numpy(rows_pe)
                lengths_dev = torch.from_numpy(lengths)
                hosted_dev = torch.from_numpy(hosted_pe) if any_hosted else None
            _obs_stage(hist.STAGE_H2D, t0, trace_mod.EV_H2D_PUT, int(pi.size))
            t0 = time.perf_counter_ns()
            with self._state_mu:
                if hosted_dev is None:
                    hosted_dev = self._no_hosted.get(E)
                    if hosted_dev is None or hosted_dev.shape[0] < P:
                        hosted_dev = torch.zeros((P, E), dtype=torch.bool, device=self.device)
                        self._no_hosted[E] = hosted_dev
                    hosted_dev = hosted_dev[:P]
                # The kernel's wrapper as is: the host plan holds
                # directory rows and FOLD_PAD_ROW, never a negative row
                # for decode_fold_raw to wrap.
                outs = ingest_kernel.decode_fold(
                    self.state.pn, self.state.elapsed, planes_dev, lengths_dev,
                    eoff_dev, rows_dev, hosted_dev, out=out_dev,
                )
            _obs_stage(
                hist.STAGE_DISPATCH, t0, trace_mod.EV_COMMIT_DISPATCH, int(pi.size)
            )
            self._observe_device_commit("decode_fold_raw", t0, max(int(pi.size), 1))
            self._ticks += 1
            hist.RAW_PLANES.record(P)
            profiling.COUNTERS.inc("ingest_raw_device_dispatches")
            profiling.COUNTERS.inc(
                "ingest_raw_bytes_on_device", int(lengths[walk.ok].sum())
            )
            if release is not None:
                released = True

                def _commit_plane() -> None:
                    # Plane-recycle gate on the completion pipeline: the
                    # caller's plane is reused only once its copy has
                    # finished. Runs on the completer, not the rx path.
                    if copied is not None:
                        copied.synchronize()
                    release()

                self._enqueue_completion(_commit_plane, (), {})
            accepted = int(((rows_pe != _FOLD_PAD_ROW) & ~hosted_pe).sum())
            requeued: Optional[np.ndarray] = None
            if any_hosted:
                profiling.COUNTERS.inc("ingest_raw_hosted_dispatches")
                absorbed, requeued = self._absorb_raw_hosted(outs, out_dev, rows_pe, P, E)
                accepted += absorbed
            # Release this call's pins, except one per entry re-queued as a
            # feeder chunk: the tick's finally releases those.
            if pinned is not None:
                if requeued is not None and requeued.size:
                    left = {}
                    for r in requeued.tolist():
                        left[r] = left.get(r, 0) + 1
                    drop = np.zeros(len(pinned), dtype=bool)
                    for i, r in enumerate(pinned.tolist()):
                        if left.get(r, 0):
                            left[r] -= 1
                            drop[i] = True
                    pinned = pinned[~drop]
                # Every launch is queued on the default stream ahead of
                # any launch that could recycle these rows.
                self.directory.unpin_rows(pinned)
            return accepted
        finally:
            _release_inline()

    def _absorb_raw_hosted(self, outs, out_dev, rows_pe, P: int, E: int):
        """The host-lane tail of a raw launch whose plan marked hosted
        entries: read back the kernel's ``hosted_mask`` (valid ∩ hosted)
        and decoded fields — on CUDA one copy of the launch's output
        buffer, on the stream behind the kernel, waited for here — and
        join them into the host lanes. Entries whose row was promoted in
        flight are queued for the feeder instead. → (entries absorbed,
        rows of the queued entries or None); the caller's pins on these
        rows are still held."""
        if out_dev is not None:
            nb = 42 * P * E  # the fields, then both masks
            res = self._staging.lease((nb,), torch.uint8)
            res.copy_(out_dev[:nb], non_blocking=True)
            self._device_event().synchronize()
            _ok, masks, fields = ingest_kernel.split_outputs(res.numpy(), P, E)
            hm = masks[1]
        else:
            hm = outs[2].numpy()
            fields = np.stack([t.numpy() for t in outs[3:]])
        hpi, hei = np.nonzero(hm)
        if not hpi.size:
            if out_dev is not None:
                self._staging.release(res)
            return 0, None
        h_rows = rows_pe[hpi, hei].astype(np.int64)
        h_slots = fields[0][hpi, hei].copy()
        h_added = fields[2][hpi, hei].copy()
        h_taken = fields[3][hpi, hei].copy()
        h_elapsed = np.maximum(fields[4][hpi, hei], 0)
        if out_dev is not None:
            self._staging.release(res)
        keep_h = self._host_absorb_ingest(
            h_rows, h_slots, h_added, h_taken, h_elapsed, None
        )
        if keep_h is None:
            keep_h = np.ones(len(h_rows), dtype=bool)
        absorbed = int((~keep_h).sum())
        profiling.COUNTERS.inc("ingest_raw_hosted_absorbed", absorbed)
        if not keep_h.any():
            return absorbed, None
        chunk = _DeltaChunk(
            h_rows[keep_h], h_slots[keep_h], h_added[keep_h], h_taken[keep_h],
            h_elapsed[keep_h],
        )
        with self._cond:
            self._deltas.append(chunk)
            self._cond.notify()
        return absorbed + chunk.n, chunk.rows

    def _assign_many_pinned_wire(self, names, name_rows, name_lens, hashes, now):
        """Wire-decoded variant of :meth:`_assign_many_pinned` — fresh
        binds copy the already-decoded name bytes vectorized
        (directory.assign_many_wire); same eviction-retry contract."""
        return self._with_evict_retry(
            lambda: self.directory.assign_many_wire(
                names, name_rows, name_lens, hashes, now, pin=True
            ),
            len(names),
        )

    def _bind_wire_misses_pinned(
        self,
        name_buf: np.ndarray,
        name_lens: np.ndarray,
        hashes: np.ndarray,
        mi: np.ndarray,
        now: int,
    ) -> Optional[np.ndarray]:
        """The miss protocol of the wire ingest path: materialize the
        first-seen names (the one place the rx path creates Python
        strings), bind + pin via the wire bind path. None ⇒ pool spent
        (logged); callers drop those deltas."""
        miss_names = [
            bytes(name_buf[i, : name_lens[i]]).decode("utf-8", "surrogateescape")
            for i in mi
        ]
        rows = self._assign_many_pinned_wire(
            miss_names, name_buf[mi], name_lens[mi], hashes[mi], now
        )
        if rows is None:
            log.warning("pool spent (all pinned); %d deltas dropped", mi.size)
        elif self.directory.has_tombstones():
            # Wire misses are creations: re-seed any reclaimed bucket's own
            # lane from its tombstone.
            self._reseed_fresh_rows(miss_names, rows, np.ones(len(rows), dtype=bool))
        return rows

    # -- the certified families (ops/gcra.py, ops/concurrency.py,
    # ops/hierquota.py): synchronous microbatches against the shared planes,
    # under the state lock the feeder's launches take.

    def _cert_call(self, launch, rows, fields, result_rows: int) -> np.ndarray:
        """One family call. ``rows`` (the path's row vectors) are read as
        int32 and wrapped, ``fields`` as int64, each broadcast to K
        columns, packed into one staging buffer (K padded to a power of
        two with columns of zeros, which commit nothing) and shipped in
        one copy; ``launch(state, packed, node_slot)`` runs under
        ``_state_mu`` and bumps ``_state_gen``; the result matrix comes
        back in one copy. → int64[result_rows, K]."""
        b = self.config.buckets
        k = np.asarray(rows[-1]).shape[0]
        cols = [np.broadcast_to(cert_kernel.wrap_rows_np(r, b), (k,)) for r in rows]
        cols += [np.broadcast_to(np.asarray(f, np.int64), (k,)) for f in fields]
        if k == 0:
            return np.zeros((result_rows, 0), np.int64)
        kp = _pad_size(k, hi=1 << 62)
        buf = self._staging.lease((len(cols), kp))
        packed = buf.numpy()
        packed[:, k:] = 0
        for i, col in enumerate(cols):
            packed[i, :k] = col
        dev = self._ship(buf)
        with self._state_mu:
            out = launch(self.state, dev, self.node_slot)
            self._state_gen += 1
        if self._cuda:
            res_buf = self._staging.lease((result_rows, kp))
            res_buf.copy_(out)  # the one readback; waits for the launch
            res = res_buf.numpy()[:, :k].copy()
            self._staging.release(res_buf)
            return res
        return out.numpy()[:, :k].copy()

    def gcra_take(self, rows, now_ns, emission_ns, tol_ns, nreq) -> gcra_ops.GcraResult:
        """GCRA conformance microbatch → GcraResult of numpy int64 arrays."""
        res = self._cert_call(
            gcra_ops.gcra_take_packed, [rows], [now_ns, emission_ns, tol_ns, nreq],
            gcra_ops.GCRA_RESULT_ROWS,
        )
        return gcra_ops.GcraResult(*res)

    def conc_acquire(self, rows, limit_nt, count_nt, nreq, releases) -> conc_ops.ConcResult:
        """Concurrency release-then-acquire microbatch → ConcResult of
        numpy int64 arrays."""
        res = self._cert_call(
            conc_ops.conc_acquire_packed, [rows], [limit_nt, count_nt, nreq, releases],
            conc_ops.CONC_RESULT_ROWS,
        )
        return conc_ops.ConcResult(*res)

    def quota_take(
        self,
        rows_global,
        rows_tenant,
        rows_user,
        limit_global_nt,
        limit_tenant_nt,
        limit_user_nt,
        count_nt,
        nreq,
    ) -> quota_ops.QuotaResult:
        """Hierarchical-quota path-take microbatch → QuotaResult of numpy
        int64 arrays."""
        res = self._cert_call(
            quota_ops.quota_take_packed, [rows_global, rows_tenant, rows_user],
            [limit_global_nt, limit_tenant_nt, limit_user_nt, count_nt, nreq],
            quota_ops.QUOTA_RESULT_ROWS,
        )
        return quota_ops.QuotaResult(*res)

    def _emit_broadcasts(self, broadcasts: List[wire.WireState]) -> None:
        if not broadcasts:
            return
        self._note_dirty(broadcasts)
        if self.on_broadcast is not None:
            try:
                self.on_broadcast(broadcasts)
            except Exception:  # pragma: no cover
                log.exception("broadcast hook failed")

    def _note_dirty(self, broadcasts: List[wire.WireState]) -> None:
        """Remember which buckets this node broadcast state for (bounded,
        newest kept) — the shutdown-flush working set. Also stamps the
        patrol-audit per-bucket emission clock (staleness sampler)."""
        now = self.clock()
        with self._dirty_mu:
            d = self._dirty_names
            for st in broadcasts:
                d.pop(st.name, None)  # move-to-back keeps recency order
                d[st.name] = None
            while len(d) > self._dirty_cap:
                d.pop(next(iter(d)))
        for st in broadcasts:
            row = self.directory.lookup(st.name)
            if row is not None:
                self.directory.last_emit_ns[row] = now

    def drain_dirty_states(self, limit: int = 1024) -> List[wire.WireState]:
        """Snapshot the most recently broadcast buckets' CURRENT full lane
        state and clear the dirty set — the graceful-shutdown flush
        payload. Bounded by ``limit`` buckets (newest first); per-lane
        states, shipped on the normal broadcast path."""
        with self._dirty_mu:
            names = list(self._dirty_names)[-limit:]
            self._dirty_names.clear()
        out: List[wire.WireState] = []
        for lo in range(0, len(names), 64):
            for states in self.snapshot_many(names[lo : lo + 64]).values():
                out.extend(states)
        return out

    # -- introspection ------------------------------------------------------

    def read_rows(self, rows) -> tuple:
        """Gather per-bucket state: (pn[K,N,2], elapsed[K]) as host numpy
        arrays — one batched device→host copy per call."""
        idx = torch.as_tensor(np.asarray(rows, dtype=np.int64), device=self.device)
        with self._state_mu:
            pn = self.state.pn[idx]
            el = self.state.elapsed[idx]
        return pn.cpu().numpy(), el.cpu().numpy()

    def snapshot_planes(self) -> Tuple[np.ndarray, np.ndarray]:
        """Host copies of both planes with every host-resident bucket's
        lanes max-joined in, mid-promotion ones (``_promoting``) too. Copy
        and join run under ``_host_mu``, so a promotion is seen in exactly
        one of the places read (a row in two of them max-joins equal
        values). Residency is untouched."""
        with self._host_mu:
            with self._state_mu:
                pn, elapsed = state_to_numpy(self.state)
            for row, lanes in list(self._hosted.items()) + list(self._promoting.items()):
                np.maximum(pn[row, :, 0], lanes.added, out=pn[row, :, 0])
                np.maximum(pn[row, :, 1], lanes.taken, out=pn[row, :, 1])
                if elapsed[row] < lanes.elapsed_ns:
                    elapsed[row] = lanes.elapsed_ns
        return pn, elapsed

    def _row_states(self, rows: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
        """(pn[K, N, 2], elapsed[K]) of bucket rows wherever they live: the
        lanes of a host-resident row, else one device gather for all the
        others, max-joined with the staged lanes of a row mid-promotion.
        The lanes are copied under ``_host_mu`` before the gather: a
        promotion drain drops a staged entry only once its join is queued
        ahead of that gather."""
        rows = [int(r) for r in rows]
        host: Dict[int, tuple] = {}
        staged: Dict[int, tuple] = {}
        with self._host_mu:
            for i, r in enumerate(rows):
                lanes = self._hosted.get(r)
                into = host
                if lanes is None:
                    lanes, into = self._promoting.get(r), staged
                if lanes is not None:
                    into[i] = (lanes.added.copy(), lanes.taken.copy(), lanes.elapsed_ns)
        pn = np.zeros((len(rows), self.config.nodes, 2), np.int64)
        el = np.zeros(len(rows), np.int64)
        dev = [i for i in range(len(rows)) if i not in host]
        if dev:
            pn[dev], el[dev] = self._scrape_rows([rows[i] for i in dev])
        for i, (a, t, e) in host.items():
            pn[i, :, 0], pn[i, :, 1], el[i] = a, t, e
        for i, (a, t, e) in staged.items():
            np.maximum(pn[i, :, 0], a, out=pn[i, :, 0])
            np.maximum(pn[i, :, 1], t, out=pn[i, :, 1])
            el[i] = max(int(el[i]), e)
        return pn, el

    def _scrape_epoch(self) -> Tuple[int, int]:
        """The device-state version a mirror is stamped with. Plain int
        reads: a bump landing mid-read only makes the mirror look stale."""
        return (self._ticks, self._state_gen)

    def _refresh_scrape_mirror(self) -> None:
        """One window gather re-stamping the scrape mirror. The epoch is
        taken BEFORE the gather: a write racing the gather leaves the
        mirror stamped older than its data (one more refresh), never
        pre-write data stamped as current."""
        k = self._mirror_window
        if k <= 0:
            return
        epoch = self._scrape_epoch()
        pn, elapsed = self.read_rows(np.arange(k, dtype=np.int64))
        self._scrape_mirror = (epoch, pn, elapsed)
        profiling.COUNTERS.inc("scrape_mirror_refreshes")

    def _scrape_rows(self, rows) -> Tuple[np.ndarray, np.ndarray]:
        """(pn[K, N, 2], elapsed[K]) of device rows for the stats and debug
        reads: from the mirror while its epoch holds, else one window
        gather re-arms it (and flags the completer to keep it fresh).
        Rows past the window, or with the mirror off, are gathered."""
        rows = np.asarray(rows, dtype=np.int64)
        if (SCRAPE_MIRROR and rows.size and int(rows.min()) >= 0
                and int(rows.max()) < self._mirror_window):
            mir = self._scrape_mirror
            if mir is None or mir[0] != self._scrape_epoch():
                self._mirror_want = True
                self._refresh_scrape_mirror()
                mir = self._scrape_mirror
            profiling.COUNTERS.inc("scrape_mirror_hits")
            return mir[1][rows], mir[2][rows]
        profiling.COUNTERS.inc("scrape_device_gathers")
        return self.read_rows(rows)

    def row_view(self, row: int) -> Tuple[np.ndarray, int]:
        """One bucket row's full PN state, wherever it lives."""
        pn_rows, elapsed_rows = self._row_states([row])
        return pn_rows[0], int(elapsed_rows[0])

    def _wire_states(self, name: str, row: int, pn: np.ndarray, elapsed: int):
        """One bucket's state as per-slot wire states: one per non-zero
        lane, or one zero-lane state when only the capacity or elapsed is
        known."""
        cap = int(self.directory.cap_base_nt[row])
        sum_a = int(pn[:, 0].sum())
        sum_t = int(pn[:, 1].sum())
        out = [
            wire.from_nanotokens(
                name, cap + sum_a, sum_t, elapsed,
                origin_slot=s, cap_nt=cap,
                lane_added_nt=int(pn[s, 0]), lane_taken_nt=int(pn[s, 1]),
            )
            for s in range(pn.shape[0])
            if pn[s, 0] or pn[s, 1]
        ]
        if not out and (elapsed or cap):
            out.append(
                wire.from_nanotokens(
                    name, cap, 0, elapsed, origin_slot=self.node_slot,
                    cap_nt=cap, lane_added_nt=0, lane_taken_nt=0,
                )
            )
        return out

    def snapshot(self, name: str) -> List[wire.WireState]:
        """One bucket's full PN state as per-slot wire states — the incast
        reply payload: one packet per non-zero node lane."""
        row = self.directory.lookup(name)
        if row is None:
            return []
        pn_rows, elapsed_rows = self._row_states([row])
        if self.directory.lookup(name) != row:
            return []  # evicted mid-read
        return self._wire_states(name, row, pn_rows[0], int(elapsed_rows[0]))

    def snapshot_many(self, names: Sequence[str]) -> Dict[str, List[wire.WireState]]:
        """Batched :meth:`snapshot`: one device gather for many buckets
        (incast replies, anti-entropy and audit fan-ins); host-resident
        rows answer from their lanes."""
        known = [(n, self.directory.lookup(n)) for n in names]
        known = [(n, r) for n, r in known if r is not None]
        if not known:
            return {}
        pn_rows, el_rows = self._row_states([r for _, r in known])
        out: Dict[str, List[wire.WireState]] = {}
        for i, (name, row) in enumerate(known):
            if self.directory.lookup(name) != row:
                continue  # evicted mid-read: don't leak another bucket's state
            states = self._wire_states(name, row, pn_rows[i], int(el_rows[i]))
            if states:
                out[name] = states
        return out

    def tokens(self, name: str) -> int:
        """Whole tokens currently in a bucket (introspection)."""
        return self.tokens_if_known(name) or 0

    def tokens_if_known(self, name: str) -> Optional[int]:
        """``None`` for an unknown bucket, else the whole-token balance.
        The post-read re-lookup closes the eviction race."""
        row = self.directory.lookup(name)
        if row is None:
            return None
        pn_rows, _ = self._row_states([row])
        if self.directory.lookup(name) != row:
            return None
        pn = pn_rows[0]
        base = int(self.directory.cap_base_nt[row])
        nt = base + int(pn[:, 0].sum()) - int(pn[:, 1].sum())
        return max(nt, 0) // NANO

    def release_bucket(self, name: str, timeout: float = 5.0) -> bool:
        """Evict one bucket by name: unbind, drop its host lanes, zero its
        device row, recycle. Its state survives on peers and comes back by
        incast on next use. A pinned row (in-flight take or delta) is
        waited out, never yanked. → False when the name is unknown or stays
        pinned past ``timeout``."""
        deadline = time.monotonic() + timeout
        with self._evict_mu:
            while True:
                row, bound = self.directory.unbind_if_unpinned(name)
                if row is not None:
                    break
                if not bound:
                    return False
                self.flush(timeout=max(0.0, deadline - time.monotonic()))
                if time.monotonic() >= deadline:
                    return False
            self._drop_hosted_rows([row])
            with self._state_mu:
                merge_mod.zero_rows(
                    self.state, torch.tensor([row], dtype=torch.int64, device=self.device)
                )
                self._state_gen += 1
            self.directory.recycle([row])
        return True

    def warmup(self) -> None:
        """Build (or load) the kernel library and launch each kernel once
        on all-padding operands, so the first request pays neither."""
        if not self._cuda:
            return
        _build.lib()
        k = 8
        take = torch.zeros((TAKE_PACK_ROWS, k), dtype=torch.int64, device=self.device)
        # One merge tick of sentinels only, both halves at full length as
        # their live count: the join launches once and drops every entry.
        pad = _FOLD_PAD_ROW + torch.arange(k, device=self.device)
        zeros = torch.zeros(k, dtype=torch.int64, device=self.device)
        dense = (pad, torch.zeros((k, self.config.nodes, 2), dtype=torch.int64,
                                  device=self.device), zeros)
        pairs = (pad, pad, zeros, zeros, pad, zeros)
        # One all-zero datagram plane: rejected by its length, folds nothing.
        e = ingest_ops.MAX_RAW_ENTRIES
        plane = torch.zeros((1, ingest_ops.RAW_PLANE_BYTES), dtype=torch.uint8, device=self.device)
        plan = torch.zeros((1, e), dtype=torch.int32, device=self.device)
        with self._state_mu:
            take_n_batch(self.state, take, self.node_slot)
            join_kernel.tick_join(self.state.pn, self.state.elapsed, dense, pairs)
            ingest_kernel.decode_fold(
                self.state.pn, self.state.elapsed, plane, plan[:, 0].contiguous(),
                plan, plan, torch.zeros((1, e), dtype=torch.bool, device=self.device),
            )
        torch.cuda.synchronize(self.device)

    def flush(self, timeout: float = 5.0) -> bool:
        """Block until all currently queued work has been applied to device
        state AND every completion has fanned out."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._cond:
                idle = (
                    not self._takes
                    and not self._deltas
                    and not self._promote_pending
                    and not self._busy
                )
            if idle:
                with self._pcond:
                    if not self._pending and not self._completing:
                        return True
            time.sleep(0.0005)
        return False

    def stop(self) -> None:
        slo_mod.SENTINEL.unwatch_budget(self._budget_snapshot)
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        with self._pcond:
            self._pcond.notify_all()
        self._thread.join(timeout=5)
        self._completer.join(timeout=5)
        if self._native_store is not None:
            # The native front is detached by now (command.py closes it
            # before engine.stop). Destroying the store frees every lane
            # block, so every view is dropped first; afterwards the
            # engine's reads see the device planes only.
            with self._host_mu:
                self._hosted.clear()
                self._promoting.clear()
                self._hosted_flag[:] = False
            store, self._native_store = self._native_store, None
            self._host_mu = threading.Lock()
            if getattr(self, "_leak_native_store", False):
                # A wedged front pump may still be inside the store.
                log.error("leaking native host store (wedged http pump)")
            else:
                store.destroy()
        self.directory.close()

    # -- completion pipeline ------------------------------------------------

    def _enqueue_completion(self, thunk, keys, groups) -> None:
        """Hand a tick's completion to the completer thread (only the
        grouped, non-deferred tickets belong to the tick). Bounded: a slow
        completer back-pressures dispatch."""
        tickets = [t for key in keys for t in groups[key]]
        with self._pcond:
            while len(self._pending) >= self._dispatch_ahead and not self._stopped:
                self._pcond.wait()
            self._pending.append((thunk, tickets))
            depth = len(self._pending) + (1 if self._completing else 0)
            self._pcond.notify_all()
        profiling.COUNTERS.set_max("dispatch_ahead_depth", depth)

    def _complete_loop(self) -> None:
        while True:
            with self._pcond:
                # Exit only when the FEEDER is done dispatching AND every
                # pending completion ran.
                while not self._pending and not self._feeder_done:
                    self._pcond.wait()
                if not self._pending:
                    return
                thunk, tickets = self._pending.popleft()
                self._completing = True
                self._pcond.notify_all()
            try:
                t0 = time.perf_counter_ns()
                thunk()
                _obs_stage(
                    hist.STAGE_COMPLETION, t0, trace_mod.EV_COMMIT_COMPLETE,
                    len(tickets),
                )
            except Exception:  # pragma: no cover - completer must not die
                log.exception("tick completion failed")
                try:
                    self._fail_tickets(tickets)
                except Exception:
                    log.exception("ticket failure fan-out failed")
            finally:
                with self._pcond:
                    self._completing = False
                    self._pcond.notify_all()
            if SCRAPE_MIRROR and self._mirror_want:
                # Scrapes went stale under load: re-arm the mirror here,
                # off the scrape threads (one window gather a completion,
                # while scrape interest is flagged).
                try:
                    self._refresh_scrape_mirror()
                    self._mirror_want = False
                except Exception:  # pragma: no cover - a gauge refresh
                    log.exception("scrape-mirror refresh failed")

    @property
    def ticks(self) -> int:
        return self._ticks

    @property
    def evictions(self) -> int:
        return self._evictions

    @property
    def scalar_dropped(self) -> int:
        """v1 (reference-peer) deltas dropped while the row's capacity was
        unknown."""
        return self._scalar_dropped

    @property
    def hosted_buckets(self) -> int:
        """Buckets currently served by the host fast path."""
        return len(self._hosted)

    @property
    def host_takes(self) -> int:
        """Takes answered in-process by the host fast path: served in
        Python plus served in C++ by the native front."""
        n = self._host_takes
        store = self._native_store
        if store is not None:
            n += store.native_takes
        return n

    @property
    def promotions(self) -> int:
        """Host → device residency transitions."""
        return self._promotions

    @property
    def demotions(self) -> int:
        """Device → host residency transitions (idle rows)."""
        return self._demotions

    @property
    def audit_ledger(self) -> AuditLedger:
        """patrol-audit admitted-token window ledger (net/audit.py reads
        it on the audit plane's pace)."""
        return self._audit

    def audit_staleness_samples(self, limit: int = 64) -> List[int]:
        """Per-bucket staleness sample for the audit plane: ns the last
        local emission ran ahead of the last remote absorb, over up to
        ``limit`` buckets that have seen both."""
        return [int(v) for v in self.directory.staleness_sample(limit)]

    @property
    def pending_completions(self) -> int:
        with self._pcond:
            return len(self._pending) + (1 if self._completing else 0)

    def backlog(self) -> int:
        """Queued-but-unapplied work rows (takes + deltas)."""
        with self._cond:
            return sum(
                len(t.tickets) if isinstance(t, _TakeFold) else 1
                for t in self._takes
            ) + sum(
                d.n if isinstance(d, _DeltaChunk) else 1 for d in self._deltas
            )

    # -- engine loop --------------------------------------------------------

    def _run(self) -> None:
        try:
            self._run_loop()
        finally:
            with self._pcond:
                self._feeder_done = True
                self._pcond.notify_all()

    def _run_loop(self) -> None:
        while True:
            with self._cond:
                # One predicate for the pause and for work, so a pause
                # raised while this thread waits is never skipped.
                while (self._tick_paused and not self._stopped) or not (
                    self._takes or self._deltas or self._promote_pending
                    or self._gc_due or self._stopped
                ):
                    self._cond.wait()
                if self._stopped and not (self._takes or self._deltas):
                    return
                self._gc_due = False  # this tick runs _maybe_gc below
                if self._commit_blocks_auto:
                    self._auto_size_commit_blocks_locked()
                deltas = self._drain_deltas(MAX_MERGE_ROWS * self._commit_blocks)
                tickets = self._drain_takes(MAX_TAKE_ROWS)
                for t in tickets:
                    t.deferred = False
                self._busy = True
            # Idle demotion: count device-path takes on promoted rows and,
            # at the window's rollover, move quiet rows back to host
            # residency BEFORE the re-route, so the take that ends an idle
            # window is already served from the host.
            if HOST_FASTPATH and self._demotion_capable and self._promoted_rows:
                for t in tickets:
                    if t.row in self._promoted_rows:
                        self._dev_window[t.row] = self._dev_window.get(t.row, 0) + 1
                self._maybe_demote(tickets, deltas)
            # Bucket lifecycle: sweep full idle buckets at the GC window's
            # cadence. This tick's deltas and tickets hold pins, so the
            # sweep leaves their rows alone.
            self._maybe_gc()
            # Residency re-route: a ticket that raced into the device queue
            # while its row was (or became) host-resident is served from
            # the lanes here, the one point every queued take passes, so a
            # row is never served by both paths at once.
            if HOST_FASTPATH and self._hosted and tickets:
                bc: List[wire.WireState] = []
                tickets = [
                    t for t in tickets
                    if not (self._hosted_flag[t.row] and self._host_serve_ticket(t, False, bc))
                ]
                self._emit_broadcasts(bc)
            t_tick0 = time.perf_counter_ns()
            try:
                # Pending promotions join BEFORE the tick's launches, so a
                # take routed device-ward after its row's flag flipped runs
                # against the joined planes.
                if HOST_FASTPATH and self._promote_pending:
                    self._drain_promotions()
                if deltas is not None or tickets:
                    self._apply(deltas, tickets)
                    tick_dur = time.perf_counter_ns() - t_tick0
                    tr = trace_mod.TRACE
                    if tr.enabled:
                        tr.record(
                            trace_mod.EV_TICK, tick_dur,
                            (len(deltas) if deltas is not None else 0) + len(tickets),
                        )
                    for tid, tname in self._tick_traced:
                        trace_mod.SPANS.add(
                            tid, self.node_slot, "merge", tname, t_tick0, tick_dur,
                        )
            except Exception:  # pragma: no cover - engine must never die
                log.exception("engine tick failed")
                trace_mod.anomaly("engine-tick-failed")
                self._fail_tickets(tickets)
            finally:
                self._tick_traced = []
                if deltas is not None:
                    self.directory.unpin_rows(deltas.rows)
                with self._cond:
                    self._busy = False

    def _drain_takes(self, limit: int) -> List[TakeTicket]:
        """Pop up to ``limit`` take-queue ENTRIES (caller holds ``_cond``)
        and return the FLAT ticket list in arrival order; popping an entry
        closes its fold."""
        out: List[TakeTicket] = []
        q = self._takes
        n = 0
        while q and n < limit:
            item = q.popleft()
            n += 1
            if isinstance(item, _TakeFold):
                if self._open_folds.get(item.key) is item:
                    del self._open_folds[item.key]
                out.extend(item.tickets)
            else:
                out.append(item)
        return out

    def _auto_size_commit_blocks_locked(self) -> None:
        """Adaptive commit-block sizing (caller holds ``_cond``): the drain
        width tracks the delta backlog, capped by the measured per-row
        device-commit cost so one launch's completion stays inside
        PATROL_COMMIT_BUDGET_MS."""
        backlog = sum(d.n if isinstance(d, _DeltaChunk) else 1 for d in self._deltas)
        want = max(1, -(-backlog // MAX_MERGE_ROWS)) if backlog else 1
        want = min(want, COMMIT_BLOCKS_MAX)
        ewma = self._commit_row_ns_ewma
        if ewma > 0.0:
            budget_blocks = max(1, int(COMMIT_BUDGET_NS / (ewma * MAX_MERGE_ROWS)))
            want = min(want, budget_blocks)
        if want != self._commit_blocks:
            self._commit_blocks = want
            profiling.COUNTERS.inc("commit_blocks_auto_resized")

    def _drain_deltas(self, limit: int) -> Optional[DeltaArrays]:
        """Pop queued deltas up to a row budget, concatenated into flat
        arrays in arrival order (caller holds ``_cond``). A chunk is never
        split."""
        q = self._deltas
        items: list = []
        total = 0
        while q:
            n = q[0].n if isinstance(q[0], _DeltaChunk) else 1
            if total and total + n > limit:
                break
            items.append(q.popleft())
            total += n
        if not items:
            return None
        rows = np.empty(total, np.int64)
        slots = np.empty(total, np.int64)
        added = np.empty(total, np.int64)
        taken = np.empty(total, np.int64)
        elapsed = np.empty(total, np.int64)
        scalar = np.zeros(total, bool)
        traced = self._tick_traced = []
        at = 0
        for it in items:
            if isinstance(it, _DeltaChunk):
                rows[at : at + it.n] = it.rows
                slots[at : at + it.n] = it.slots
                added[at : at + it.n] = it.added_nt
                taken[at : at + it.n] = it.taken_nt
                elapsed[at : at + it.n] = it.elapsed_ns
                scalar[at : at + it.n] = it.scalar
                at += it.n
            else:
                rows[at] = it.row
                slots[at] = it.slot
                added[at] = it.added_nt
                taken[at] = it.taken_nt
                elapsed[at] = it.elapsed_ns
                scalar[at] = it.scalar
                if it.trace_id:
                    traced.append((it.trace_id, it.trace_name))
                at += 1
        return DeltaArrays(rows, slots, added, taken, elapsed, scalar)

    def _fail_tickets(self, tickets: Sequence[TakeTicket]) -> None:
        unpin = [t.row for t in tickets if not t.deferred and t.complete(0, False)]
        if unpin:
            self.directory.unpin_rows(unpin)

    def _apply(self, deltas: Optional[DeltaArrays], tickets: Sequence[TakeTicket]) -> None:
        """One tick's work: merges first, then takes."""
        if deltas is not None:
            self._apply_merges(deltas)
        if tickets:
            self._apply_takes(tickets)

    def _group_tickets(self, tickets: Sequence[TakeTicket]):
        """Coalesce by (row, rate, count) preserving arrival order; defer
        rows seen with a second key to the next tick (kernel invariant:
        unique rows per batch). Deferred tickets are re-queued at the
        FRONT in arrival order. → (keys, groups)."""
        per_ticket = not _take_fold_enabled()
        groups: Dict[tuple, List[TakeTicket]] = {}
        row_key: Dict[int, tuple] = {}
        deferred: List[TakeTicket] = []
        for t in tickets:
            key = (t.row, t.rate.freq, t.rate.per_ns, t.count)
            held = row_key.get(t.row)
            if held is None:
                row_key[t.row] = key
                groups[key] = [t]
            elif held == key and not per_ticket:
                groups[key].append(t)
            else:
                deferred.append(t)
        if deferred:
            for t in deferred:
                t.deferred = True
            with self._cond:
                self._takes.extendleft(reversed(deferred))
                self._cond.notify()
        return list(groups.keys()), groups

    def _complete_groups(
        self, keys, groups, have, admitted, own_a, own_t, elapsed, sum_a, sum_t
    ) -> None:
        """Fan per-group kernel results out to tickets + broadcast hook.
        Completion releases each ticket's directory pin."""
        broadcasts: List[wire.WireState] = []
        unpin: List[int] = []
        done_ns = time.perf_counter_ns()
        now_clock = self.clock()
        take_hist = hist.TAKE_SERVICE
        for i, key in enumerate(keys):
            ts = groups[key]
            c_nt = ts[0].count * NANO
            admitted_nt = 0
            adm = int(admitted[i])
            if 0 < adm < len(ts):
                profiling.COUNTERS.inc("take_partial_grants")
            outcomes = split_grant(int(have[i]), adm, c_nt, len(ts))
            for t, (remaining, ok) in zip(ts, outcomes):
                if ok:
                    admitted_nt += c_nt
                if t.complete(remaining, ok):
                    unpin.append(t.row)
                    take_hist.record(done_ns - t.t0_ns)
                    if t.trace_id:
                        trace_mod.SPANS.add(
                            t.trace_id, self.node_slot, "take", t.name,
                            t.t0_ns, done_ns - t.t0_ns,
                        )
            cap = int(self.directory.cap_base_nt[ts[0].row])
            if admitted_nt:
                # patrol-audit: book the admitted tokens into the open
                # audit window (the AP-overshoot auditor's own lane).
                self._audit.note(
                    ts[0].name, admitted_nt, cap, ts[0].rate.per_ns, now_clock
                )
            if self.on_broadcast is None:
                continue
            # Replicate full state on every take, success or not; skip
            # only an all-zero state (the incast request marker).
            if own_a[i] or own_t[i] or elapsed[i] or cap:
                broadcasts.append(
                    wire.from_nanotokens(
                        ts[0].name,
                        cap + int(sum_a[i]),
                        int(sum_t[i]),
                        int(elapsed[i]),
                        origin_slot=self.node_slot,
                        cap_nt=cap,
                        lane_added_nt=int(own_a[i]),
                        lane_taken_nt=int(own_t[i]),
                        trace_id=next((t.trace_id for t in ts if t.trace_id), None),
                    )
                )
        if unpin:
            self.directory.unpin_rows(unpin)
        profiling.COUNTERS.inc("take_device_tickets", sum(len(groups[k]) for k in keys))
        self._emit_broadcasts(broadcasts)

    def _apply_merges(self, deltas: DeltaArrays) -> None:
        # Lane merges apply FIRST, then scalar-semantics (reference-peer)
        # deltas through deficit attribution — the conservative order.
        scalar_subset = None
        if deltas.scalar.any():
            sc = deltas.scalar
            scalar_subset = DeltaArrays(*(a[sc] for a in deltas))
            if sc.all():
                self._apply_scalar_merges(scalar_subset)
                return
            deltas = DeltaArrays(*(a[~sc] for a in deltas))
        self._apply_lane_merges(deltas)
        if scalar_subset is not None:
            self._apply_scalar_merges(scalar_subset)

    # -- host → device staging ---------------------------------------------

    def _ship(self, buf: torch.Tensor) -> torch.Tensor:
        """A leased staging tensor → the device operand. CUDA: a
        non-blocking copy from pinned memory; the buffer goes back to the
        pool with an event recorded behind the copy, so it is re-leased
        only once the copy has finished. CPU: a copy (the pool recycles at
        once)."""
        if self._cuda:
            dev = buf.to(self.device, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
        else:
            dev, ev = buf.clone(), None
        self._staging.release(buf, ev)
        return dev

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Ship a host int64 array through a staging buffer."""
        buf = self._staging.lease(arr.shape)
        buf.numpy()[...] = arr
        return self._ship(buf)

    def _stage_tick(self, packed, dense):
        """Both halves of a folded tick in ONE staging lease, shipped with
        ONE copy: a flat int64 buffer holding ``packed`` [6, k], then the
        dense rows [rp], updates [rp, N, 2] and elapsed [rp], each at
        fold_hybrid's padded shape (None for an absent half). → (dense,
        pairs): device views of the live prefixes, cut at the count of
        rows below the ``FOLD_PAD_ROW`` tail, or None."""
        k = packed.shape[1] if packed is not None else 0
        rp = len(dense[0]) if dense is not None else 0
        w = 2 * self.config.nodes
        buf = self._staging.lease((6 * k + rp * (w + 2),))
        host = buf.numpy()
        at = 0
        for arr in ([packed] if k else []) + (list(dense) if rp else []):
            host[at:at + arr.size] = arr.reshape(-1)
            at += arr.size
        dev = self._ship(buf)
        pairs_dev = dense_dev = None
        if k:
            pairs_dev = commit_mod.live_pairs(
                dev[:6 * k].view(6, k), _live(packed[0]), _live(packed[4]),
                self.state.pn.shape[0],
            )
        if rp:
            r, o = _live(dense[0]), 6 * k
            dense_dev = (
                dev[o:o + r],
                dev[o + rp:o + rp + r * w].view(r, self.config.nodes, 2),
                dev[o + rp + rp * w:o + rp + rp * w + r],
            )
        return dense_dev, pairs_dev

    def _device_event(self):
        """An event recorded behind the work just launched (None on CPU,
        where the launch has already run)."""
        if not self._cuda:
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _apply_lane_merges(self, deltas: DeltaArrays) -> None:
        if not len(deltas):
            return
        # A drain wider than one block folds across ALL its blocks and
        # commits with ONE join launch.
        if len(deltas) > MAX_MERGE_ROWS:
            self._commit_coalesced(deltas)
            return
        # Tick-level fold default: ON for a CUDA state (fewer, unique join
        # updates; hot rows collapse to one row-window each), OFF on the
        # CPU, as the reference keyed it on the backend.
        fold_default = "1" if self._cuda else "0"
        if os.environ.get("PATROL_TICK_FOLD", fold_default) != "0":
            t0 = time.perf_counter_ns()
            packed, dense = fold_hybrid(deltas, self.config.nodes, self._row_dense_min)
            _obs_stage(hist.STAGE_FOLD, t0, trace_mod.EV_FOLD, len(deltas))
            t0 = time.perf_counter_ns()
            dense_dev, pairs_dev = self._stage_tick(packed, dense)
            _obs_stage(hist.STAGE_H2D, t0, trace_mod.EV_H2D_PUT, len(deltas))
            t0 = time.perf_counter_ns()
            with self._state_mu:
                join_kernel.tick_join(self.state.pn, self.state.elapsed, dense_dev, pairs_dev)
            _obs_stage(
                hist.STAGE_DISPATCH, t0, trace_mod.EV_COMMIT_DISPATCH, len(deltas)
            )
            self._observe_device_commit(
                "merge_folded" if dense is None else "merge_hybrid", t0, len(deltas)
            )
            self._ticks += 1
            return
        n = len(deltas)
        k = _pad_size(n)
        buf = self._staging.lease((5, k))
        packed = buf.numpy()
        packed[:] = 0  # padding: (row 0, slot 0, zeros) is a no-op max
        packed[0, :n] = deltas.rows
        packed[1, :n] = deltas.slots
        packed[2, :n] = deltas.added_nt
        packed[3, :n] = deltas.taken_nt
        packed[4, :n] = deltas.elapsed_ns
        t0 = time.perf_counter_ns()
        dev = self._ship(buf)
        _obs_stage(hist.STAGE_H2D, t0, trace_mod.EV_H2D_PUT, n)
        t0 = time.perf_counter_ns()
        with self._state_mu:
            merge_batch(self.state, MergeBatch(*dev.unbind(0)))
        _obs_stage(hist.STAGE_DISPATCH, t0, trace_mod.EV_COMMIT_DISPATCH, n)
        self._observe_device_commit("merge_packed", t0, n)
        self._ticks += 1

    def _commit_coalesced(self, deltas: DeltaArrays) -> None:
        """Fold a multi-block drain ONCE across all its blocks and commit
        it with a single join launch (ops/commit.py) — exact because the
        join is commutative and idempotent."""
        blocks_in = -(-len(deltas) // MAX_MERGE_ROWS)
        t0 = time.perf_counter_ns()
        ur, us, ua, ut, er, e = fold_core(deltas)
        _obs_stage(hist.STAGE_FOLD, t0, trace_mod.EV_FOLD, len(deltas))
        n, ne = len(ur), len(er)
        if n <= MAX_MERGE_ROWS:
            # The fold collapsed the drain into one block.
            kernel = "merge_folded"
            t0 = time.perf_counter_ns()
            dev = self._upload(pack_folded(ur, us, ua, ut, er, e))
        else:
            kernel = "commit_blocks"
            shape = commit_mod.commit_shape(n, MAX_MERGE_ROWS)
            buf = self._staging.lease(shape)
            commit_mod.pack_commit_blocks(
                ur, us, ua, ut, er, e, MAX_MERGE_ROWS, out=buf.numpy()
            )
            t0 = time.perf_counter_ns()
            dev = self._ship(buf)
            profiling.COUNTERS.inc(f"commit_ring_j{shape[1]}")
        _obs_stage(hist.STAGE_H2D, t0, trace_mod.EV_H2D_PUT, n)
        t0 = time.perf_counter_ns()
        with self._state_mu:
            commit_mod.commit_packed(self.state, dev, n, ne)  # the live prefix only
        _obs_stage(hist.STAGE_DISPATCH, t0, trace_mod.EV_COMMIT_DISPATCH, n)
        self._observe_device_commit(kernel, t0, n)
        self._ticks += 1
        profiling.COUNTERS.inc("commit_blocks_coalesced", blocks_in)
        profiling.COUNTERS.inc("commit_dispatches")

    def _observe_device_commit(self, kernel: str, t_dispatch_ns: int, n: int) -> None:
        """Record this commit's dispatch→ready duration into
        ``device_commit_ns`` and the per-kernel histogram. The feeder only
        records a CUDA event; the completer waits on it."""
        if not DEVICE_TIMING:
            return
        ev = self._device_event()
        kh = hist.kernel_histogram(kernel)

        def done() -> None:
            if ev is not None:
                ev.synchronize()
            dur = time.perf_counter_ns() - t_dispatch_ns
            hist.STAGE_DEVICE_COMMIT.record(dur)
            kh.record(dur)
            # Adaptive commit sizing input (completer writes, feeder reads
            # — a racy float gauge; a stale read mis-sizes one drain).
            per_row = dur / max(n, 1)
            prev = self._commit_row_ns_ewma
            self._commit_row_ns_ewma = (
                per_row if prev == 0.0 else 0.8 * prev + 0.2 * per_row
            )
            tr = trace_mod.TRACE
            if tr.enabled:
                tr.record(trace_mod.EV_DEVICE_READY, dur, n)

        self._enqueue_completion(done, (), {})

    def _apply_scalar_merges(self, deltas: DeltaArrays) -> None:
        """Deficit-attribution merge of reference-peer deltas, chunked at
        MAX_MERGE_ROWS."""
        t0 = time.perf_counter_ns()
        for lo in range(0, len(deltas), MAX_MERGE_ROWS):
            chunk = DeltaArrays(*(a[lo : lo + MAX_MERGE_ROWS] for a in deltas))
            n = len(chunk)
            k = _pad_size(n)
            buf = self._staging.lease((5, k))
            packed = buf.numpy()
            packed[:] = 0
            packed[0, :n] = chunk.rows
            packed[1, :n] = chunk.slots
            packed[2, :n] = chunk.added_nt
            packed[3, :n] = chunk.taken_nt
            packed[4, :n] = chunk.elapsed_ns
            dev = self._ship(buf)
            with self._state_mu:
                merge_scalar_batch(self.state, MergeBatch(*dev.unbind(0)))
            self._ticks += 1
        self._observe_device_commit("merge_scalar", t0, len(deltas))

    @staticmethod
    def _note_take_coalesce(keys, groups) -> None:
        """Hot-key coalescing receipt for one tick's take pack."""
        multi = sum(1 for key in keys if len(groups[key]) > 1)
        if multi:
            profiling.COUNTERS.inc("take_rows_coalesced", multi)
            tr = trace_mod.TRACE
            if tr.enabled:
                tr.record(
                    trace_mod.EV_TAKE_COALESCE,
                    0,
                    sum(len(groups[key]) for key in keys) - len(keys),
                )

    def _apply_takes(self, tickets: Sequence[TakeTicket]) -> None:
        keys, groups = self._group_tickets(tickets)
        self._note_take_coalesce(keys, groups)
        k = _pad_size(len(keys), hi=MAX_TAKE_ROWS)
        buf = self._staging.lease((TAKE_PACK_ROWS, k))
        packed = buf.numpy()
        packed[:] = 0  # padding rows must stay nreq=0 no-ops
        cap_base = self.directory.cap_base_nt
        created_ns = self.directory.created_ns
        for i, key in enumerate(keys):
            ts = groups[key]
            first = ts[0]
            packed[0, i] = first.row
            # Earliest arrival clock for the group: conservative (refills
            # least); exact when callers share an injected clock tick.
            packed[1, i] = min(t.now_ns for t in ts)
            packed[2, i] = first.rate.freq
            packed[3, i] = first.rate.per_ns
            packed[4, i] = first.count * NANO
            packed[5, i] = len(ts)
            packed[6, i] = cap_base[first.row]
            packed[7, i] = created_ns[first.row]

        t0 = time.perf_counter_ns()
        packed_dev = self._ship(buf)
        _obs_stage(hist.STAGE_H2D, t0, trace_mod.EV_H2D_PUT, len(keys))
        t0 = time.perf_counter_ns()
        with self._state_mu:
            _, out = take_n_batch(self.state, packed_dev, self.node_slot)
        _obs_stage(hist.STAGE_DISPATCH, t0, trace_mod.EV_COMMIT_DISPATCH, len(keys))
        self._ticks += 1
        # The tick's one device→host readback, enqueued right behind the
        # kernel into pinned memory; the completer waits on its event.
        if self._cuda:
            res_buf = self._staging.lease((TAKE_RESULT_ROWS, k))
            res_buf.copy_(out, non_blocking=True)
        else:
            res_buf = out
        ev = self._device_event()
        t_dispatch = t0
        n_keys = len(keys)

        def complete() -> None:
            if ev is not None:
                ev.synchronize()
            res = res_buf.numpy()[:, :n_keys].copy()
            if self._cuda:
                self._staging.release(res_buf)
            if DEVICE_TIMING:
                dur = time.perf_counter_ns() - t_dispatch
                hist.STAGE_DEVICE_TAKE.record(dur)
                hist.kernel_histogram("take_packed").record(dur)
                tr = trace_mod.TRACE
                if tr.enabled:
                    tr.record(trace_mod.EV_DEVICE_READY, dur, n_keys)
            have, admitted, own_a, own_t, elapsed, sum_a, sum_t = res
            self._complete_groups(
                keys, groups, have, admitted, own_a, own_t, elapsed, sum_a, sum_t
            )

        self._enqueue_completion(complete, keys, groups)
