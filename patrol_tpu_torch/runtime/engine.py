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

The feeder never synchronises with the device. Each take tick enqueues
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

Not part of this package yet, and absent here: the host fast path (host
lanes, promotion, demotion), lifecycle GC and the memory budget, the
native C++ fold, the certified GCRA / concurrency / quota families (their
entry points raise ``NotImplementedError``), raw wire-v2 ingest, and the
bulk ingest paths of the native receive loop.
"""

from __future__ import annotations

import logging
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
from patrol_tpu_torch.ops import commit as commit_mod
from patrol_tpu_torch.ops import merge as merge_mod
from patrol_tpu_torch.ops import wire
from patrol_tpu_torch.ops.merge import MergeBatch, merge_batch, merge_scalar_batch
from patrol_tpu_torch.ops.rate import Rate
from patrol_tpu_torch.ops.take import (
    TAKE_PACK_ROWS,
    TAKE_RESULT_ROWS,
    split_grant,
    take_n_batch,
)
from patrol_tpu_torch.runtime.bucket import ClockFn, system_clock
from patrol_tpu_torch.runtime.directory import BucketDirectory, DirectoryFullError
from patrol_tpu_torch.utils import histogram as hist
from patrol_tpu_torch.utils import profiling
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

BroadcastFn = Callable[[List[wire.WireState]], None]


class StagingPool:
    """Shape-bucketed reusable host staging tensors (int64) for packed
    device operands and result readbacks — pinned memory when the engine
    runs on CUDA, so copies in both directions are truly asynchronous.

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

    def lease(self, shape) -> torch.Tensor:
        t0 = time.perf_counter_ns()
        key = tuple(shape)
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
            buf = torch.empty(key, dtype=torch.int64, pin_memory=self._pin)
        dur = time.perf_counter_ns() - t0
        hist.STAGE_STAGING_WAIT.record(dur)
        tr = trace_mod.TRACE
        if tr.enabled:
            tr.record(trace_mod.EV_STAGING_LEASE, dur, buf.numel())
        return buf

    def release(self, buf: torch.Tensor, event=None) -> None:
        with self._mu:
            stack = self._free.setdefault(tuple(buf.shape), [])
            if len(stack) < self._max_per_shape:
                stack.append((buf, event))
        tr = trace_mod.TRACE
        if tr.enabled:
            tr.record(trace_mod.EV_STAGING_RECYCLE, 0, buf.numel())


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


def fold_hybrid(deltas: DeltaArrays, nodes: int, row_dense_min: int):
    """Fold-to-dense hybrid split: rows whose tick touches ≥
    ``row_dense_min`` lanes commit their FULL lane plane as one row-window
    join; the sparse remainder rides the pair join. Returns
    (packed|None, (rows, updates, elapsed)|None). The numpy fold of the
    reference (its C++ fold is not part of this package)."""
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
    rp = _pad_size(R, lo=8, hi=MAX_ROW_DENSE)
    rows_p = np.empty(rp, dtype=np.int64)
    rows_p[:R] = d_rows
    rows_p[R:] = _FOLD_PAD_ROW + np.arange(rp - R)  # out of range, unique
    upd_p = np.zeros((rp, nodes, 2), dtype=np.int64)
    upd_p[:R] = upd
    el_p = np.zeros(rp, dtype=np.int64)
    el_p[:R] = e[dense_sel]
    return packed, (rows_p, upd_p, el_p)


class DeviceEngine:
    """Owns device state and the feeder thread. Thread-safe entry points:
    :meth:`submit_take` / :meth:`take`, :meth:`ingest_delta`,
    :meth:`snapshot`, :meth:`tokens_if_known`, :meth:`stop`.

    ``device`` defaults to ``"cuda"``; pass ``"cpu"`` to run the plain
    versions of the kernels on the host (the tests do). Asking for CUDA
    without a card raises."""

    def __init__(
        self,
        config: LimiterConfig,
        node_slot: int = 0,
        clock: ClockFn = system_clock,
        on_broadcast: Optional[BroadcastFn] = None,
        device="cuda",
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
        self._ticks = 0  # kernel ticks issued (observability)
        self._tick_traced: List[Tuple[int, str]] = []
        self._evictions = 0
        self._scalar_dropped = 0
        # Completion pipeline: the feeder DISPATCHES ticks and hands
        # (thunk, tickets) to this queue; the completer waits for the
        # device and fans results out. Bounded by the dispatch-ahead depth.
        self._pcond = profiling.ProfiledCondition("engine.completion")
        self._pending: deque = deque()
        self._completing = False
        self._feeder_done = False
        self._staging = StagingPool(pin=self._cuda)
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
        rows = torch.from_numpy(victims.astype(np.int64)).to(self.device)
        with self._state_mu:
            merge_mod.zero_rows(self.state, rows)
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
        get-or-create miss signal that triggers incast."""
        now = self.clock() if now_ns is None else now_ns
        row, fresh = self._assign_pinned(name, now)
        # First *local* take on the row (capacity still unset) counts as a
        # miss even when replication created the row first.
        created = fresh or int(self.directory.cap_base_nt[row]) == 0
        self.directory.init_cap_base(row, rate.freq * NANO)
        self.directory.note_rate(row, rate.per_ns)
        ticket = TakeTicket(name, row, rate, count, now)
        with self._cond:
            self._enqueue_take_locked(ticket)
            self._cond.notify()
        return ticket, created

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
        """Batched :meth:`submit_take`: ONE directory pass, one capacity
        init, one queue append + wake-up. Returns [(ticket, created), ...]
        in request order, or None when the pool is spent with every row
        pinned."""
        now = self.clock() if now_ns is None else now_ns
        names = list(names)
        res = self._assign_many_pinned(names, now, with_fresh=True)
        if res is None:
            return None
        rows, _bind_fresh = res
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
        tickets = [
            TakeTicket(names[i], int(rows[i]), rates[i], int(counts[i]), now)
            for i in range(len(names))
        ]
        with self._cond:
            for t in tickets:
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
        delta = _Delta(row, slot, added_nt, taken_nt, state.elapsed_ns, scalar)
        if state.trace_id:
            delta.trace_id = state.trace_id
            delta.trace_name = state.name
        with self._cond:
            self._deltas.append(delta)
            self._cond.notify()
        return created

    def gcra_take(self, *args, **kwargs):
        raise NotImplementedError("the certified GCRA family is not ported yet")

    def conc_acquire(self, *args, **kwargs):
        raise NotImplementedError("the certified concurrency family is not ported yet")

    def quota_take(self, *args, **kwargs):
        raise NotImplementedError("the certified hierarchical-quota family is not ported yet")

    def _emit_broadcasts(self, broadcasts: List[wire.WireState]) -> None:
        if not broadcasts or self.on_broadcast is None:
            return
        try:
            self.on_broadcast(broadcasts)
        except Exception:  # pragma: no cover
            log.exception("broadcast hook failed")

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
        """Both planes as host numpy arrays (a copy)."""
        with self._state_mu:
            return state_to_numpy(self.state)

    def row_view(self, row: int) -> Tuple[np.ndarray, int]:
        """One bucket row's full PN state (a device gather)."""
        pn_rows, elapsed_rows = self.read_rows([row])
        return pn_rows[0], int(elapsed_rows[0])

    def snapshot(self, name: str) -> List[wire.WireState]:
        """One bucket's full PN state as per-slot wire states — the incast
        reply payload: one packet per non-zero node lane."""
        row = self.directory.lookup(name)
        if row is None:
            return []
        pn_rows, elapsed_rows = self.read_rows([row])
        if self.directory.lookup(name) != row:
            return []  # evicted mid-read
        pn = pn_rows[0]
        elapsed = int(elapsed_rows[0])
        cap = int(self.directory.cap_base_nt[row])
        sum_a = int(pn[:, 0].sum())
        sum_t = int(pn[:, 1].sum())
        out = []
        for slot in range(pn.shape[0]):
            a, t = int(pn[slot, 0]), int(pn[slot, 1])
            if a or t:
                out.append(
                    wire.from_nanotokens(
                        name, cap + sum_a, sum_t, elapsed,
                        origin_slot=slot, cap_nt=cap,
                        lane_added_nt=a, lane_taken_nt=t,
                    )
                )
        if not out and (elapsed or cap):
            out.append(
                wire.from_nanotokens(
                    name, cap, 0, elapsed, origin_slot=self.node_slot,
                    cap_nt=cap, lane_added_nt=0, lane_taken_nt=0,
                )
            )
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
        pn_rows, _ = self.read_rows([row])
        if self.directory.lookup(name) != row:
            return None
        pn = pn_rows[0]
        base = int(self.directory.cap_base_nt[row])
        nt = base + int(pn[:, 0].sum()) - int(pn[:, 1].sum())
        return max(nt, 0) // NANO

    def warmup(self) -> None:
        """Build (or load) the kernel library and launch each kernel once
        on all-padding operands, so the first request pays neither."""
        if not self._cuda:
            return
        _build.lib()
        k = 8
        take = torch.zeros((TAKE_PACK_ROWS, k), dtype=torch.int64, device=self.device)
        sentinel = np.zeros((6, k), np.int64)
        sentinel[0] = _FOLD_PAD_ROW
        sentinel[4] = _FOLD_PAD_ROW + np.arange(k)
        rows = torch.full((k,), _FOLD_PAD_ROW, dtype=torch.int64, device=self.device)
        upd = torch.zeros((k, self.config.nodes, 2), dtype=torch.int64, device=self.device)
        with self._state_mu:
            take_n_batch(self.state, take, self.node_slot)
            commit_mod.commit_packed(
                self.state, torch.from_numpy(sentinel).to(self.device)
            )
            merge_mod.merge_rows_dense(
                self.state, merge_mod.RowDenseBatch(rows, upd, torch.zeros_like(rows))
            )
        torch.cuda.synchronize(self.device)

    def flush(self, timeout: float = 5.0) -> bool:
        """Block until all currently queued work has been applied to device
        state AND every completion has fanned out."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._cond:
                idle = not self._takes and not self._deltas and not self._busy
            if idle:
                with self._pcond:
                    if not self._pending and not self._completing:
                        return True
            time.sleep(0.0005)
        return False

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        with self._pcond:
            self._pcond.notify_all()
        self._thread.join(timeout=5)
        self._completer.join(timeout=5)
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
                while not (self._takes or self._deltas or self._stopped):
                    self._cond.wait()
                if self._stopped and not (self._takes or self._deltas):
                    return
                if COMMIT_BLOCKS_AUTO:
                    self._auto_size_commit_blocks_locked()
                deltas = self._drain_deltas(MAX_MERGE_ROWS * self._commit_blocks)
                tickets = self._drain_takes(MAX_TAKE_ROWS)
                for t in tickets:
                    t.deferred = False
                self._busy = True
            t_tick0 = time.perf_counter_ns()
            try:
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
        take_hist = hist.TAKE_SERVICE
        for i, key in enumerate(keys):
            ts = groups[key]
            c_nt = ts[0].count * NANO
            adm = int(admitted[i])
            if 0 < adm < len(ts):
                profiling.COUNTERS.inc("take_partial_grants")
            outcomes = split_grant(int(have[i]), adm, c_nt, len(ts))
            for t, (remaining, ok) in zip(ts, outcomes):
                if t.complete(remaining, ok):
                    unpin.append(t.row)
                    take_hist.record(done_ns - t.t0_ns)
                    if t.trace_id:
                        trace_mod.SPANS.add(
                            t.trace_id, self.node_slot, "take", t.name,
                            t.t0_ns, done_ns - t.t0_ns,
                        )
            if self.on_broadcast is None:
                continue
            # Replicate full state on every take, success or not; skip
            # only an all-zero state (the incast request marker).
            cap = int(self.directory.cap_base_nt[ts[0].row])
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
            dense_dev = tuple(self._upload(x) for x in dense) if dense is not None else None
            packed_dev = self._upload(packed) if packed is not None else None
            _obs_stage(hist.STAGE_H2D, t0, trace_mod.EV_H2D_PUT, len(deltas))
            t0 = time.perf_counter_ns()
            with self._state_mu:
                if dense_dev is not None:
                    merge_mod.merge_rows_dense(
                        self.state, merge_mod.RowDenseBatch(*dense_dev)
                    )
                if packed_dev is not None:
                    commit_mod.commit_packed(self.state, packed_dev)
            _obs_stage(
                hist.STAGE_DISPATCH, t0, trace_mod.EV_COMMIT_DISPATCH, len(deltas)
            )
            self._observe_device_commit("merge_folded", t0, len(deltas))
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
        if len(ur) <= MAX_MERGE_ROWS:
            # The fold collapsed the drain into one block.
            kernel = "merge_folded"
            t0 = time.perf_counter_ns()
            dev = self._upload(pack_folded(ur, us, ua, ut, er, e))
        else:
            kernel = "commit_blocks"
            buf = self._staging.lease(commit_mod.commit_shape(len(ur), MAX_MERGE_ROWS))
            commit_mod.pack_commit_blocks(
                ur, us, ua, ut, er, e, MAX_MERGE_ROWS, out=buf.numpy()
            )
            t0 = time.perf_counter_ns()
            dev = self._ship(buf)
        _obs_stage(hist.STAGE_H2D, t0, trace_mod.EV_H2D_PUT, len(ur))
        t0 = time.perf_counter_ns()
        with self._state_mu:
            commit_mod.commit_packed(self.state, dev)
        _obs_stage(hist.STAGE_DISPATCH, t0, trace_mod.EV_COMMIT_DISPATCH, len(ur))
        self._observe_device_commit(kernel, t0, len(ur))
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
