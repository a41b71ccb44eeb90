"""Bucket directory: the host-side name→row mapping for device state.

The reference grows a ``map[string]*Bucket`` on demand under an RWMutex with
double-checked locking (repo.go:189-211). XLA wants static shapes, so device
state is a fixed pool of bucket rows and this directory assigns names to
rows. It also owns the *non-replicated* per-bucket metadata that the
reference keeps inside ``Bucket``:

* ``created_ns`` — node-local creation timestamp, stamped from the injected
  clock at assignment (repo.go:205; never serialized, bucket.go:28-31);
* ``cap_base_nt`` — the lazily-initialized capacity base, the host-side
  mirror of ``if added == 0 { added = capacity }`` (bucket.go:194-196).

Row recycling (the dynamic-keyspace story the reference sidesteps by
growing its map unboundedly, repo.go:200-207): when the pool is spent, the
engine evicts the least-recently-used *unpinned* rows. Eviction is
semantically safe in this protocol — bucket state is soft and re-hydrates
from peers via incast on next use (repo.go:96-106), exactly like a node
restart. Pins are the correctness mechanism: every queued work item
(take ticket, replication delta) pins its row so in-flight work can never
land on a row that was recycled under it. Eviction is three-phase —
``pick_victims`` unbinds names and returns rows in limbo (unreachable:
not looked up, not allocatable), the engine zeroes the device rows, then
``recycle`` returns them to the free list.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

NAME_BYTES_MAX = 256  # wire packets bound names far below this (≤231)

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_U64 = 0xFFFFFFFFFFFFFFFF


def _fnv1a64(b: bytes) -> int:
    """FNV-1a 64-bit — MUST stay bit-identical to fnv1a64() in
    native/patrol_host.cpp: the C++ decoder hashes wire names with it and
    the directory routes lookups on the value (bytes are then verified, so
    a divergence costs only the slow path, never correctness)."""
    h = _FNV_OFFSET
    for byte in b:
        h = ((h ^ byte) * _FNV_PRIME) & _U64
    return h


class DirectoryFullError(RuntimeError):
    """All bucket rows are live and none could be reclaimed."""


class OverloadedError(DirectoryFullError):
    """The engine's memory budget is spent and idle-bucket GC found
    nothing reclaimable: admission of NEW bucket names sheds load with an
    explicit signal (the HTTP front answers 429 ``overloaded``) instead
    of growing state toward an OOM. Subclasses DirectoryFullError so
    every existing full-pool handler already degrades correctly."""


# Bounded tombstone table (bucket lifecycle GC): reclaiming a bucket
# drops its row and directory entry, but the node's OWN PN lane (and the
# refill clock) must survive — it is the one join-decomposition only this
# node can regenerate, and re-creating the lane from zero would let a
# peer's stale echo of the OLD lane values absorb (and thereby erase) new
# spend in the max-join: an admitted-token loss, the exact bug the
# protocol model's seeded `gc-drops-admitted-tokens` mutation
# demonstrates. ~56 B/entry vs a full row's device+host cost — the
# genuine shedding is everything else. LRU-bounded: overflow drops the
# oldest entry, accepting (and documenting) one bucket-capacity-class
# admission skew risk per dropped tombstone if a years-stale echo
# returns — the same anomaly class the reference accepts for every
# partition (README.md:64-76).
TOMBSTONE_CAP = 262144


class BucketDirectory:
    """Thread-safe name→row assignment over a fixed row pool.

    Two lookup structures are kept in sync under one lock:

    * ``_rows`` — the Python ``str → row`` dict (API/take path; the
      analogue of the reference's ``map[string]*Bucket``, repo.go:189-211);
    * a numpy open-addressing hash table over the FNV-1a of the raw name
      bytes, powering :meth:`lookup_hashed_pinned` — the replication rx
      loop resolves whole packet batches to rows WITHOUT materializing one
      Python string (BENCH_r02: string materialization was 85% of decode
      cost, 689 ns/packet vs 59 ns for the C++ codec itself). Hash routes,
      a vectorized zero-padded byte compare verifies, so a collision can
      only demote a lookup to the miss path, never merge two buckets.
    """

    def __init__(self, capacity: int):
        self.capacity = capacity
        # Profiled: feeder-vs-rx contention on this one lock is the
        # directory's scaling risk — surfaced at /debug/pprof/mutex.
        from patrol_tpu_torch.utils import profiling

        self._mu = profiling.ProfiledLock("directory")
        self._rows: Dict[str, int] = {}
        self._names: list = [None] * capacity
        self._next_fresh = 0  # bump allocator; recycling kicks in when spent
        self._free: list = []  # explicitly released rows
        # The native host-lane store keeps pointers to these three arrays
        # (pt_hls_create) for its in-front takes: they are allocated once,
        # at capacity, and never rebound.
        self.created_ns = np.zeros(capacity, dtype=np.int64)
        self.cap_base_nt = np.zeros(capacity, dtype=np.int64)
        self.last_used_ns = np.zeros(capacity, dtype=np.int64)
        # Last-seen rate period per row (first non-zero wins, like the
        # capacity base): the lifecycle sweep's refill projection needs
        # the full rate, and wire deltas never carry per_ns — a row that
        # has only ever been written by replication keeps 0 and is
        # reclaimable only once its standing balance covers capacity.
        self.rate_per_ns = np.zeros(capacity, dtype=np.int64)
        # patrol-audit per-bucket staleness stamps: engine-clock ns of the
        # last REMOTE-lane absorb into the row (any rx ingest path) and of
        # the last LOCAL state emission for it (broadcast). Best-effort
        # racy int64 writes, read only by the audit plane's staleness
        # sampler — a torn stamp skews one sample, never state.
        self.last_remote_ns = np.zeros(capacity, dtype=np.int64)
        self.last_emit_ns = np.zeros(capacity, dtype=np.int64)
        # name → (own_added_nt, own_taken_nt, elapsed_ns, created_ns)
        # tombstones of reclaimed buckets (see TOMBSTONE_CAP), insertion-
        # ordered for LRU bounding. Guarded by _mu.
        self._tombstones: Dict[str, Tuple[int, int, int, int]] = {}
        self.tombstone_cap = TOMBSTONE_CAP
        # In-flight reference counts: a pinned row is never an eviction
        # victim. Guarded by _mu (numpy += is not atomic).
        self.pins = np.zeros(capacity, dtype=np.int32)
        self._bound = np.zeros(capacity, dtype=bool)
        # Raw name bytes per row (zero-padded) for vectorized verification,
        # and the row's FNV hash so unbinding can delete its table entry.
        # _name_words aliases the same memory as u64 words: fancy-indexing
        # cost scales with ELEMENT count, so verifying 32 words instead of
        # 256 bytes makes the batch gather 8× cheaper.
        self.name_bytes = np.zeros((capacity, NAME_BYTES_MAX), dtype=np.uint8)
        self._name_words = self.name_bytes.view(np.uint64)
        self.name_len = np.zeros(capacity, dtype=np.int32)
        self.name_hash = np.zeros(capacity, dtype=np.uint64)
        # The (hash → row) table: C++ (native/patrol_host.cpp pt_dir —
        # reads name_bytes/name_len through shared pointers, resolves a
        # whole batch per call) with a pure-numpy open-addressing fallback
        # when the native library does not load.
        self._ptlib = None
        self._ptdir = -1
        self._closed = False
        from patrol_tpu_torch import native

        lib = native.load()
        if lib is not None:
            hdl = lib.pt_dir_create(capacity, self.name_bytes, self.name_len)
            if hdl >= 0:
                self._ptlib, self._ptdir = lib, hdl
        if self._ptlib is None:
            # numpy open addressing, linear probing, ≤25% load.
            m = 64
            while m < capacity * 4:
                m <<= 1
            self._ht_mask = np.uint64(m - 1)
            self._ht_hash = np.zeros(m, dtype=np.uint64)
            self._ht_row = np.full(m, -1, dtype=np.int32)  # -1 empty, -2 tomb
            self._ht_tombs = 0
            self._ht_maxprobe = 1

    def close(self) -> None:
        """Release the native resolve table (engine.stop calls this).

        Runs under ``_mu``: every native table call holds the lock, so the
        destroy cannot race an in-flight resolve (including rx threads a
        timed-out join left behind). Post-close the directory stays
        FUNCTIONAL minus hash routing: binds/unbinds skip the table and
        hashed lookups miss (string lookups still work) — shutdown-
        concurrent requests degrade instead of raising."""
        with self._mu:
            self._closed = True
            if self._ptlib is not None and self._ptdir >= 0:
                lib, hdl = self._ptlib, self._ptdir
                self._ptlib, self._ptdir = None, -1
                lib.pt_dir_destroy(hdl)

    def __del__(self):  # pragma: no cover - GC-time safety net
        try:
            self.close()
        except Exception:
            pass

    # -- hash table (guarded by _mu) ----------------------------------------

    def _bind_locked(
        self,
        name: str,
        row: int,
        now_ns: int,
        h: Optional[int] = None,
        defer_insert: bool = False,
    ) -> bool:
        """Bind bookkeeping; returns True when the caller must insert the
        (hash, row) into the resolve table (``defer_insert`` batches the
        inserts — one native call per chunk instead of one per bucket)."""
        self._rows[name] = row
        self._names[row] = name
        self._bound[row] = True
        self.created_ns[row] = now_ns
        self.cap_base_nt[row] = 0
        self.rate_per_ns[row] = 0
        self.last_remote_ns[row] = 0
        self.last_emit_ns[row] = 0
        raw = name.encode("utf-8", "surrogateescape")
        self.name_len[row] = len(raw)
        if len(raw) <= NAME_BYTES_MAX:
            self.name_bytes[row] = 0
            if raw:
                self.name_bytes[row, : len(raw)] = np.frombuffer(raw, np.uint8)
            if h is None:
                h = _fnv1a64(raw)  # wire path passes the C++-computed hash
            self.name_hash[row] = h
            if self._closed:
                return False  # post-close: no table, hashed lookups miss
            if defer_insert:
                return True
            if self._ptlib is not None:
                self._ptlib.pt_dir_insert(self._ptdir, h, row)
            else:
                self._ht_insert_locked(h, row)
        else:
            # Unreachable from the wire (packets bound names at 231 bytes);
            # reachable only via hashed lookup, so skip the table.
            self.name_hash[row] = 0
        return False

    def _unbind_row_locked(self, row: int) -> None:
        name = self._names[row]
        if name is not None:
            del self._rows[name]
            self._names[row] = None
        self._bound[row] = False
        if self.name_len[row] <= NAME_BYTES_MAX and not self._closed:
            if self._ptlib is not None:
                self._ptlib.pt_dir_delete(self._ptdir, int(self.name_hash[row]), row)
            else:
                self._ht_delete_locked(int(self.name_hash[row]), row)
        self.name_len[row] = 0

    def _ht_insert_locked(self, h: int, row: int) -> None:
        mask = int(self._ht_mask)
        pos = h & mask
        probes = 1
        tomb = -1
        while True:
            r = int(self._ht_row[pos])
            if r == -1:
                break
            if r == -2 and tomb < 0:
                tomb = pos
            pos = (pos + 1) & mask
            probes += 1
        if tomb >= 0:
            pos = tomb
            self._ht_tombs -= 1
        self._ht_hash[pos] = h
        self._ht_row[pos] = row
        if probes > self._ht_maxprobe:
            self._ht_maxprobe = probes

    def _ht_delete_locked(self, h: int, row: int) -> None:
        mask = int(self._ht_mask)
        pos = h & mask
        for _ in range(self._ht_maxprobe):
            r = int(self._ht_row[pos])
            if r == row:
                self._ht_row[pos] = -2
                self._ht_hash[pos] = 0
                self._ht_tombs += 1
                break
            if r == -1:
                break
            pos = (pos + 1) & mask
        if self._ht_tombs > (mask + 1) // 8:
            self._ht_rebuild_locked()

    def _ht_rebuild_locked(self) -> None:
        self._ht_hash[:] = 0
        self._ht_row[:] = -1
        self._ht_tombs = 0
        self._ht_maxprobe = 1
        for row in np.flatnonzero(self._bound):
            row = int(row)
            if self.name_len[row] <= NAME_BYTES_MAX:
                self._ht_insert_locked(int(self.name_hash[row]), row)

    def lookup_hashed_pinned(
        self,
        hashes: np.ndarray,
        name_buf: np.ndarray,
        name_lens: np.ndarray,
        now_ns: int,
    ) -> np.ndarray:
        """Vectorized batch lookup by wire-name hash: → rows (int64, −1 =
        miss). Found rows are PINNED (callers must unpin_rows) and have
        ``last_used_ns`` refreshed — the fused fast path of the rx loop.

        ``name_buf`` rows must be zero-padded (pt_decode_batch guarantees
        this) and may be either uint8 ``[n, 256]`` or its u64 word view
        ``[n, 32]`` (cheaper to gather — see :attr:`_name_words`); a hash
        hit is confirmed with a whole-row compare, so a 64-bit collision
        or stale table entry degrades to a miss (slow path re-resolves by
        string), never a wrong row.
        """
        n = len(hashes)
        rows = np.full(n, -1, dtype=np.int64)
        if n == 0:
            return rows
        hashes = np.ascontiguousarray(hashes, dtype=np.uint64)
        with self._mu:
            # Implementation choice under the lock: close() also nulls the
            # native handle under it, so resolve can never race teardown.
            if self._ptlib is not None:
                buf8 = (
                    name_buf.view(np.uint8)
                    if name_buf.dtype == np.uint64
                    else name_buf
                )
                buf8 = np.ascontiguousarray(buf8, dtype=np.uint8)
                lens = np.ascontiguousarray(name_lens, dtype=np.int32)
                self._ptlib.pt_dir_resolve(
                    self._ptdir, n, hashes, buf8, lens, rows,
                    self.pins, self.last_used_ns, now_ns,
                )
                return rows
            if self._closed:
                return rows  # all miss; the string slow path still works
            if name_buf.dtype == np.uint64:
                words = name_buf
            else:
                words = np.ascontiguousarray(name_buf).view(np.uint64)
            pos = (hashes & self._ht_mask).astype(np.int64)
            pend = np.flatnonzero(name_lens >= 0)
            for _ in range(self._ht_maxprobe):
                if not pend.size:
                    break
                p = pos[pend]
                slot_r = self._ht_row[p]
                slot_h = self._ht_hash[p]
                hit = (slot_r >= 0) & (slot_h == hashes[pend])
                if hit.any():
                    cand = pend[hit]
                    rr = slot_r[hit].astype(np.int64)
                    good = self.name_len[rr] == name_lens[cand]
                    good &= (self._name_words[rr] == words[cand]).all(axis=1)
                    rows[cand[good]] = rr[good]
                # Resolved either way on a hit (verify-fail ⇒ miss); an
                # empty slot ends the probe chain ⇒ miss. Tombstones and
                # foreign hashes keep probing.
                pend = pend[~(hit | (slot_r == -1))]
                pos[pend] = (pos[pend] + 1) & np.int64(self._ht_mask)
            found = rows >= 0
            if found.any():
                fr = rows[found]
                self.last_used_ns[fr] = now_ns
                np.add.at(self.pins, fr, 1)
        return rows

    def rx_classify(
        self,
        n: int,
        hashes: np.ndarray,
        name_buf: np.ndarray,
        name_lens: np.ndarray,
        added_f: np.ndarray,
        taken_f: np.ndarray,
        elapsed_u: np.ndarray,
        slots: np.ndarray,
        max_slots: int,
        caps: np.ndarray,
        lane_a: np.ndarray,
        lane_t: np.ndarray,
        no_trailer: np.ndarray,
        now_ns: int,
    ):
        """Fused resolve + sanitize + wire-classify over a decoded batch
        (pt_rx_classify): ONE native call replaces the lookup + ~20 numpy
        array passes of the python classify path. Returns
        ``(rows, added_nt, taken_nt, elapsed_ns, scalar_code)`` or ``None``
        when the native table is unavailable (caller uses the numpy path).
        Row codes: ≥0 resolved+PINNED, −1 miss, −2 invalid, −4 folded —
        a same-batch duplicate of (row, slot, code) whose values were
        max-merged into the surviving entry and whose pin was ALREADY
        released inside the native call (skip it entirely). Scalar codes:
        0 lane merge, 1 scalar merge, 2 v1-with-unknown-cap (caller
        re-checks after binding misses)."""
        # Allocations and dtype/contiguity conversions happen OUTSIDE the
        # critical section — only the handle check and the native call
        # touch lock-protected state, and this lock is exactly the
        # feeder-vs-rx contention point the mutex profile watches.
        rows = np.empty(n, np.int64)
        out_a = np.empty(n, np.int64)
        out_t = np.empty(n, np.int64)
        out_e = np.empty(n, np.int64)
        out_s = np.empty(n, np.uint8)
        args = (
            np.ascontiguousarray(hashes[:n], np.uint64),
            np.ascontiguousarray(name_buf[:n], np.uint8),
            np.ascontiguousarray(name_lens[:n], np.int32),
            np.ascontiguousarray(added_f[:n], np.float64),
            np.ascontiguousarray(taken_f[:n], np.float64),
            np.ascontiguousarray(elapsed_u[:n], np.uint64),
            np.ascontiguousarray(slots[:n], np.int64),
            max_slots,
            np.ascontiguousarray(caps[:n], np.int64),
            np.ascontiguousarray(lane_a[:n], np.int64),
            np.ascontiguousarray(lane_t[:n], np.int64),
            np.ascontiguousarray(no_trailer[:n], np.uint8),
        )
        with self._mu:
            if self._ptlib is None or self._closed:
                return None
            self._ptlib.pt_rx_classify(
                self._ptdir, n, *args,
                self.cap_base_nt, self.pins, self.last_used_ns, now_ns,
                rows, out_a, out_t, out_e, out_s,
            )
        return rows, out_a, out_t, out_e, out_s

    def __len__(self) -> int:
        return len(self._rows)

    def lookup(self, name: str) -> Optional[int]:
        # dict reads are atomic under the GIL (cf. the reference's RLock fast
        # path, repo.go:192-198).
        return self._rows.get(name)

    def free_rows(self) -> int:
        """Rows allocatable without eviction (approximate outside _mu)."""
        return len(self._free) + (self.capacity - self._next_fresh)

    def assign(self, name: str, now_ns: int, pin: bool = False) -> Tuple[int, bool]:
        """Get-or-create: returns (row, created). Stamps ``created_ns`` from
        the caller's clock on creation (repo.go:205). ``pin=True`` takes an
        in-flight reference the caller must release via :meth:`unpin_rows`."""
        with self._mu:
            row = self._rows.get(name)
            created = False
            if row is None:
                row = self._alloc_locked()
                self._bind_locked(name, row, now_ns)
                created = True
            self.last_used_ns[row] = now_ns
            if pin:
                self.pins[row] += 1
            return row, created

    def _assign_many_common(
        self, names: Sequence[str], now_ns: int, pin: bool, bind_fresh,
        with_fresh: bool = False,
    ):
        """Shared scaffolding of the batch get-or-create variants: one lock
        acquisition, C-speed dict lookups, and the atomicity contract — if
        the pool cannot absorb every missing name, DirectoryFullError is
        raised with NOTHING assigned or pinned (so the engine can evict
        and retry the whole chunk without leaking pins). ``bind_fresh``
        materializes the per-variant bind: it receives (rows, missing,
        fresh) after the capacity pre-check, must allocate via
        ``_alloc_locked``, fill ``rows[i]``, and record every binding."""
        get = self._rows.get
        with self._mu:
            rows = list(map(get, names))
            missing = [i for i, r in enumerate(rows) if r is None]
            if missing:
                # Count distinct new names before touching anything, so a
                # full pool raises with zero rows assigned or pinned.
                fresh: Dict[str, int] = {names[i]: -1 for i in missing}
                if len(fresh) > self.free_rows():
                    raise DirectoryFullError(
                        f"bucket directory needs {len(fresh)} rows, pool spent"
                    )
                bind_fresh(rows, missing, fresh)
            arr = np.asarray(rows, dtype=np.int64)
            self.last_used_ns[arr] = now_ns
            if pin:
                np.add.at(self.pins, arr, 1)
            if with_fresh:
                # True for every occurrence of a name BOUND by this call —
                # the host fast path's residency-eligibility signal (a
                # cap==0 proxy would mis-host rows that already carry
                # replicated device lanes).
                fresh_mask = np.zeros(len(names), dtype=bool)
                if missing:
                    fresh_mask[np.asarray(missing)] = True
                return arr, fresh_mask
            return arr

    def assign_many(
        self,
        names: Sequence[str],
        now_ns: int,
        pin: bool = False,
        hashes: Optional[Sequence[int]] = None,
        with_fresh: bool = False,
    ):
        """Vectorized get-or-create for a delta chunk (string names).
        ``hashes`` (parallel to ``names``) passes pre-computed FNV values
        through so the wire miss path never re-hashes in Python.
        ``with_fresh=True`` additionally returns a bool mask of the
        entries bound fresh by this call."""

        def bind_fresh(rows, missing, fresh):
            pend_rows: List[int] = []
            for i in missing:
                nm = names[i]
                r = fresh[nm]
                if r < 0:
                    r = self._alloc_locked()
                    fresh[nm] = r
                    if self._bind_locked(
                        nm, r, now_ns,
                        h=None if hashes is None else int(hashes[i]),
                        defer_insert=self._ptlib is not None,
                    ):
                        pend_rows.append(r)
                rows[i] = r
            if pend_rows:
                pr = np.asarray(pend_rows, dtype=np.int32)
                self._ptlib.pt_dir_insert_batch(
                    self._ptdir, self.name_hash[pr], pr, len(pr)
                )

        return self._assign_many_common(
            names, now_ns, pin, bind_fresh, with_fresh=with_fresh
        )

    def assign_many_wire(
        self,
        names: Sequence[str],
        name_rows: np.ndarray,
        name_lens: np.ndarray,
        hashes: np.ndarray,
        now_ns: int,
        pin: bool = False,
    ) -> np.ndarray:
        """:meth:`assign_many` for wire-decoded batches: the zero-padded
        name byte rows, lengths, and FNV hashes are already in hand
        (decode_batch_raw), so fresh binds copy name bytes with ONE
        vectorized assignment and batch-insert into the resolve table —
        no per-name re-encode/zero/frombuffer (the string-bind loop costs
        ~8.7 µs/bind; this path ~1.5 µs). Same atomicity contract."""

        def bind_fresh(rows, missing, fresh):
            new_rows: List[int] = []
            new_src: List[int] = []
            for i in missing:
                nm = names[i]
                r = fresh[nm]
                if r < 0:
                    r = self._alloc_locked()
                    fresh[nm] = r
                    self._rows[nm] = r
                    self._names[r] = nm
                    self._bound[r] = True
                    new_rows.append(r)
                    new_src.append(i)
                rows[i] = r
            nr = np.asarray(new_rows, dtype=np.int64)
            src = np.asarray(new_src, dtype=np.int64)
            self.created_ns[nr] = now_ns
            self.cap_base_nt[nr] = 0
            self.rate_per_ns[nr] = 0
            self.name_len[nr] = name_lens[src]
            self.name_hash[nr] = hashes[src]
            self.name_bytes[nr] = name_rows[src]
            if not self._closed:
                nr32 = nr.astype(np.int32)
                if self._ptlib is not None:
                    self._ptlib.pt_dir_insert_batch(
                        self._ptdir, np.ascontiguousarray(hashes[src]),
                        nr32, len(nr32),
                    )
                else:
                    for h, r in zip(hashes[src], nr32):
                        self._ht_insert_locked(int(h), int(r))

        return self._assign_many_common(names, now_ns, pin, bind_fresh)

    def _alloc_locked(self) -> int:
        if self._free:
            return self._free.pop()
        if self._next_fresh < self.capacity:
            row = self._next_fresh
            self._next_fresh += 1
            return row
        raise DirectoryFullError(
            f"bucket directory full ({self.capacity} rows); "
            "evict or grow the pool"
        )

    def unpin_rows(self, rows) -> None:
        """Release in-flight references taken by ``assign(..., pin=True)``."""
        with self._mu:
            np.subtract.at(self.pins, np.asarray(rows, dtype=np.int64), 1)

    def pick_victims(self, k: int) -> np.ndarray:
        """Phase 1 of eviction: unbind up to ``k`` least-recently-used
        unpinned rows and return them in limbo — unreachable via lookup and
        not yet allocatable. The caller must zero the device rows, then
        :meth:`recycle`. Returns an empty array when everything is pinned."""
        with self._mu:
            eligible = self._bound & (self.pins == 0)
            idx = np.flatnonzero(eligible)
            if idx.size == 0:
                return np.empty(0, dtype=np.int64)
            k = min(k, idx.size)
            if k < idx.size:
                part = np.argpartition(self.last_used_ns[idx], k - 1)[:k]
                victims = idx[part]
            else:
                victims = idx
            for r in victims:
                self._unbind_row_locked(int(r))
            return victims.astype(np.int64)

    def recycle(self, rows) -> None:
        """Phase 3 of eviction: return zeroed limbo rows to the free list."""
        with self._mu:
            self._free.extend(int(r) for r in rows)

    def unbind(self, name: str) -> Optional[int]:
        """Drop a name→row binding, leaving the row in limbo (not free, not
        reachable). The caller zeroes the device row, then :meth:`recycle`s."""
        with self._mu:
            row = self._rows.get(name)
            if row is None:
                return None
            self._unbind_row_locked(row)
            return row

    def unbind_if_unpinned(self, name: str) -> Tuple[Optional[int], bool]:
        """Like :meth:`unbind`, but refuses while in-flight work pins the
        row. → (row-or-None, bound): ``(None, True)`` means "exists but
        pinned, try again"."""
        with self._mu:
            row = self._rows.get(name)
            if row is None:
                return None, False
            if self.pins[row] > 0:
                return None, True
            self._unbind_row_locked(row)
            return row, True

    def release(self, name: str) -> Optional[int]:
        """Drop a name→row binding and recycle the row. The caller must zero
        the device row before reuse (the engine does this eagerly)."""
        with self._mu:
            row = self._rows.get(name)
            if row is None:
                return None
            self._unbind_row_locked(row)
            self._free.append(row)
            return row

    def name_of(self, row: int) -> Optional[str]:
        return self._names[row]

    def bound_names(self, limit: Optional[int] = None) -> list:
        """Names currently bound, most-recently-used first, capped at
        ``limit`` — the anti-entropy digest working set (and the
        shutdown-flush candidate list). MRU-first means a cap on a huge
        directory covers the buckets most likely to hold fresh spend."""
        with self._mu:
            rows = np.flatnonzero(self._bound)
            if limit is not None and len(rows) > limit:
                part = np.argpartition(-self.last_used_ns[rows], limit - 1)[:limit]
                rows = rows[part]
            order = np.argsort(-self.last_used_ns[rows], kind="stable")
            return [self._names[int(r)] for r in rows[order]]

    def init_cap_base(self, row: int, cap_nt: int) -> int:
        """Lazily pin the capacity base for a row: first non-zero capacity
        wins, committed even when the take that carried it fails
        (bucket.go:194-196). Returns the effective base."""
        base = int(self.cap_base_nt[row])
        if base == 0 and cap_nt != 0:
            self.cap_base_nt[row] = cap_nt
            return cap_nt
        return base

    def note_rate(self, row: int, per_ns: int) -> None:
        """Record a row's rate period (first non-zero wins, mirroring the
        capacity base's lazy pin): the lifecycle sweep's refill
        projection needs the full rate, which wire deltas never carry."""
        if per_ns and self.rate_per_ns[row] == 0:
            self.rate_per_ns[row] = per_ns

    def note_rate_many(self, rows: np.ndarray, pers_ns: np.ndarray) -> None:
        """Vectorized :meth:`note_rate` for the batch take paths."""
        if not len(rows):
            return
        rows = np.asarray(rows, dtype=np.int64)
        pers_ns = np.asarray(pers_ns, dtype=np.int64)
        with self._mu:
            unset = (self.rate_per_ns[rows] == 0) & (pers_ns != 0)
            self.rate_per_ns[rows[unset][::-1]] = pers_ns[unset][::-1]

    # -- bucket lifecycle (idle-bucket GC) ----------------------------------

    def gc_candidates(
        self, now_ns: int, idle_ns: int, limit: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Rows eligible for a lifecycle sweep: bound, unpinned, capacity
        known, and idle for at least ``idle_ns`` (0 = pressure mode, any
        bound row qualifies). Returns ``(rows, stamps)`` where ``stamps``
        are the rows' ``last_used_ns`` at selection time —
        :meth:`reclaim_rows` re-verifies them so any take/delta that
        touches a row between the predicate read and the reclaim (it
        refreshes ``last_used_ns`` at assign) voids the verdict. Oldest
        rows first, capped at ``limit`` per sweep."""
        with self._mu:
            eligible = (
                self._bound & (self.pins == 0) & (self.cap_base_nt > 0)
            )
            if idle_ns > 0:
                eligible &= (now_ns - self.last_used_ns) >= idle_ns
            idx = np.flatnonzero(eligible)
            if idx.size > limit:
                part = np.argpartition(self.last_used_ns[idx], limit - 1)[:limit]
                idx = idx[part]
            return idx.astype(np.int64), self.last_used_ns[idx].copy()

    def reclaim_rows(
        self,
        rows: np.ndarray,
        stamps: np.ndarray,
        tombs: Sequence[Tuple[int, int, int]],
    ) -> np.ndarray:
        """Phase 1 of a lifecycle reclaim: re-verify each candidate under
        the lock (still bound, still unpinned, ``last_used_ns`` unchanged
        since :meth:`gc_candidates` — i.e. untouched since the IsZero
        verdict was computed), tombstone the own-lane residue, and unbind.
        Returns the rows actually reclaimed (in limbo — the caller zeroes
        the device rows, then :meth:`recycle_compact`). ``tombs`` carries
        each candidate's ``(own_added_nt, own_taken_nt, elapsed_ns)``."""
        out: List[int] = []
        with self._mu:
            for i, row in enumerate(rows):
                row = int(row)
                if (
                    not self._bound[row]
                    or self.pins[row] != 0
                    or self.last_used_ns[row] != stamps[i]
                ):
                    continue
                a, t, e = tombs[i]
                if a or t or e:
                    name = self._names[row]
                    if name is not None:
                        self._tombstones.pop(name, None)  # refresh LRU slot
                        self._tombstones[name] = (
                            int(a), int(t), int(e), int(self.created_ns[row]),
                        )
                        while len(self._tombstones) > self.tombstone_cap:
                            self._tombstones.pop(next(iter(self._tombstones)))
                self._unbind_row_locked(row)
                out.append(row)
        return np.asarray(out, dtype=np.int64)

    def pop_tombstone(
        self, name: str, row: Optional[int] = None
    ) -> Optional[Tuple[int, int, int, int]]:
        """Consume a reclaimed bucket's tombstone on re-creation:
        → ``(own_added_nt, own_taken_nt, elapsed_ns, created_ns)`` or
        None. When ``row`` is given, the original creation stamp is
        restored onto the row so the refill clock reconstructs exactly
        (a fresh ``created_ns`` would stall or skew the projection)."""
        with self._mu:
            tomb = self._tombstones.pop(name, None)
            if tomb is not None and row is not None and self._names[row] == name:
                self.created_ns[row] = tomb[3]
        return tomb

    def staleness_sample(self, limit: int = 64) -> np.ndarray:
        """patrol-audit per-bucket staleness: for up to ``limit`` bound
        rows carrying BOTH stamps, how far the last local emission ran
        ahead of the last remote absorb (``last_emit_ns − last_remote_ns``,
        clamped ≥ 0) — a bucket we keep broadcasting for without hearing
        remote state back is one whose cluster view is going stale."""
        with self._mu:
            sel = (
                self._bound
                & (self.last_emit_ns > 0)
                & (self.last_remote_ns > 0)
            )
            idx = np.flatnonzero(sel)[: max(0, int(limit))]
            if not idx.size:
                return np.zeros(0, dtype=np.int64)
            return np.maximum(
                self.last_emit_ns[idx] - self.last_remote_ns[idx], 0
            )

    def has_tombstones(self) -> bool:
        """Cheap probe for the bulk-ingest reseed tail (racy read of a
        dict length — a miss only defers a seed to the name's next
        creation, and the common case is an empty table)."""
        return bool(self._tombstones)

    def export_tombstones(self) -> Dict[str, Tuple[int, int, int, int]]:
        """Snapshot the tombstone table for checkpointing (insertion order
        preserved — the LRU bound survives a save/restore roundtrip)."""
        with self._mu:
            return dict(self._tombstones)

    def restore_tombstones(self, entries) -> int:
        """Re-install checkpointed tombstones (``name → (own_added_nt,
        own_taken_nt, elapsed_ns, created_ns)``). Names currently bound
        are skipped — a live row's lanes already carry its spend; max-join
        against an existing tombstone keeps the table monotone if both a
        checkpoint and a post-restore reclaim contributed. Returns entries
        installed."""
        n = 0
        with self._mu:
            for name, tomb in entries.items():
                if name in self._rows:
                    continue
                a, t, e, c = (int(v) for v in tomb)
                old = self._tombstones.pop(name, None)
                if old is not None:
                    a, t, e = max(a, old[0]), max(t, old[1]), max(e, old[2])
                    c = min(c, old[3]) if old[3] else c
                self._tombstones[name] = (a, t, e, c)
                n += 1
                while len(self._tombstones) > self.tombstone_cap:
                    self._tombstones.pop(next(iter(self._tombstones)))
        return n

    def tombstone_stats(self) -> Tuple[int, int]:
        """→ (entries, approximate bytes) for the budget accounting."""
        n = len(self._tombstones)
        return n, n * 56  # 4×int64 + dict/key overhead class

    def recycle_compact(self, rows) -> bool:
        """Phase 3 of a lifecycle reclaim: return zeroed limbo rows to the
        free list and COMPACT it — descending row order, so ``pop()``
        hands out the LOWEST free rows first and the live working set
        stays packed toward the low end of the device planes (lane
        reuse locality: gathers/zero sweeps touch a dense prefix instead
        of a row soup). Returns True when the list was reordered (the
        ``directory_compactions`` signal the engine counts)."""
        with self._mu:
            self._free.extend(int(r) for r in rows)
            free = self._free
            unordered = any(
                free[i] < free[i + 1] for i in range(len(free) - 1)
            )
            if unordered:
                free.sort(reverse=True)
            return unordered

    def init_cap_base_many(self, rows: np.ndarray, caps_nt: np.ndarray) -> None:
        """Vectorized :meth:`init_cap_base` for the bulk paths: rows whose
        base is still 0 adopt the given capacity. Zero caps are no-ops and
        the FIRST occurrence wins on duplicate rows within one batch
        (reversed fancy-assign: numpy writes last-one-wins, so reversing
        restores the single-call first-nonzero-wins semantics,
        bucket.go:194-196)."""
        if not len(rows):
            return
        caps_nt = np.asarray(caps_nt, dtype=np.int64)
        rows = np.asarray(rows, dtype=np.int64)
        nz = caps_nt != 0
        if not nz.all():
            rows, caps_nt = rows[nz], caps_nt[nz]
        if not len(rows):
            return
        with self._mu:
            unset = self.cap_base_nt[rows] == 0
            self.cap_base_nt[rows[unset][::-1]] = caps_nt[unset][::-1]
