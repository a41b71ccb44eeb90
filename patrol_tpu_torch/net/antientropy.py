"""Heal-time anti-entropy: digest-compare + targeted resync on the
reserved-name control channel.

Why: the protocol's only repair mechanism was *organic* — a bucket
re-converges after a partition when somebody happens to take from it
(full-state broadcast) or cold-misses it (incast). A bucket that went
quiet on one side of a partition stayed divergent indefinitely. This
module closes that hole in the delta-interval spirit of Almeida et al.
(arXiv:1410.2803, ROADMAP item 3): on partition heal or peer (re)join,
exchange *digests* and re-ship only the divergent buckets, with a hard
cap and pacing so a resync can never storm the wire.

Exchange (all packets are zero-state v1 datagrams whose name carries the
payload — reference peers read them as incast requests for impossible
bucket names and stay silent; see net/replication.py CTRL_PREFIX):

1. ``aed`` DIGEST, A→B (triggered when A sees B transition quiet→alive):
   up to 13 ``(fnv1a64(name), state_digest64)`` entries per packet over
   A's bound buckets (capped at ``max_buckets``, newest bindings first).
2. B compares each entry against its own state. Unknown hash or digest
   mismatch → the hash goes into an ``aef`` FETCH packet back to A
   (27 hashes/packet). For mismatched buckets B also *pushes* its own
   lanes to A immediately — one digest direction heals both sides.
3. A answers a FETCH by unicasting the named buckets' full lane state
   (multi-packed, the incast-reply form). Receivers max-join; everything
   is idempotent, so duplicated or reordered resync traffic is harmless.

The state digest covers capacity base, the elapsed G-counter, and every
non-zero PN lane — bit-exactly converged replicas produce bit-equal
digests, so a clean cluster's heal exchange is digests only (no state).

All snapshot/digest work runs on one daemon worker thread per replicator
(never on the rx path); sends are paced (``burst``/``pace_s``) and capped
(``max_packets_per_job``), so the wire cost of a heal is bounded and
observable (``resync_buckets``, ``ae_packets_tx`` in ``stats()``).
"""

from __future__ import annotations

import hashlib
import logging
import struct
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from patrol_tpu_torch.ops import wire
from patrol_tpu_torch.runtime.directory import _fnv1a64
from patrol_tpu_torch.utils import histogram as hist
from patrol_tpu_torch.utils import profiling
from patrol_tpu_torch.utils import trace as trace_mod

log = logging.getLogger("patrol.antientropy")

Addr = Tuple[str, int]

# Names are raw bytes on the wire (surrogateescape round-trip); the
# payload rides inside the name of a zero-state packet.
AE_DIGEST_NAME = "\x00pt!aed"
AE_FETCH_NAME = "\x00pt!aef"
_ENTRY = struct.Struct(">QQ")  # (name_hash, state_digest)
_HASH = struct.Struct(">Q")
_V1_NAME_MAX = wire.MAX_NAME_LENGTH_V1
DIGESTS_PER_PACKET = (_V1_NAME_MAX - len(AE_DIGEST_NAME.encode()) - 1) // _ENTRY.size
FETCHES_PER_PACKET = (_V1_NAME_MAX - len(AE_FETCH_NAME.encode()) - 1) // _HASH.size


def _name_bytes(name: str) -> bytes:
    return name.encode("utf-8", "surrogateescape")


def name_hash64(name: str) -> int:
    return _fnv1a64(_name_bytes(name))


def state_digest(states: Sequence[wire.WireState]) -> int:
    """64-bit digest of one bucket's replicated state: capacity base,
    elapsed, and every non-zero PN lane (sorted by slot). All-zero lanes
    are skipped — an empty bucket's snapshot places a zero lane at the
    *local* node slot, which differs per node for bit-equal state."""
    h = hashlib.blake2b(digest_size=8)
    st0 = states[0]
    h.update(struct.pack(">qq", st0.cap_nt or 0, st0.elapsed_ns))
    lanes = sorted(
        (s.origin_slot or 0, s.lane_added_nt or 0, s.lane_taken_nt or 0)
        for s in states
    )
    for slot, a, t in lanes:
        if a or t:
            h.update(struct.pack(">Hqq", slot, a, t))
    return int.from_bytes(h.digest(), "big")


# One lane as state_digest packs it: ``>Hqq`` (slot, added, taken), 18 bytes.
_LANE = np.dtype([("slot", ">u2"), ("added", ">i8"), ("taken", ">i8")])


def state_digests(cap: np.ndarray, elapsed: np.ndarray, pn: np.ndarray) -> List[int]:
    """:func:`state_digest` of many buckets at once, from their rows
    (capacity bases int64[K], ``elapsed`` int64[K], lanes int64[K, N, 2]):
    the same bytes hashed (the header, then every non-zero lane in slot
    order), packed by numpy rather than a wire state a lane."""
    K, N = pn.shape[:2]
    head = np.empty((K, 2), ">i8")
    head[:, 0], head[:, 1] = cap, elapsed
    lanes = np.empty((K, N), _LANE)
    lanes["slot"] = np.arange(N)
    lanes["added"], lanes["taken"] = pn[:, :, 0], pn[:, :, 1]
    live = pn.any(axis=2)
    heads = head.tobytes()
    packed = lanes[live].tobytes()  # every bucket's live lanes, bucket by bucket
    ends = np.cumsum(live.sum(axis=1)) * _LANE.itemsize
    out, lo = [], 0
    for k, hi in enumerate(ends.tolist()):
        h = hashlib.blake2b(heads[16 * k : 16 * k + 16], digest_size=8)
        h.update(packed[lo:hi])
        out.append(int.from_bytes(h.digest(), "big"))
        lo = hi
    return out


def digests_of(eng, names: Sequence[str]) -> List[Tuple[str, int]]:
    """(name, :func:`state_digest`) of each of ``names`` that holds state,
    in order, from one batched read of their rows (``state_rows``)."""
    kept, cap, elapsed, pn = eng.state_rows(names)
    return list(zip(kept, state_digests(cap, elapsed, pn)))


def _encode_ctrl(name_payload: bytes) -> bytes:
    name = name_payload.decode("utf-8", "surrogateescape")
    return wire.encode(wire.WireState(name=name, added=0.0, taken=0.0, elapsed_ns=0))


def encode_digests(entries: Sequence[Tuple[int, int]]) -> List[bytes]:
    prefix = AE_DIGEST_NAME.encode()
    out = []
    for lo in range(0, len(entries), DIGESTS_PER_PACKET):
        chunk = entries[lo : lo + DIGESTS_PER_PACKET]
        payload = prefix + bytes([len(chunk)]) + b"".join(
            _ENTRY.pack(h, d) for h, d in chunk
        )
        out.append(_encode_ctrl(payload))
    return out


def encode_fetches(hashes: Sequence[int]) -> List[bytes]:
    prefix = AE_FETCH_NAME.encode()
    out = []
    for lo in range(0, len(hashes), FETCHES_PER_PACKET):
        chunk = hashes[lo : lo + FETCHES_PER_PACKET]
        payload = prefix + bytes([len(chunk)]) + b"".join(
            _HASH.pack(h) for h in chunk
        )
        out.append(_encode_ctrl(payload))
    return out


def decode_digest_name(name: str) -> Optional[List[Tuple[int, int]]]:
    raw = _name_bytes(name)[len(AE_DIGEST_NAME.encode()) :]
    if not raw:
        return None
    k = raw[0]
    body = raw[1:]
    if len(body) < k * _ENTRY.size:
        return None
    return [
        _ENTRY.unpack_from(body, i * _ENTRY.size) for i in range(k)
    ]


def decode_fetch_name(name: str) -> Optional[List[int]]:
    raw = _name_bytes(name)[len(AE_FETCH_NAME.encode()) :]
    if not raw:
        return None
    k = raw[0]
    body = raw[1:]
    if len(body) < k * _HASH.size:
        return None
    return [_HASH.unpack_from(body, i * _HASH.size)[0] for i in range(k)]


class AntiEntropy:
    """One per replicator (either backend). The replicator calls
    :meth:`trigger` on a peer's quiet→alive transition and :meth:`handle`
    for received control packets; everything else happens on the worker."""

    def __init__(
        self,
        rep,
        max_buckets: int = 2048,
        burst: int = 16,
        pace_s: float = 0.002,
        min_interval_s: float = 2.0,
        max_packets_per_job: int = 512,
        snapshot_chunk: int = 64,
    ):
        self.rep = rep  # Replicator / NativeReplicator (repo, unicast, log)
        self.max_buckets = max_buckets
        self.burst = burst
        self.pace_s = pace_s
        self.min_interval_s = min_interval_s
        self.max_packets_per_job = max_packets_per_job
        self.snapshot_chunk = snapshot_chunk
        self._mu = threading.Lock()
        self._cond = threading.Condition(self._mu)
        self._jobs: deque = deque()
        self._jobs_cap = 512
        self._last_trigger: Dict[Addr, float] = {}
        # Buckets an in-flight push job is re-shipping per peer — the
        # delta plane (net/delta.py) dedupes interval retransmits against
        # this set so a mid-resync peer never receives the same bucket
        # twice in one repair window.
        self._inflight: Dict[Addr, frozenset] = {}
        self._refresh_timers: Dict[Addr, threading.Timer] = {}
        self._worker: Optional[threading.Thread] = None
        self._stopped = False
        # Counters (read by stats()).
        self.triggers = 0
        self.digests_tx = 0
        self.digests_rx = 0
        self.fetches_tx = 0
        self.fetches_rx = 0
        self.resync_buckets = 0
        self.packets_tx = 0
        self.jobs_dropped = 0

    # -- rx-side entry points (must not block) -------------------------------

    def trigger(self, addr: Addr, force: bool = False) -> None:
        """Peer (re)joined or healed: queue a digest exchange toward it,
        damped to one per ``min_interval_s`` per peer. ``force`` bypasses
        the damping — for operator- or test-initiated resyncs that must
        run regardless of a just-finished exchange."""
        now = time.monotonic()
        with self._mu:
            if (
                not force
                and now - self._last_trigger.get(addr, -1e9) < self.min_interval_s
            ):
                return
            self._last_trigger[addr] = now
            self.triggers += 1
        self._enqueue(("trigger", addr))

    def handle(self, name: str, addr: Addr) -> bool:
        """Dispatch a control-channel packet; True iff it was AE traffic."""
        if name.startswith(AE_DIGEST_NAME):
            entries = decode_digest_name(name)
            if entries:
                with self._mu:
                    self.digests_rx += len(entries)
                self._enqueue(("digest", entries, addr))
            return True
        if name.startswith(AE_FETCH_NAME):
            hashes = decode_fetch_name(name)
            if hashes:
                with self._mu:
                    self.fetches_rx += len(hashes)
                self._enqueue(("fetch", hashes, addr))
            return True
        return False

    def _enqueue(self, job) -> None:
        with self._cond:
            if self._stopped:
                return
            if len(self._jobs) >= self._jobs_cap:
                self.jobs_dropped += 1  # flood backstop; AE is best-effort
                return
            self._jobs.append(job)
            if self._worker is None:
                self._worker = threading.Thread(
                    target=self._run, name="patrol-antientropy", daemon=True
                )
                self._worker.start()
            self._cond.notify()

    # -- worker --------------------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._jobs and not self._stopped:
                    self._cond.wait()
                if self._stopped and not self._jobs:
                    return
                job = self._jobs.popleft()
            try:
                t0 = time.perf_counter_ns()
                if job[0] == "trigger":
                    self._job_trigger(job[1])
                elif job[0] == "digest":
                    self._job_digest(job[1], job[2])
                elif job[0] == "fetch":
                    self._job_fetch(job[1], job[2])
                dur = time.perf_counter_ns() - t0
                hist.AE_JOB.record(dur)
                tr = trace_mod.TRACE
                if tr.enabled:
                    tr.record(
                        trace_mod.EV_AE_PHASE, dur,
                        trace_mod.AE_PHASES.get(job[0], 0),
                    )
            except Exception:  # pragma: no cover - worker must not die
                log.exception("anti-entropy job failed")

    def _engine(self):
        repo = getattr(self.rep, "repo", None)
        return None if repo is None else repo.engine

    def _bound_names(self) -> List[str]:
        eng = self._engine()
        if eng is None:
            return []
        return eng.directory.bound_names(self.max_buckets)

    def _snapshots(self, names: Sequence[str]) -> Dict[str, list]:
        """name → wire states of each of ``names`` that holds state."""
        eng = self._engine()
        snaps: Dict[str, list] = {}
        if eng is None:
            return snaps
        for lo in range(0, len(names), self.snapshot_chunk):
            snaps.update(eng.snapshot_many(names[lo : lo + self.snapshot_chunk]))
        return snaps

    def _send_paced(self, packets: Sequence[bytes], addr: Addr) -> int:
        # Hard cap: a resync can never storm the wire. A burst goes in one
        # send call, then the pace.
        sent = 0
        for lo in range(0, min(len(packets), self.max_packets_per_job), self.burst):
            burst = packets[lo : min(lo + self.burst, self.max_packets_per_job)]
            self.rep.unicast_many([(data, addr) for data in burst])
            sent += len(burst)
            if len(burst) == self.burst:
                time.sleep(self.pace_s)
        with self._mu:
            self.packets_tx += sent
        profiling.COUNTERS.inc("ae_packets_tx", sent)
        if sent < len(packets):
            # The convergence budget truncated a resync: the remainder
            # waits for the next damped round. Freeze the flight recorder
            # — per-job AE phases plus the pipeline timeline show WHY the
            # heal needed more than one budget (patrol-scope anomaly).
            trace_mod.anomaly("convergence-budget-breach")
        return sent

    def _job_trigger(self, addr: Addr) -> None:
        names = self._bound_names()
        eng = self._engine()
        if not names or eng is None:
            return
        entries = [(name_hash64(n), d) for n, d in digests_of(eng, names)]
        if not entries:
            return
        with self._mu:
            self.digests_tx += len(entries)
        self._send_paced(encode_digests(entries), addr)

    def _job_digest(self, entries: List[Tuple[int, int]], addr: Addr) -> None:
        # Compare the sender's digests against our own state; fetch what
        # we lack or disagree on, and push our side of disagreements.
        own_names = self._bound_names()
        own_hashes = {name_hash64(n): n for n in own_names}
        known = [
            (h, d, own_hashes[h]) for h, d in entries if h in own_hashes
        ]
        missing = [h for h, _ in entries if h not in own_hashes]
        snaps = self._snapshots([n for _, _, n in known])
        fetch: List[int] = list(missing)
        push: List[Tuple[str, list]] = []
        for h, d, name in known:
            states = snaps.get(name)
            if states is None:
                fetch.append(h)
                continue
            if state_digest(states) != d:
                fetch.append(h)
                push.append((name, states))
        budget = self.max_packets_per_job
        if fetch:
            with self._mu:
                self.fetches_tx += len(fetch)
            budget -= self._send_paced(encode_fetches(fetch), addr)
        if push and budget > 0:
            self._push_states(push, addr, budget)
        if fetch or push:
            # Divergence found: the resync just shipped may itself have
            # raced in-flight merges, so re-verify with a fresh digest
            # round after the damping interval. A clean exchange schedules
            # nothing — the fixpoint is digest-equality, and the re-verify
            # rate is bounded by min_interval_s per peer.
            self._schedule_refresh(addr)

    def _schedule_refresh(self, addr: Addr) -> None:
        def fire():
            with self._mu:
                self._refresh_timers.pop(addr, None)
                self._last_trigger[addr] = time.monotonic()
                self.triggers += 1
            self._enqueue(("trigger", addr))

        t = threading.Timer(self.min_interval_s, fire)
        t.daemon = True
        with self._mu:
            if self._stopped or addr in self._refresh_timers:
                return
            self._refresh_timers[addr] = t
        t.start()

    def _job_fetch(self, hashes: List[int], addr: Addr) -> None:
        own_hashes = {name_hash64(n): n for n in self._bound_names()}
        names = [own_hashes[h] for h in hashes if h in own_hashes]
        if not names:
            return
        snaps = self._snapshots(names)
        self._push_states(list(snaps.items()), addr, self.max_packets_per_job)

    def inflight_buckets(self, addr: Addr) -> frozenset:
        """Bucket names an in-flight push job is currently re-shipping to
        ``addr`` (empty when none). Read by the delta plane's retransmit
        pass; never blocks."""
        with self._mu:
            return self._inflight.get(addr, frozenset())

    def _push_states(
        self, named_states: List[Tuple[str, list]], addr: Addr, budget: int
    ) -> None:
        """Unicast full lane state for divergent buckets (multi-packed,
        the incast-reply form — always the aggregate dual-payload encode:
        AE only ever runs between lane-capable patrol peers)."""
        packets: List[bytes] = []
        buckets = 0
        for name, states in named_states:
            if len(packets) >= budget:
                break
            buckets += 1
            for st in wire.pack_multi(states):
                packets.append(wire.encode(st))
        with self._mu:
            self.resync_buckets += buckets
            self._inflight[addr] = frozenset(
                name for name, _ in named_states[:buckets]
            )
        profiling.COUNTERS.inc("ae_resync_buckets", buckets)
        if len(packets) > budget:
            trace_mod.anomaly("convergence-budget-breach")
        try:
            self._send_paced(packets[:budget], addr)
        finally:
            with self._mu:
                self._inflight.pop(addr, None)

    # -- lifecycle / observability -------------------------------------------

    def close(self) -> None:
        """Stop the worker before the engine goes: the jobs still queued
        are dropped, and the one in hand (one digest, at most
        ``max_packets_per_job`` paced sends) is waited for, however long it
        takes, since it reads engine state that the node frees next."""
        with self._cond:
            self._stopped = True
            self._jobs.clear()
            self._cond.notify_all()
            worker = self._worker
            timers = list(self._refresh_timers.values())
            self._refresh_timers.clear()
        for t in timers:
            t.cancel()
        if worker is not None:
            worker.join()

    def stats(self) -> dict:
        with self._mu:
            return {
                "resync_buckets": self.resync_buckets,
                "ae_triggers": self.triggers,
                "ae_digests_tx": self.digests_tx,
                "ae_digests_rx": self.digests_rx,
                "ae_fetches_tx": self.fetches_tx,
                "ae_fetches_rx": self.fetches_rx,
                "ae_packets_tx": self.packets_tx,
                "ae_jobs_dropped": self.jobs_dropped,
            }
