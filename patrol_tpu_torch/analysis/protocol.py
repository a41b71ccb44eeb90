"""patrol-protocol — a bounded model checker for the replication protocol
(the port's copy of the JAX package's ``analysis/protocol.py``: the same
model, laws and bounds, with findings anchored in this file; the
differential tests in ``tests/test_torch_protocol.py`` hold the two to
the same schedule counts, codes and witnesses).

The kernel-level provers (patrol-prove, PTP001-005) certify the *algebra*:
join is a commutative/associative/idempotent/monotone lattice merge. They
say nothing about the *protocol* built on top of it — who broadcasts what
when, what incast/resync does, and whether the whole dance still converges
when the network drops, duplicates, reorders, and partitions. ROADMAP
item 5 ("Automatically Verifying Replication-aware Linearizability",
arXiv:2502.19967) calls for machine-checking exactly that; before this
module the only evidence was a handful of cluster tests with ad-hoc drop
filters.

This checker enumerates bounded schedules of a small cluster (2-3 nodes,
a handful of takes, bounded fault events) against a STEP-FOR-STEP Python
model of the protocol:

* node state = per-node PN lanes ``(added[slot], taken[slot])`` over one
  bucket with capacity ``limit`` and no refill (the algebra of
  ops/take.py's no-grant path: admit iff
  ``limit + Σadded − Σtaken ≥ count``, spend into the own lane);
* every take broadcasts the taker's lanes (the full-state datagram) —
  or, on the wire-v2 delta plane (``Semantics.wire``), marks the taker
  dirty for an explicit *flush* event that emits a sequenced
  delta-interval packet per capable peer, acked on delivery (GC),
  retransmitted by the convergence procedure when lost (net/delta.py's
  interval/ack-vector machinery as explicit model events);
* the network is a per-link multiset of in-flight packets supporting
  deliver / duplicate-deliver / drop / reorder (delivery order is free);
* merge is the elementwise lattice max (CvRDT join); a v1 node in a
  mixed cluster ignores delta packets entirely (the control-channel
  invisibility of the real framing);
* heal-time anti-entropy = pairwise state exchange, modelling
  net/antientropy.py's digest+fetch resync as its effect (ship the
  divergent state, join on arrival) — deliberately NOT applied to
  pure-delta clusters, whose own retransmit machinery must converge
  unaided (a broken interval log cannot hide behind AE).

Machine-checked invariants, each a PTC code:

====== ===============================================================
PTC001 convergence-after-heal: after heal + full delivery + pairwise
       anti-entropy, all replicas are identical AND equal to the join
       of every node's state (nothing lost, nothing invented)
PTC002 monotonicity: no replica's state ever decreases in lattice
       order at any step of any schedule
PTC003 AP bound: under sync-within-side delivery, total admitted takes
       ≤ limit × partition-sides (README.md:64-76's degradation
       contract — each side enforces the full limit independently)
PTC004 idempotence at ingest: duplicated and reordered deliveries of
       the same packets land on the same replica state
PTC006 GC token conservation: with refill and idle-bucket GC events in
       the schedule (``Semantics.gc``), total admitted takes never
       exceed ``limit × partition-sides + total refill granted`` —
       reclaiming a bucket must not forget spend in a way that
       re-admits it — and the reclaimed state still heals to the exact
       join (PTC001/PTC002 run over every GC schedule's terminal)
====== ===============================================================

GC semantics (the bucket-lifecycle layer, ROADMAP item 4): a clean
``gc`` event models the engine's reclaim-with-tombstone — the node may
collect the bucket only when its local view is FULL (tokens == limit:
the IsZero predicate), and the collection drops every OTHER replica's
lane copy (recoverable from its writer via the join) while the node's
OWN lane survives (the engine's directory tombstone, re-seeded at
re-creation). Takes mirror the kernel's over-capacity forfeit
(bucket.go:211-213 / ops/take.py): dropping a peer's lane copy can
push the local view past capacity, and the next take forfeits the
excess into its own taken lane — without the clamp even correct GC
would over-admit. The two seeded lifecycle mutations:
``gc-drops-admitted-tokens`` collects the OWN lane too (the naive
zero-everything reclaim — a stale peer echo then absorbs post-reclaim
spend and the conservation bound breaks), and
``gc-treats-collected-as-unknown`` makes a collected node deaf to the
bucket's incoming state (AE/delta must treat collected as ZERO-state,
not unknown — deafness diverges the heal fixpoint).

Elastic-membership semantics (patrol-membership, net/membership.py): a
``membership`` law schedules scripted join/leave/rejoin transitions
(:func:`check_membership`). Lanes are identity, exactly like the real
SlotTable — an address change keeps the lane (``realias``), and the law
decides which lane a (re)joiner writes and what history it keeps. The
clean "epoch" law retires a departed member's lane behind a tombstone (a
new joiner gets the next FREE lane; a rejoiner restores its OWN lane
from its checkpoint), and the invariant is zero admitted-token loss
(PTC006 family): the converged Σtaken covers every take ever admitted,
including the departed member's. The two seeded mutations —
``lane-reuse-without-tombstone`` (a joiner restarts a retired lane from
zero) and ``rejoin-forgets-own-lane`` (a rejoiner spends 0→k below its
own watermark) — both let stale echoes of the old (higher) lane values
absorb the restarted spend in the max-join, breaking conservation.

Trust story (same shape as patrol-prove): the checker must also be able
to FAIL. ``MUTATIONS`` registers seeded protocol bugs — resync that
overwrites instead of joins, merge that sums instead of maxes, takes that
ignore remote lanes, LWW-style assignment — and :func:`check_repo`
asserts every one of them is rejected by at least one invariant. A
checker that passes a mutant is itself a finding (PTC005).

Pure python, no jax; exhaustive within its bounds (several thousand
schedules in well under a second), deterministic by construction — no
randomness anywhere, so CI failures replay exactly.

The schedule space itself is exposed as a reusable generator —
:func:`enumerate_schedules` over :class:`ScheduleBounds` — so downstream
checkers (patrol-lin, stage 8, `analysis/linearizability.py`) consume
the SAME DFS + memoization instead of growing a second schedule space
that drifts. ``Cluster`` subclasses ride along via the
``snapshot``/``restore``/``memo_key``/``_resync`` hooks.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# findings


@dataclasses.dataclass(frozen=True)
class Finding:
    check: str
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.check} {self.message}"


_SELF = "patrol_tpu_torch/analysis/protocol.py"


# ---------------------------------------------------------------------------
# the protocol model


@dataclasses.dataclass(frozen=True)
class Semantics:
    """The model's tunable laws. The clean protocol is the default; each
    mutation flips one law to a plausible-but-wrong alternative.

    ``wire`` selects the data plane: ``"full"`` is the v1 per-take
    full-state broadcast; ``"delta"`` is the wire-v2 delta-interval plane
    (net/delta.py) — takes mark the taker dirty, an explicit *flush*
    event packs the own-lane join-decomposition into a sequenced interval
    packet per capable peer, delivery acks the interval (GC), loss leaves
    it unacked and the convergence procedure retransmits it; ``"mixed"``
    runs the last node as a v1 peer (it ships/receives only full states,
    and *ignores* any delta packet — the control-channel invisibility).
    Delta-plane laws: ``delta_payload`` ships absolute lane values (the
    correct join-decomposition of a max-lattice) or raw increments (the
    classic delta-CRDT bug: duplication inflates state); ``delta_gc``
    garbage-collects intervals on ack or eagerly at send (the GC bug:
    a lost interval is never repaired). ``incast_gate`` models the
    responder-side ReplyGate (net/replication.py): ``"ttl"`` grants ONE
    reply burst per requester per gate window (the bounded schedule is
    one window); ``"bypass"`` answers every duplicate request — the
    cold-start storm amplification the gate exists to bound."""

    merge: str = "join"  # "join" | "sum" | "assign"
    resync: str = "join"  # "join" | "overwrite"
    take: str = "global"  # "global" | "own_only"
    wire: str = "full"  # "full" | "delta" | "mixed"
    delta_payload: str = "absolute"  # "absolute" | "increment"
    delta_gc: str = "acked"  # "acked" | "eager"
    incast_gate: str = "ttl"  # "ttl" | "bypass"
    # Bucket-lifecycle GC law: "off" = no gc events scheduled;
    # "iszero" = clean (collect only when full, own lane tombstoned);
    # "always" = collect regardless of fullness AND drop the own lane
    # (the naive reclaim, no tombstone); "deaf" = clean predicate but a
    # collected node ignores the bucket's incoming state afterward.
    gc: str = "off"  # "off" | "iszero" | "always" | "deaf"
    # Elastic-membership law (patrol-membership, net/membership.py):
    # "off" = no membership transitions scheduled; "epoch" = clean (a
    # departed member's lane is retired behind a tombstone — a new
    # joiner gets the next FREE lane, a rejoiner restores its OWN lane
    # from its checkpoint); "reuse-no-tombstone" = a joiner is handed a
    # retired lane zeroed from scratch (the SlotTable bug the tombstone
    # epoch makes structurally impossible); "forget-own-lane" = a
    # rejoiner returns on its original lane with the lane history
    # zeroed (restart without checkpoint restore onto a live lane).
    membership: str = "off"  # "off" | "epoch" | "reuse-no-tombstone" | "forget-own-lane"


CLEAN = Semantics()
CLEAN_DELTA = Semantics(wire="delta")
CLEAN_MIXED = Semantics(wire="mixed")
CLEAN_GC = Semantics(gc="iszero")
CLEAN_GC_DELTA = Semantics(wire="delta", gc="iszero")
CLEAN_MEMBER = Semantics(membership="epoch")
CLEAN_MEMBER_DELTA = Semantics(wire="delta", membership="epoch")

# Seeded protocol bugs the checker must reject (name → (semantics, what a
# correct checker reports about it)).
MUTATIONS: Dict[str, Semantics] = {
    "resync-overwrites-instead-of-joins": Semantics(resync="overwrite"),
    "merge-sums-instead-of-maxes": Semantics(merge="sum"),
    "merge-assigns-lww": Semantics(merge="assign"),
    "take-ignores-remote-lanes": Semantics(take="own_only"),
    # Wire-v2 delta-plane bugs: shipping increments instead of absolute
    # join-decompositions (duplicated delivery inflates state), and
    # GC'ing an interval before its ack (a dropped interval is lost for
    # good — the plane's retransmit machinery has nothing to re-ship).
    "delta-ships-increments-not-absolutes": Semantics(
        wire="delta", delta_payload="increment"
    ),
    "delta-gc-before-ack": Semantics(wire="delta", delta_gc="eager"),
    # Incast gating (the ROADMAP "grow toward the full wire feature set"
    # item): a responder that ignores the ReplyGate answers EVERY
    # duplicate request in a cold-start retry storm — ⌈lanes/packet⌉ × M
    # packets where the budget is one burst (VERDICT r3 item 8's
    # amplification, closed by replication.ReplyGate).
    "incast-gate-bypass": Semantics(incast_gate="bypass"),
    # Bucket-lifecycle GC bugs (ROADMAP item 4). The naive reclaim drops
    # the node's OWN lane with the bucket: its post-reclaim spend then
    # restarts from zero, a peer's stale echo of the OLD (higher) lane
    # values absorbs it in the max-join, and the forgotten takes
    # re-admit — the conservation bound (PTC006) breaks. The engine's
    # tombstone re-seed is exactly the missing piece (directory.py).
    "gc-drops-admitted-tokens": Semantics(gc="always"),
    # A collected bucket must read as ZERO-state to AE and the delta
    # plane — a node that treats it as unknown (ignores incoming state
    # for it) never reconverges after heal (PTC001).
    "gc-treats-collected-as-unknown": Semantics(gc="deaf"),
    # Elastic-membership bugs (patrol-membership, net/membership.py).
    # Handing a RETIRED lane to a new joiner without the tombstone-epoch
    # handshake restarts the lane's PN counters from zero below the
    # departed member's final values: the joiner's fresh spend is
    # absorbed by any stale echo of the old (higher) lane values in the
    # max-join, and the forgotten takes re-admit — the SlotTable
    # tombstone makes this structurally impossible in the real table.
    "lane-reuse-without-tombstone": Semantics(membership="reuse-no-tombstone"),
    # A rejoiner returning on its ORIGINAL lane must restore that lane's
    # history (checkpoint restore / incast before first spend): spending
    # 0→k below its own pre-restart watermark is absorbed the same way.
    "rejoin-forgets-own-lane": Semantics(membership="forget-own-lane"),
}


def _caps(sem: Semantics, n: int) -> List[bool]:
    """Per-node v2 capability: all (delta), none (full), or all but the
    last node (mixed — the v1 peer)."""
    if sem.wire == "delta":
        return [True] * n
    if sem.wire == "mixed":
        return [i != n - 1 for i in range(n)]
    return [False] * n


class Node:
    """One replica: PN lanes over a single bucket, capacity ``limit``.
    Delta-plane state (used only when the node is v2-capable): ``dirty``
    marks un-flushed own-lane changes, ``unacked[dst]`` maps interval seq
    → recorded payload (None for absolute payloads — a retransmit re-reads
    the current lane, which subsumes), ``sent_a/sent_t`` are the
    increment-mutation baseline."""

    __slots__ = (
        "slot", "n", "limit", "added", "taken", "admitted",
        "dirty", "sent_a", "sent_t", "next_seq", "unacked",
        "reply_granted", "replies_tx", "replies_suppressed",
        "granted", "deaf",
    )

    def __init__(self, slot: int, n: int, limit: int):
        self.slot = slot
        self.n = n
        self.limit = limit
        self.added = [0] * n
        self.taken = [0] * n
        self.admitted = 0
        # Bucket-lifecycle accounting: refill tokens this node granted
        # into its own lane (the PTC006 conservation bound's right side)
        # and the deaf flag of the 'gc-treats-collected-as-unknown'
        # mutation (a collected node ignoring the bucket's state).
        self.granted = 0
        self.deaf = False
        self.dirty = False
        self.sent_a = 0
        self.sent_t = 0
        self.next_seq = {j: 1 for j in range(n) if j != slot}
        self.unacked = {j: {} for j in range(n) if j != slot}
        # Responder-side incast ReplyGate model: requesters granted a
        # reply burst this gate window, and the tx/suppression counters
        # the budget invariant reads.
        self.reply_granted: set = set()
        self.replies_tx = 0
        self.replies_suppressed = 0

    def state(self) -> Tuple[int, ...]:
        return tuple(self.added) + tuple(self.taken)

    def take(self, sem: Semantics) -> bool:
        if sem.take == "own_only":
            tokens = self.limit + self.added[self.slot] - self.taken[self.slot]
        else:
            tokens = self.limit + sum(self.added) - sum(self.taken)
        # Over-capacity forfeit, the kernel's monotone clamp
        # (bucket.go:211-213 ≙ ops/take.py): a view past capacity —
        # reachable once GC drops a peer's lane copy, or under the
        # sum-merge mutation — forfeits the excess into the own taken
        # lane before admission. Without this, even a correct reclaim
        # would admit the forfeited excess (see the PTC006 suite).
        if tokens > self.limit:
            self.taken[self.slot] += tokens - self.limit
            tokens = self.limit
        if tokens >= 1:
            self.taken[self.slot] += 1
            self.admitted += 1
            return True
        return False

    def refill(self) -> bool:
        """Grant one refill token into the own added lane (the model's
        discretized take-path grant commit), capped at capacity; counts
        toward the PTC006 conservation budget."""
        tokens = self.limit + sum(self.added) - sum(self.taken)
        if tokens >= self.limit:
            return False
        self.added[self.slot] += 1
        self.granted += 1
        return True

    def gc(self, sem: Semantics) -> bool:
        """One idle-bucket reclaim attempt under ``sem.gc`` law. Clean
        ("iszero"): collect only when the local view is full, dropping
        every OTHER lane copy (recoverable from its writer via the join)
        and keeping the OWN lane (the engine's tombstone re-seed).
        "always": collect regardless and drop the own lane too (naive).
        "deaf": clean collect, then ignore the bucket's incoming state.
        """
        tokens = self.limit + sum(self.added) - sum(self.taken)
        if sem.gc == "always":
            for s in range(self.n):
                self.added[s] = 0
                self.taken[s] = 0
            return True
        if tokens < self.limit:
            return False  # IsZero predicate: not reconstructible yet
        for s in range(self.n):
            if s != self.slot:
                self.added[s] = 0
                self.taken[s] = 0
        if sem.gc == "deaf":
            self.deaf = True
        return True

    def packet(self) -> Tuple[Tuple[int, int, int], ...]:
        """The broadcast payload: every non-zero lane (the full-state
        datagram carries the sender's whole view)."""
        return tuple(
            (s, self.added[s], self.taken[s])
            for s in range(self.n)
            if self.added[s] or self.taken[s]
        )

    def merge(self, lanes: Iterable[Tuple[int, int, int]], sem: Semantics) -> None:
        if self.deaf:
            # 'gc-treats-collected-as-unknown': the collected bucket's
            # incoming state is dropped instead of joining as zero-state.
            return
        mode = sem.merge
        for s, a, t in lanes:
            if mode == "join":
                if a > self.added[s]:
                    self.added[s] = a
                if t > self.taken[s]:
                    self.taken[s] = t
            elif mode == "sum":
                self.added[s] += a
                self.taken[s] += t
            else:  # "assign" — last writer wins
                self.added[s] = a
                self.taken[s] = t

    def resync_from(self, other: "Node", sem: Semantics) -> None:
        if sem.resync == "overwrite":
            self.added = list(other.added)
            self.taken = list(other.taken)
        else:
            self.merge(other.packet(), sem)


def _ge(a: Tuple[int, ...], b: Tuple[int, ...]) -> bool:
    return all(x >= y for x, y in zip(a, b))


def _join(states: Sequence[Tuple[int, ...]]) -> Tuple[int, ...]:
    return tuple(max(vals) for vals in zip(*states))


class _Violation(Exception):
    def __init__(self, check: str, message: str):
        self.check = check
        self.message = message
        super().__init__(message)


class Cluster:
    """The model cluster: nodes + per-link in-flight packet lists.
    Packets are tagged: ``("full", lanes)`` is the v1 full-state
    datagram; ``("delta", src, seq, lanes)`` is a wire-v2 delta interval
    (delivery to a capable node acks it — the sender GCs the record;
    loss leaves it unacked for the convergence procedure's retransmit)."""

    # Subclass hook (cert-kit family models): the replica class this
    # cluster builds. Swapping it — not copying __init__ — is how a
    # family model changes per-node state shape (QuotaNode's 3-level
    # lanes) while riding every generic path (packet/merge/snapshot/
    # memo/heal) unchanged.
    node_cls = Node

    def __init__(self, n: int, limit: int, sem: Semantics):
        self.sem = sem
        self.nodes = [type(self).node_cls(i, n, limit) for i in range(n)]
        self.caps = _caps(sem, n)
        # links[(src, dst)] = list of in-flight payloads, FIFO by append
        # but deliverable in any order (the reorder model).
        self.links: Dict[Tuple[int, int], List[tuple]] = {
            (i, j): [] for i in range(n) for j in range(n) if i != j
        }
        self.partition: Optional[Dict[int, int]] = None  # node → side

    # -- events --------------------------------------------------------------

    def take(self, i: int) -> None:
        self.nodes[i].take(self.sem)
        self._emit(i)

    def refill(self, i: int) -> None:
        """Bucket-lifecycle refill event: one granted token into node
        i's own lane (no-op at capacity), broadcast like a take."""
        if self.nodes[i].refill():
            self._emit(i)

    def gc(self, i: int) -> None:
        """Bucket-lifecycle reclaim event on node i (``Semantics.gc``
        law). A clean reclaim's emission is its post-collect state —
        usually just the surviving own lane; an all-zero state ships
        nothing (the incast-marker rule, like every emission here)."""
        if self.nodes[i].gc(self.sem):
            self._emit(i)

    def _emit(self, i: int) -> None:
        """Broadcast node i's current state: per-take full-state
        datagrams on the v1 plane, dirty-marking on the delta plane
        (v1 peers in a mixed cluster still get full states now)."""
        node = self.nodes[i]
        pkt = node.packet()
        if self.caps[i]:
            # Delta plane: the emission accumulates (dirty) for capable
            # peers; v1 peers keep getting the classic full state now.
            node.dirty = True
            if pkt:
                for j in range(len(self.nodes)):
                    if j != i and not self.caps[j]:
                        self.links[(i, j)].append(("full", pkt))
            return
        if pkt:
            for j in range(len(self.nodes)):
                if j != i:
                    self.links[(i, j)].append(("full", pkt))

    def _delta_payload(self, node: Node) -> tuple:
        if self.sem.delta_payload == "increment":
            return (
                (
                    node.slot,
                    node.added[node.slot] - node.sent_a,
                    node.taken[node.slot] - node.sent_t,
                ),
            )
        return ((node.slot, node.added[node.slot], node.taken[node.slot]),)

    def flush(self, i: int) -> None:
        """Pack node i's dirty own-lane join-decomposition into one
        sequenced interval per capable peer (the paced flusher event)."""
        node = self.nodes[i]
        if not self.caps[i] or not node.dirty:
            return
        payload = self._delta_payload(node)
        for j in range(len(self.nodes)):
            if j == i or not self.caps[j]:
                continue
            seq = node.next_seq[j]
            node.next_seq[j] = seq + 1
            if self.sem.delta_gc == "acked":
                # Absolute payloads need no history: a retransmit re-reads
                # the (monotone) current lane, which subsumes. Increments
                # must be recorded verbatim.
                node.unacked[j][seq] = (
                    payload if self.sem.delta_payload == "increment" else None
                )
            self.links[(i, j)].append(("delta", i, seq, payload))
        if self.sem.delta_payload == "increment":
            node.sent_a = node.added[i]
            node.sent_t = node.taken[i]
        node.dirty = False

    def incast(self, i: int) -> None:
        """Node i broadcasts a zero-state incast request for the bucket
        (the cold-miss solicitation, repo.go:99-103). The requester-side
        dedup is NOT modeled — the whole point of the responder gate is
        surviving a requester that re-asks in a tight loop."""
        for j in range(len(self.nodes)):
            if j != i:
                self.links[(i, j)].append(("incast", i))

    def _serve_incast(self, j: int, src: int) -> None:
        """Responder j answers an incast request from src: one full-state
        reply burst, gated per requester (replication.ReplyGate — ONE
        burst per (bucket, requester) per TTL; the bounded schedule is
        one TTL window)."""
        node = self.nodes[j]
        if self.sem.incast_gate == "ttl" and src in node.reply_granted:
            node.replies_suppressed += 1
            return
        node.reply_granted.add(src)
        pkt = node.packet()
        if pkt:
            node.replies_tx += 1
            self.links[(j, src)].append(("full", pkt))

    def crosses_partition(self, i: int, j: int) -> bool:
        return (
            self.partition is not None
            and self.partition.get(i) != self.partition.get(j)
        )

    def deliver(self, i: int, j: int, idx: int, dup: bool = False) -> None:
        """Deliver in-flight packet ``idx`` on link i→j (any idx = the
        reorder model). ``dup`` delivers without removing. A partitioned
        link DROPS the packet instead of delivering (UDP, not TCP: the
        datagram is gone, not queued — held-back delivery is modelled by
        simply not choosing to deliver before heal). A dropped delta
        interval stays unacked at the sender."""
        q = self.links[(i, j)]
        pkt = q[idx]
        if not dup:
            q.pop(idx)
        if self.crosses_partition(i, j):
            return
        self._apply_packet(j, pkt)

    def _apply_packet(self, j: int, pkt: tuple, ack: bool = True) -> None:
        if pkt[0] == "incast":
            self._serve_incast(j, pkt[1])
            return
        if pkt[0] == "full":
            self._merge_checked(j, pkt[1])
            return
        _, src, seq, payload = pkt
        if not self.caps[j]:
            return  # a v1 node ignores v2 datagrams (control-channel name)
        if self.sem.delta_payload == "increment":
            node = self.nodes[j]
            for s, a, t in payload:
                node.added[s] += a
                node.taken[s] += t
        else:
            self._merge_checked(j, payload)
        if ack and self.sem.delta_gc == "acked":
            # Ack vector: the receiver acknowledges the interval seq and
            # the sender garbage-collects its record.
            self.nodes[src].unacked[j].pop(seq, None)

    def _merge_checked(self, j: int, lanes: tuple) -> None:
        node = self.nodes[j]
        before = node.state()
        node.merge(lanes, self.sem)
        if not _ge(node.state(), before):
            raise _Violation(
                "PTC002",
                f"merge shrank node {j}'s state {before} -> {node.state()}",
            )

    def drop(self, i: int, j: int, idx: int) -> None:
        self.links[(i, j)].pop(idx)

    def deliver_all(self, within_side_only: bool = False) -> None:
        for (i, j), q in self.links.items():
            if self.crosses_partition(i, j):
                if not within_side_only:
                    q.clear()  # partition drops cross-side datagrams
                continue
            while q:
                self._apply_packet(j, q.pop(0))

    def set_partition(self, sides: Optional[Dict[int, int]]) -> None:
        self.partition = sides
        if sides is not None:
            # In-flight cross-side datagrams are lost to the partition.
            for (i, j), q in self.links.items():
                if self.crosses_partition(i, j):
                    q.clear()

    # -- extended alphabets (subclass hooks) ---------------------------------
    #
    # Kernel-family models add their own schedulable transitions (the
    # GCRA clock advance, the concurrency release) WITHOUT forking the
    # enumerator: `extra_moves` contributes to the move list whenever
    # `ScheduleBounds.extras` has budget left, `apply_extra` replays one
    # such move. Tags must not collide with the core alphabet
    # (take/refill/gc/partition/heal/flush/deliver/dup/drop) — the
    # enumerator dispatches extras by exclusion.

    def extra_moves(self) -> List[tuple]:
        """Family-specific moves currently available (budgeted by
        ``ScheduleBounds.extras``; empty for the base bucket model)."""
        return []

    def apply_extra(self, mv: tuple) -> None:
        raise NotImplementedError(f"unknown extra move {mv!r}")

    # -- snapshot/restore/memoization (subclass hooks) -----------------------
    #
    # The schedule enumerator branches by snapshot → apply-move → restore;
    # subclasses (patrol-lin's LinCluster) carry extra per-node state (the
    # visibility ledger) through `_snapshot_extra`/`_restore_extra` and
    # extend the memoization key through `_memo_extra` — WITHOUT the
    # enumerator knowing anything about them.

    def _clone_empty(self) -> "Cluster":
        """A fresh same-shaped cluster for `restore` to fill. Subclasses
        with extra constructor arguments override this."""
        return Cluster(len(self.nodes), self.nodes[0].limit, self.sem)

    def _snapshot_extra(self):
        """Deep-copied subclass state riding along in every snapshot."""
        return None

    def _restore_extra(self, extra) -> None:
        pass

    def snapshot(self):
        return (
            [
                (
                    list(n.added), list(n.taken), n.admitted,
                    n.dirty, n.sent_a, n.sent_t,
                    {j: dict(d) for j, d in n.unacked.items()},
                    dict(n.next_seq),
                    n.granted, n.deaf,
                )
                for n in self.nodes
            ],
            {k: list(v) for k, v in self.links.items()},
            None if self.partition is None else dict(self.partition),
            self._snapshot_extra(),
        )

    def restore(self, snap) -> "Cluster":
        nodes, links, part, extra = snap
        c = self._clone_empty()
        for node, (a, t, adm, dirty, sa, st_, unacked, seqs, granted, deaf) in zip(
            c.nodes, nodes
        ):
            node.added = list(a)
            node.taken = list(t)
            node.admitted = adm
            node.dirty = dirty
            node.sent_a = sa
            node.sent_t = st_
            node.unacked = {j: dict(d) for j, d in unacked.items()}
            node.next_seq = dict(seqs)
            node.granted = granted
            node.deaf = deaf
        c.links = {k: list(v) for k, v in links.items()}
        c.partition = None if part is None else dict(part)
        c._restore_extra(extra)
        return c

    def _memo_extra(self):
        """Subclass contribution to the memoization key. patrol-lin's
        ledger must appear here: two lane-identical states with different
        visible histories are NOT the same verification state."""
        return None

    def memo_key(self, budget: tuple = ()) -> tuple:
        return (
            tuple(
                n.state()
                + (n.admitted, n.dirty, n.sent_a, n.sent_t, n.granted, n.deaf)
                + tuple(
                    (j, tuple(sorted(d.items())), n.next_seq[j])
                    for j, d in sorted(n.unacked.items())
                )
                for n in self.nodes
            ),
            tuple(
                (lk, tuple(map(tuple, q))) for lk, q in sorted(self.links.items())
            ),
            None
            if self.partition is None
            else tuple(sorted(self.partition.items())),
            tuple(budget),
            self._memo_extra(),
        )

    def _converge_delta(self) -> None:
        """The delta plane's own repair loop: flush dirty lanes and
        retransmit every unacked interval (with current absolute values —
        or the recorded increment) until the interval logs drain. This is
        what must converge WITHOUT anti-entropy: steady-state loss is the
        retransmit machinery's job, AE is only the heal-time backstop."""
        for _ in range(4 * len(self.nodes) + 4):
            moved = False
            for i, node in enumerate(self.nodes):
                if not self.caps[i]:
                    continue
                if node.dirty:
                    self.flush(i)
                    moved = True
                for j in range(len(self.nodes)):
                    if j == i or not self.caps[j]:
                        continue
                    pend = node.unacked[j]
                    if not pend:
                        continue
                    moved = True
                    for seq in list(pend):
                        payload = pend.pop(seq)
                        if payload is None:  # absolute: re-read, subsumes
                            payload = self._delta_payload(node)
                        seq2 = node.next_seq[j]
                        node.next_seq[j] = seq2 + 1
                        node.unacked[j][seq2] = (
                            payload
                            if self.sem.delta_payload == "increment"
                            else None
                        )
                        self.links[(i, j)].append(("delta", i, seq2, payload))
            inflight = any(q for q in self.links.values())
            if not moved and not inflight:
                return
            self.deliver_all()

    def heal_and_converge(self) -> None:
        """Heal + full delivery, then the wire-appropriate repair: the
        delta plane's flush/retransmit loop for capable nodes, and
        pairwise anti-entropy (the model of net/antientropy.py's
        digest+fetch) for full and mixed clusters — pure-delta clusters
        deliberately get NO resync, so a broken interval log cannot hide
        behind AE."""
        self.set_partition(None)
        self.deliver_all()
        before = [n.state() for n in self.nodes]
        if any(self.caps):
            self._converge_delta()
        # Pure-delta clusters get NO resync — their interval log must
        # converge unaided — EXCEPT under bucket-lifecycle GC: a reclaim
        # legitimately drops peer-lane copies whose intervals were
        # already delivered and acked, so nothing in the log re-ships
        # them. Heal-time anti-entropy is the documented re-hydration
        # backstop there (the collected bucket reads as zero-state to
        # AE's digest — not unknown — which is exactly what the
        # 'gc-treats-collected-as-unknown' mutation breaks).
        if self.sem.wire != "delta" or self.sem.gc != "off":
            for a, b in itertools.permutations(range(len(self.nodes)), 2):
                self._resync(b, a)
        expect = _join(before)
        states = [n.state() for n in self.nodes]
        if any(s != states[0] for s in states):
            raise _Violation(
                "PTC001", f"replicas diverged after heal: {states}"
            )
        if states[0] != expect:
            raise _Violation(
                "PTC001",
                f"converged state {states[0]} != join of replicas {expect}",
            )

    def _resync(self, b: int, a: int) -> None:
        """One heal-time anti-entropy exchange: node ``b`` resyncs from
        node ``a`` (digest+fetch modelled as its effect). A hook so
        subclasses observe the shipped state (patrol-lin learns
        visibility from the AE payload exactly like from a datagram)."""
        node = self.nodes[b]
        prev = node.state()
        node.resync_from(self.nodes[a], self.sem)
        if not _ge(node.state(), prev):
            raise _Violation(
                "PTC002",
                f"anti-entropy resync shrank node {b}'s state "
                f"{prev} -> {node.state()}",
            )


# ---------------------------------------------------------------------------
# schedule enumeration


def _partition_layouts(n: int) -> List[Optional[Dict[int, int]]]:
    """All partitions of n nodes into ≥2 sides, plus None (no partition)."""
    layouts: List[Optional[Dict[int, int]]] = [None]
    if n == 2:
        layouts.append({0: 0, 1: 1})
    elif n == 3:
        layouts += [
            {0: 0, 1: 1, 2: 1},
            {0: 0, 1: 0, 2: 1},
            {0: 0, 1: 1, 2: 0},
            {0: 0, 1: 1, 2: 2},
        ]
    return layouts


@dataclasses.dataclass(frozen=True)
class ScheduleBounds:
    """Event budgets for one bounded schedule space. ``takes`` is the
    required take count (every terminal schedule spent them all);
    ``disruptions`` bounds duplicate-deliver/drop events; ``refills``,
    ``gcs`` and ``partitions`` enable the bucket-lifecycle and
    partition/heal move families when non-zero (all OPTIONAL budgets —
    schedules that use fewer are still terminal). ``extras`` budgets the
    cluster's OWN move family (:meth:`Cluster.extra_moves` — e.g. the
    GCRA model's clock ``advance``); zero keeps the core alphabet.
    ``depth`` caps the DFS (None = derived from the budgets, matching
    the historical cap)."""

    n_nodes: int = 2
    limit: int = 2
    takes: int = 3
    disruptions: int = 2
    refills: int = 0
    gcs: int = 0
    partitions: int = 0
    extras: int = 0
    depth: Optional[int] = None


@dataclasses.dataclass
class Terminal:
    """One enumerated schedule endpoint. ``cluster`` is safe to mutate
    (the DFS is done with it — consumers typically heal/converge it).
    ``violation`` carries a :class:`_Violation` raised while APPLYING a
    move (e.g. a shrinking merge); ``depth_capped`` marks schedules cut
    by the DFS depth bound (still valid prefixes worth converging);
    ``events`` is the exact move sequence — every failure replays."""

    cluster: Cluster
    violation: Optional[_Violation] = None
    depth_capped: bool = False
    events: Tuple[tuple, ...] = ()


def enumerate_schedules(
    sem: Semantics = CLEAN,
    bounds: Optional[ScheduleBounds] = None,
    cluster_factory=None,
) -> Iterable[Terminal]:
    """THE schedule enumerator (stage 6 AND stage 8 consume this one
    generator — no second schedule space to drift): DFS over every
    interleaving of {take, flush, deliver-any, duplicate-deliver, drop}
    plus — when the bounds enable them — {refill, gc, partition, heal},
    with state memoization over ``Cluster.memo_key``. Yields a
    :class:`Terminal` per distinct endpoint; a move that raises
    :class:`_Violation` terminates that branch with the violation
    attached. ``cluster_factory(n_nodes, limit, sem)`` lets subclasses
    (patrol-lin's LinCluster) ride the same enumeration."""
    b = bounds if bounds is not None else ScheduleBounds()
    factory = cluster_factory if cluster_factory is not None else Cluster
    root = factory(b.n_nodes, b.limit, sem)
    # Delta mode needs one flush event per take to put data on the wire.
    extra = b.takes + 2 if any(root.caps) else 0
    depth0 = (
        b.depth
        if b.depth is not None
        else b.takes * 3
        + b.disruptions
        + 4
        + extra
        + 2 * (b.refills + b.gcs)
        + 3 * b.partitions
        + 2 * b.extras
    )
    layouts = [lay for lay in _partition_layouts(b.n_nodes) if lay is not None]
    seen: set = set()

    def walk(c: Cluster, budget: tuple, depth: int, trail: tuple):
        (
            takes_left,
            disrupt_left,
            refill_left,
            gc_left,
            part_left,
            extra_left,
        ) = budget
        k = c.memo_key(budget)
        if k in seen:
            return  # schedule prefix reaches an already-checked state
        seen.add(k)
        inflight = [
            (i, j, idx)
            for (i, j), q in c.links.items()
            for idx in range(len(q))
        ]
        if takes_left == 0 and not inflight:
            if refill_left == 0 and gc_left == 0 and extra_left == 0:
                yield Terminal(c, events=trail)
                return
            # Trailing refill/gc events after the last take still change
            # terminal state — yield a COPY (consumers mutate terminals
            # by healing them) and keep exploring those branches below.
            yield Terminal(c.restore(c.snapshot()), events=trail)
        if depth == 0:
            # Depth cap: converge what we have (still a valid schedule).
            yield Terminal(c, depth_capped=True, events=trail)
            return
        moves: List[tuple] = []
        if takes_left:
            moves += [("take", i) for i in range(len(c.nodes))]
        if refill_left:
            moves += [("refill", i) for i in range(len(c.nodes))]
        if gc_left:
            moves += [("gc", i) for i in range(len(c.nodes))]
        if part_left and c.partition is None:
            moves += [("partition", lay) for lay in layouts]
        if extra_left:
            moves += c.extra_moves()
        if c.partition is not None:
            moves.append(("heal",))
        # Delta plane: the paced flusher is its own schedulable event.
        for i, node in enumerate(c.nodes):
            if c.caps[i] and node.dirty:
                moves.append(("flush", i))
        # Deliver the HEAD of each link (plus the tail when reordering is
        # possible) — delivering only head/tail spans the reorder space
        # for the 2-deep links these bounds produce.
        for (i, j), q in c.links.items():
            if q:
                moves.append(("deliver", i, j, 0))
                if len(q) > 1:
                    moves.append(("deliver", i, j, len(q) - 1))
                if disrupt_left:
                    moves.append(("dup", i, j, 0))
                    moves.append(("drop", i, j, 0))
        for mv in moves:
            c2 = c.restore(c.snapshot())
            nxt = budget
            try:
                if mv[0] == "take":
                    c2.take(mv[1])
                    nxt = (takes_left - 1,) + budget[1:]
                elif mv[0] == "refill":
                    c2.refill(mv[1])
                    nxt = budget[:2] + (refill_left - 1,) + budget[3:]
                elif mv[0] == "gc":
                    c2.gc(mv[1])
                    nxt = budget[:3] + (gc_left - 1,) + budget[4:]
                elif mv[0] == "partition":
                    c2.set_partition(dict(mv[1]))
                    nxt = budget[:4] + (part_left - 1,) + budget[5:]
                elif mv[0] == "heal":
                    c2.set_partition(None)
                elif mv[0] == "flush":
                    c2.flush(mv[1])
                elif mv[0] == "deliver":
                    c2.deliver(mv[1], mv[2], mv[3])
                elif mv[0] == "dup":
                    c2.deliver(mv[1], mv[2], mv[3], dup=True)
                    nxt = (takes_left, disrupt_left - 1) + budget[2:]
                elif mv[0] == "drop":
                    c2.drop(mv[1], mv[2], mv[3])
                    nxt = (takes_left, disrupt_left - 1) + budget[2:]
                else:
                    # Family-specific move (Cluster.extra_moves) — the
                    # subclass replays it; the budget keeps the DFS finite.
                    c2.apply_extra(mv)
                    nxt = budget[:5] + (extra_left - 1,)
            except _Violation as v:
                yield Terminal(c2, violation=v, events=trail + (mv,))
                return  # one witness per state is enough
            yield from walk(c2, nxt, depth - 1, trail + (mv,))

    yield from walk(
        root,
        (b.takes, b.disruptions, b.refills, b.gcs, b.partitions, b.extras),
        depth0,
        (),
    )


def check_ap_bound(
    n_nodes: int = 3, limit: int = 2, extra_takes: int = 2, sem: Semantics = CLEAN
) -> List[Finding]:
    """PTC003 (+ PTC001/002 at heal): under sync-within-side delivery,
    enumerate every partition layout × every take sequence long enough to
    exhaust every side, and check ``admitted ≤ limit × sides``. The
    sync-within-side discipline (deliver all intra-side packets after
    each take) is the README.md:64-76 contract's premise: replication
    *within* a side keeps up, so each side enforces the limit exactly;
    cross-side datagrams are dropped by the partition."""
    findings: List[Finding] = []
    takes_total = limit * n_nodes + extra_takes
    for layout in _partition_layouts(n_nodes):
        sides = 1 if layout is None else len(set(layout.values()))
        for seq in itertools.product(range(n_nodes), repeat=takes_total):
            c = Cluster(n_nodes, limit, sem)
            c.set_partition(layout)
            try:
                for i in seq:
                    c.take(i)
                    # Sync-within-side includes the delta flusher: a
                    # capable node's take reaches its side's peers via
                    # the flushed interval, not a per-take datagram.
                    c.flush(i)
                    c.deliver_all(within_side_only=True)
                admitted = sum(node.admitted for node in c.nodes)
                if admitted > limit * sides:
                    raise _Violation(
                        "PTC003",
                        f"admitted {admitted} > limit {limit} × {sides} "
                        f"side(s) (layout={layout}, takes={seq})",
                    )
                c.heal_and_converge()
            except _Violation as v:
                findings.append(Finding(v.check, _SELF, 0, v.message))
                break  # one witness per layout is enough
    return findings


def check_async_schedules(
    n_nodes: int = 2,
    limit: int = 2,
    takes: int = 3,
    max_disruptions: int = 2,
    sem: Semantics = CLEAN,
) -> Tuple[int, List[Finding]]:
    """PTC001/PTC002 under fully-adversarial delivery: every terminal of
    :func:`enumerate_schedules` (the {take, deliver-any,
    duplicate-deliver, drop} interleavings within the event bounds) is
    healed and converged. Monotonicity is checked at every merge;
    convergence-to-join at every terminal.
    Returns (schedules explored, findings)."""
    findings: List[Finding] = []
    explored = 0
    bounds = ScheduleBounds(
        n_nodes=n_nodes, limit=limit, takes=takes, disruptions=max_disruptions
    )
    for term in enumerate_schedules(sem, bounds):
        explored += 1
        if term.violation is None:
            try:
                term.cluster.heal_and_converge()
                continue
            except _Violation as v:
                findings.append(Finding(v.check, _SELF, 0, v.message))
        else:
            findings.append(
                Finding(term.violation.check, _SELF, 0, term.violation.message)
            )
        break  # one witness is enough
    return explored, findings


def _snapshot(c: Cluster):
    return c.snapshot()


def _restore(template: Cluster, snap) -> Cluster:
    return template.restore(snap)


def check_idempotence(
    n_nodes: int = 2, limit: int = 3, takes: int = 3, sem: Semantics = CLEAN
) -> List[Finding]:
    """PTC004: for every take sequence, delivering each broadcast once, in
    reverse order, and with every packet duplicated must all land on the
    same replica state (dup/reorder tolerance at ingest)."""
    findings: List[Finding] = []
    for seq in itertools.product(range(n_nodes), repeat=takes):
        base = Cluster(n_nodes, limit, sem)
        for i in seq:
            base.take(i)
            base.flush(i)  # delta mode: put the interval on the wire
        snap = _snapshot(base)

        def run(order, dup):
            c = _restore(base, snap)
            try:
                for (i, j), q in c.links.items():
                    idxs = list(range(len(q)))
                    if order == "reversed":
                        idxs = idxs[::-1]
                    for idx in idxs:
                        c._apply_packet(j, q[idx], ack=False)
                        if dup:
                            c._apply_packet(j, q[idx], ack=False)
                    q.clear()
            except _Violation as v:
                findings.append(Finding(v.check, _SELF, 0, v.message))
            return [n.state() for n in c.nodes]

        once = run("fifo", dup=False)
        rev = run("reversed", dup=False)
        duped = run("fifo", dup=True)
        if once != rev or once != duped:
            findings.append(
                Finding(
                    "PTC004",
                    _SELF,
                    0,
                    f"dup/reorder delivery diverged (takes={seq}): "
                    f"{once} vs {rev} vs {duped}",
                )
            )
            break
    return findings


def check_incast_gating(
    n_nodes: int = 3, limit: int = 4, requests: int = 3,
    sem: Semantics = CLEAN,
) -> List[Finding]:
    """Incast gating (the ROADMAP wire-feature-set growth item): a
    requester re-asking in a tight loop — ``requests`` duplicate incast
    broadcasts inside one gate TTL — must draw AT MOST ONE reply burst
    from each responder (PTC003's budget family: the amplification bound
    replication.ReplyGate enforces), the suppressed duplicates must be
    observable, and the replies themselves must still converge the
    requester to the join of all state (PTC001) without ever shrinking
    it (PTC002, via the checked merge)."""
    findings: List[Finding] = []
    c = Cluster(n_nodes, limit, sem)
    try:
        # Give every responder distinguishable state to reply with.
        for j in range(1, n_nodes):
            c.take(j)
            c.take(j)
            c.flush(j)
        c.deliver_all()
        for _ in range(requests):
            c.incast(0)
            c.deliver_all()  # serve the requests, deliver the replies
        for j in range(1, n_nodes):
            node = c.nodes[j]
            if node.replies_tx > 1:
                raise _Violation(
                    "PTC003",
                    f"incast reply storm: node {j} answered "
                    f"{node.replies_tx} reply bursts for {requests} "
                    "duplicate requests inside one gate TTL (responder "
                    "budget is 1 — the ReplyGate was bypassed)",
                )
            if (
                sem.incast_gate == "ttl"
                and node.replies_suppressed != requests - node.replies_tx
            ):
                raise _Violation(
                    "PTC003",
                    f"incast gate accounting broken on node {j}: "
                    f"{node.replies_suppressed} suppressed for "
                    f"{requests} requests / {node.replies_tx} granted",
                )
        expect = _join([n.state() for n in c.nodes])
        if c.nodes[0].state() != expect:
            raise _Violation(
                "PTC001",
                f"incast requester did not converge to the join: "
                f"{c.nodes[0].state()} != {expect}",
            )
        c.heal_and_converge()
    except _Violation as v:
        findings.append(Finding(v.check, _SELF, 0, v.message))
    return findings


def check_gc_conservation(
    n_nodes: int = 2, limit: int = 2, events: int = 5,
    sem: Semantics = CLEAN_GC,
) -> List[Finding]:
    """PTC006 (+ PTC001/PTC002 at heal): enumerate every schedule of
    {take, refill, gc} events over every partition layout, with
    sync-within-side delivery (the same discipline as the AP-bound
    suite, including the delta flusher), and check after EVERY event
    that total admitted takes stay within
    ``limit × partition-sides + total refill granted`` — the
    conservation budget idle-bucket GC must respect: a reclaim may
    forget state only when that state is refill-balanced (IsZero), so
    forgotten spend can never be re-admitted. Every terminal schedule
    then heals and must converge to the exact join (a reclaim's dropped
    peer-lane copies re-enter from their writers; the node's own lane
    survived the collect)."""
    findings: List[Finding] = []
    kinds = ("take", "refill", "gc")
    alphabet = [(k, i) for k in kinds for i in range(n_nodes)]
    for layout in _partition_layouts(n_nodes):
        sides = 1 if layout is None else len(set(layout.values()))
        budget_sides = limit * sides
        for seq in itertools.product(range(len(alphabet)), repeat=events):
            c = Cluster(n_nodes, limit, sem)
            c.set_partition(layout)
            try:
                for ev in seq:
                    kind, i = alphabet[ev]
                    if kind == "take":
                        c.take(i)
                    elif kind == "refill":
                        c.refill(i)
                    else:
                        c.gc(i)
                    c.flush(i)
                    c.deliver_all(within_side_only=True)
                    admitted = sum(n.admitted for n in c.nodes)
                    granted = sum(n.granted for n in c.nodes)
                    if admitted > budget_sides + granted:
                        raise _Violation(
                            "PTC006",
                            f"GC lost admitted tokens: {admitted} takes "
                            f"admitted > limit {limit} × {sides} side(s) "
                            f"+ {granted} granted (layout={layout}, "
                            f"schedule={[alphabet[e] for e in seq]})",
                        )
                c.heal_and_converge()
            except _Violation as v:
                findings.append(Finding(v.check, _SELF, 0, v.message))
                break  # one witness per layout is enough
    return findings


def _membership_conservation(
    c: Cluster, total_admitted: int, scenario: str
) -> None:
    """Zero admitted-token loss across membership churn (the PTC006
    family): every admitted take debited one token into SOME lane, and
    lanes only grow — so the converged Σtaken must cover every take ever
    admitted, including the departed member's. A membership law that
    lets a lane restart below its watermark breaks this: the restarted
    spend is absorbed by stale echoes of the old (higher) values."""
    n = len(c.nodes)
    converged = c.nodes[0].state()
    total_taken = sum(converged[n:])
    if total_taken < total_admitted:
        raise _Violation(
            "PTC006",
            f"membership churn lost admitted tokens ({scenario}): "
            f"converged taken {total_taken} < {total_admitted} admitted "
            "— a lane restarted below its watermark and stale echoes "
            "absorbed the difference",
        )


def check_membership(sem: Semantics = CLEAN_MEMBER) -> List[Finding]:
    """Elastic-membership transitions (patrol-membership): scripted
    join/leave/rejoin/address-change scenarios over the model cluster,
    each driving the dangerous window — a (re)joiner spending BEFORE its
    first sync — and checking zero admitted-token loss (PTC006 family)
    plus exact convergence (PTC001/PTC002 via heal).

    Lanes are identity here, exactly like the real SlotTable: an address
    change is the no-op case (``realias`` keeps the lane, so the state
    is untouched by construction — scenario 2's rejoiner IS the
    new-address rolling restart), and the membership law decides only
    *which lane* a (re)joiner writes and *what history* that lane keeps.

    * Scenario 1 — leave + new joiner: a member exhausts the bucket and
      leaves; a new node joins unsynced and spends. Clean ("epoch"): the
      joiner gets the next FREE lane — both spends survive the join.
      "reuse-no-tombstone": the joiner restarts the RETIRED lane from
      zero — its spend is absorbed by the departed member's stale
      echoes and the conservation bound breaks.
    * Scenario 2 — rolling restart (leave + rejoin under a new address
      on the ORIGINAL lane): clean restores the lane from the
      checkpoint, so post-restart spend lands ABOVE the watermark;
      "forget-own-lane" restarts at zero below it.
    * Both terminals heal twice: the second heal must be a fixpoint
      (membership events are idempotent facts — a replayed announce
      changes nothing)."""
    findings: List[Finding] = []
    limit = 2

    # -- scenario 1: leave, then a NEW member joins unsynced ----------------
    c = Cluster(3, limit, sem)
    try:
        # Boot members are lanes {0, 1}; lane 2 is unallocated (its node
        # exists in the model but neither takes nor receives until join).
        c.take(1)
        c.take(1)  # node 1 admits `limit`, exhausting the bucket
        c.flush(1)
        while c.links[(1, 0)]:
            c.deliver(1, 0, 0)  # intra-member delivery only
        departed_admitted = c.nodes[1].admitted
        # Node 1 leaves. Its lane is retired; in-flight packets from it
        # (the (1, 2) link) are now STALE ECHOES of the departed member.
        reused = sem.membership == "reuse-no-tombstone"
        if reused:
            # The seeded bug: the joiner is handed the retired lane,
            # zeroed — no tombstone, no epoch handshake. Its admitted
            # counter restarts too (a different process), so the
            # departed member's takes ride `departed_admitted`.
            c.nodes[1] = Node(1, 3, limit)
            joiner = 1
        else:
            joiner = 2  # clean: next FREE lane; tombstoned lane 1 keeps
            # its final values forever (join-absorbed, never reassigned)
        # The dangerous window: the joiner spends before its first sync.
        c.take(joiner)
        c.take(joiner)
        c.flush(joiner)
        c.heal_and_converge()
        total_admitted = sum(n.admitted for n in c.nodes) + (
            departed_admitted if reused else 0
        )
        _membership_conservation(c, total_admitted, "leave+join")
        snap = [n.state() for n in c.nodes]
        c.heal_and_converge()  # idempotence: replayed announces are no-ops
        if [n.state() for n in c.nodes] != snap:
            raise _Violation(
                "PTC004", "membership heal is not a fixpoint (leave+join)"
            )
    except _Violation as v:
        findings.append(Finding(v.check, _SELF, 0, v.message))

    # -- scenario 2: rolling restart — rejoin on the ORIGINAL lane ----------
    c = Cluster(2, limit, sem)
    try:
        c.take(1)  # one admitted take below capacity
        c.flush(1)
        c.deliver_all()
        old = c.nodes[1]
        departed_admitted = old.admitted
        # Node 1 checkpoints, leaves, and rejoins under a NEW address on
        # its original lane (the realias+tombstone-epoch handshake of the
        # real SlotTable — address is not lane, so the model's slot stays
        # 1). A fresh process: admitted restarts, lane history per law.
        fresh = Node(1, 2, limit)
        if sem.membership != "forget-own-lane":
            fresh.added = list(old.added)  # checkpoint restore: the lane
            fresh.taken = list(old.taken)  # resumes AT its watermark
        c.nodes[1] = fresh
        # Unsynced post-restart spend.
        c.take(1)
        c.take(1)
        c.flush(1)
        c.heal_and_converge()
        total_admitted = departed_admitted + sum(n.admitted for n in c.nodes)
        _membership_conservation(c, total_admitted, "rolling-restart")
        snap = [n.state() for n in c.nodes]
        c.heal_and_converge()
        if [n.state() for n in c.nodes] != snap:
            raise _Violation(
                "PTC004",
                "membership heal is not a fixpoint (rolling-restart)",
            )
    except _Violation as v:
        findings.append(Finding(v.check, _SELF, 0, v.message))

    return findings


# ---------------------------------------------------------------------------
# entry points


def check_protocol(sem: Semantics = CLEAN) -> List[Finding]:
    """Every invariant suite over one semantics. Clean → must be empty;
    mutated → must NOT be."""
    findings: List[Finding] = []
    findings += check_ap_bound(n_nodes=2, limit=2, extra_takes=2, sem=sem)
    findings += check_ap_bound(n_nodes=3, limit=1, extra_takes=1, sem=sem)
    _, async_findings = check_async_schedules(sem=sem)
    findings += async_findings
    findings += check_idempotence(sem=sem)
    findings += check_incast_gating(sem=sem)
    if sem.gc != "off":
        # Bucket-lifecycle schedules only exist under a gc law; every
        # non-GC semantics (clean or mutated) is covered by the suites
        # above without paying the extra enumeration.
        findings += check_gc_conservation(sem=sem)
    if sem.membership != "off":
        # Elastic-membership transitions only exist under a membership
        # law (same gating shape as the gc suite).
        findings += check_membership(sem=sem)
    # De-duplicate identical findings from overlapping suites.
    seen = set()
    out = []
    for f in findings:
        key = (f.check, f.message)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out


# ---------------------------------------------------------------------------
# Cert-kit kernel-family models (stage 9 targets, stage 6 clean runs).
#
# The GCRA, concurrency and hierarchical-quota kernels (ops/gcra.py,
# ops/concurrency.py, ops/hierquota.py) ride the SAME PN lanes and the
# SAME join as the bucket, so their protocol models subclass Cluster
# and reuse every generic path — packet/merge/snapshot/memo/heal —
# changing only the admission rule (``take``) and, where the family
# needs one, an extra schedulable move (``extra_moves``). Each family
# carries a small laws dataclass whose non-clean values are the
# family's SEEDED MUTATIONS, registered in ops/obligations.py and
# executed by scripts/protocol_repo.py's verdicts (the cert stage that
# pins them in the reference, PTK002, is not ported yet); the clean laws
# run in stage 6's check_repo like every other clean preset.


@dataclasses.dataclass(frozen=True)
class GcraLaws:
    """``view="own"`` is the seeded mutation: conformance tested against
    the node's OWN TAT lane only, ignoring merged remote watermarks —
    every replica re-admits the full burst even when fully synced."""

    view: str = "global"  # "global" | "own"


@dataclasses.dataclass(frozen=True)
class ConcLaws:
    """``release="uncapped"`` is the seeded mutation: releases skip the
    own-lane clamp, so a release-without-acquire drives ADDED past TAKEN
    and the cluster invents capacity that was never held."""

    release: str = "clamped"  # "clamped" | "uncapped"


@dataclasses.dataclass(frozen=True)
class QuotaLaws:
    """``debit="leaf-only"`` is the seeded mutation: admission and debit
    against the leaf (user) level only — tenants collectively overspend
    the global pool the moment path limits differ, and the monotone
    lanes can never unwind it."""

    debit: str = "path"  # "path" | "leaf-only"


class GcraCluster(Cluster):
    """GCRA/sliding-window protocol model (ops/gcra.py). Own TAKEN lane
    = this node's theoretical-arrival-time watermark (a max register;
    assignment only grows it, ADDED stays zero), effective TAT = max
    over visible lanes, emission interval 1, tolerance ``limit - 1`` —
    so the burst equals ``limit`` and the conservation bound reads like
    the bucket's. The ``advance`` extra move ticks the shared clock one
    emission interval (one more conforming request per side)."""

    def __init__(
        self, n: int, limit: int, sem: Semantics, laws: GcraLaws = GcraLaws()
    ):
        super().__init__(n, limit, sem)
        self.laws = laws
        self.now = 0
        self.advances = 0

    def take(self, i: int) -> None:
        node = self.nodes[i]
        tol = node.limit - 1
        tat = node.taken[i] if self.laws.view == "own" else max(node.taken)
        if tat <= self.now + tol:
            new = max(tat, self.now) + 1
            if new > node.taken[i]:
                node.taken[i] = new
            node.admitted += 1
            self._emit(i)

    def extra_moves(self) -> List[tuple]:
        return [("advance",)]

    def apply_extra(self, mv: tuple) -> None:
        if mv[0] != "advance":
            raise NotImplementedError(f"unknown extra move {mv!r}")
        self.now += 1
        self.advances += 1

    def _clone_empty(self) -> "GcraCluster":
        return GcraCluster(
            len(self.nodes), self.nodes[0].limit, self.sem, self.laws
        )

    def _snapshot_extra(self):
        return (self.now, self.advances)

    def _restore_extra(self, extra) -> None:
        self.now, self.advances = extra

    def _memo_extra(self):
        return (self.now, self.advances)


class ConcCluster(Cluster):
    """Concurrency-limit protocol model (ops/concurrency.py). Own TAKEN
    lane counts this node's acquires, own ADDED lane its releases (both
    monotone G-counters); in-flight = Σtaken − Σadded. ``take`` is an
    acquire; the ``release`` extra move returns one held unit, clamped
    to the node's OWN lane pair under the clean law."""

    def __init__(
        self, n: int, limit: int, sem: Semantics, laws: ConcLaws = ConcLaws()
    ):
        super().__init__(n, limit, sem)
        self.laws = laws
        self.releases = 0

    def take(self, i: int) -> None:  # acquire
        node = self.nodes[i]
        inflight = sum(node.taken) - sum(node.added)
        if inflight < node.limit:
            node.taken[i] += 1
            node.admitted += 1
            self._emit(i)

    def extra_moves(self) -> List[tuple]:
        return [("release", i) for i in range(len(self.nodes))]

    def apply_extra(self, mv: tuple) -> None:
        if mv[0] != "release":
            raise NotImplementedError(f"unknown extra move {mv!r}")
        i = mv[1]
        node = self.nodes[i]
        if self.laws.release != "uncapped" and (
            node.taken[i] - node.added[i] < 1
        ):
            return  # own-lane clamp: nothing of ours is held
        node.added[i] += 1
        self.releases += 1
        self._emit(i)

    def _clone_empty(self) -> "ConcCluster":
        return ConcCluster(
            len(self.nodes), self.nodes[0].limit, self.sem, self.laws
        )

    def _snapshot_extra(self):
        return self.releases

    def _restore_extra(self, extra) -> None:
        self.releases = extra

    def _memo_extra(self):
        return self.releases


class QuotaNode(Node):
    """Hierarchical-quota replica (ops/hierquota.py): 3 path levels ×
    ``n`` writer lanes on ONE node — lane ``level * n + slot``. Only
    TAKEN lanes are used (budgets are configuration, not lattice
    state). Resizing ``self.n`` to 3n is all it takes for the generic
    packet/merge/snapshot/memo machinery to span the whole path."""

    __slots__ = ("peers",)

    def __init__(self, slot: int, n: int, limit: int):
        super().__init__(slot, n, limit)
        self.peers = n
        self.n = 3 * n
        self.added = [0] * self.n
        self.taken = [0] * self.n


class QuotaCluster(Cluster):
    """Hierarchical-quota protocol model: one path (global → tenant →
    user) shared by all nodes, per-level budgets ``limits``; spend at a
    level is the sum of its TAKEN lanes. The default budgets put the
    global pool BELOW the leaf allowance — the oversubscription shape
    that makes partial (leaf-only) debits dangerous."""

    node_cls = QuotaNode

    def __init__(
        self,
        n: int,
        limit: int,
        sem: Semantics,
        laws: QuotaLaws = QuotaLaws(),
        limits: Tuple[int, int, int] = (2, 3, 4),
    ):
        super().__init__(n, limit, sem)
        self.laws = laws
        self.limits = limits

    def _spend(self, node: QuotaNode, level: int) -> int:
        n = node.peers
        return sum(node.taken[level * n : (level + 1) * n])

    def take(self, i: int) -> None:
        node = self.nodes[i]
        heads = [
            self.limits[lvl] - self._spend(node, lvl) for lvl in range(3)
        ]
        leaf_only = self.laws.debit == "leaf-only"
        if (heads[2] if leaf_only else min(heads)) < 1:
            return
        n = node.peers
        for lvl in (2,) if leaf_only else (0, 1, 2):
            node.taken[lvl * n + i] += 1
        node.admitted += 1
        self._emit(i)

    def _clone_empty(self) -> "QuotaCluster":
        return QuotaCluster(
            len(self.nodes),
            self.nodes[0].limit,
            self.sem,
            self.laws,
            self.limits,
        )


def check_gcra_protocol(
    laws: GcraLaws = GcraLaws(),
    n_nodes: int = 2,
    limit: int = 2,
    events: int = 4,
) -> List[Finding]:
    """GCRA conservation (PTC006 family) + PTC001/002 at heal: under
    sync-within-side delivery, total conforming grants never exceed
    ``(burst + clock-advances) × sides`` — the family's AP bound — and
    every terminal heals to the exact join (TAT lanes are max
    registers, so the standard join IS the merge)."""
    findings: List[Finding] = []
    alphabet = [("take", i) for i in range(n_nodes)] + [("advance", None)]
    for layout in _partition_layouts(n_nodes):
        sides = 1 if layout is None else len(set(layout.values()))
        for seq in itertools.product(alphabet, repeat=events):
            c = GcraCluster(n_nodes, limit, CLEAN, laws=laws)
            c.set_partition(layout)
            try:
                for kind, i in seq:
                    if kind == "advance":
                        c.apply_extra(("advance",))
                    else:
                        c.take(i)
                    c.deliver_all(within_side_only=True)
                    admitted = sum(n.admitted for n in c.nodes)
                    budget = (limit + c.advances) * sides
                    if admitted > budget:
                        raise _Violation(
                            "PTC006",
                            f"GCRA over-admitted: {admitted} conforming "
                            f"grants > (burst {limit} + {c.advances} "
                            f"advances) × {sides} side(s) "
                            f"(layout={layout}, schedule={list(seq)})",
                        )
                c.heal_and_converge()
            except _Violation as v:
                findings.append(Finding(v.check, _SELF, 0, v.message))
                break  # one witness per layout is enough
    return findings


def check_conc_protocol(
    laws: ConcLaws = ConcLaws(),
    n_nodes: int = 2,
    limit: int = 2,
    events: int = 4,
) -> List[Finding]:
    """Concurrency-limit conservation (PTC006 family) + PTC001/002 at
    heal: held units (acquires − releases) never exceed ``limit ×
    sides`` under sync-within-side delivery, and no converged lane pair
    has ADDED > TAKEN — a phantom release would invent capacity the
    monotone lanes can never reclaim."""
    findings: List[Finding] = []
    alphabet = [("take", i) for i in range(n_nodes)] + [
        ("release", i) for i in range(n_nodes)
    ]
    for layout in _partition_layouts(n_nodes):
        sides = 1 if layout is None else len(set(layout.values()))
        for seq in itertools.product(alphabet, repeat=events):
            c = ConcCluster(n_nodes, limit, CLEAN, laws=laws)
            c.set_partition(layout)
            try:
                for kind, i in seq:
                    if kind == "release":
                        c.apply_extra(("release", i))
                    else:
                        c.take(i)
                    c.deliver_all(within_side_only=True)
                    held = sum(n.admitted for n in c.nodes) - c.releases
                    if held > limit * sides:
                        raise _Violation(
                            "PTC006",
                            f"concurrency over-held: {held} in-flight "
                            f"units > limit {limit} × {sides} side(s) "
                            f"(layout={layout}, schedule={list(seq)})",
                        )
                c.heal_and_converge()
                converged = c.nodes[0]
                for s in range(n_nodes):
                    if converged.added[s] > converged.taken[s]:
                        raise _Violation(
                            "PTC006",
                            f"phantom release: lane {s} released "
                            f"{converged.added[s]} > acquired "
                            f"{converged.taken[s]} after convergence — "
                            f"capacity invented (layout={layout}, "
                            f"schedule={list(seq)})",
                        )
            except _Violation as v:
                findings.append(Finding(v.check, _SELF, 0, v.message))
                break  # one witness per layout is enough
    return findings


def check_quota_protocol(
    laws: QuotaLaws = QuotaLaws(),
    n_nodes: int = 2,
    events: int = 5,
    limits: Tuple[int, int, int] = (2, 3, 4),
) -> List[Finding]:
    """Hierarchical-quota per-level conservation (PTC006 family) +
    PTC001/002 at heal: under sync-within-side delivery, admitted takes
    never exceed ``level-limit × sides`` for ANY path level — a partial
    (leaf-only) debit lets the leaf allowance overspend the tighter
    global pool."""
    findings: List[Finding] = []
    level_names = ("global", "tenant", "user")
    for layout in _partition_layouts(n_nodes):
        sides = 1 if layout is None else len(set(layout.values()))
        for seq in itertools.product(range(n_nodes), repeat=events):
            c = QuotaCluster(
                n_nodes, limits[2], CLEAN, laws=laws, limits=limits
            )
            c.set_partition(layout)
            try:
                for i in seq:
                    c.take(i)
                    c.deliver_all(within_side_only=True)
                    admitted = sum(n.admitted for n in c.nodes)
                    for lvl, name in enumerate(level_names):
                        if admitted > limits[lvl] * sides:
                            raise _Violation(
                                "PTC006",
                                f"quota {name} level overspent: "
                                f"{admitted} admitted > limit "
                                f"{limits[lvl]} × {sides} side(s) — a "
                                f"partial path debit (layout={layout}, "
                                f"schedule={list(seq)})",
                            )
                c.heal_and_converge()
            except _Violation as v:
                findings.append(Finding(v.check, _SELF, 0, v.message))
                break  # one witness per layout is enough
    return findings


# Family reachability registry: every KernelFamily's ``protocol`` key
# must resolve here, and law-mutation CertMutations are executed through
# these entries. The ``laws=None`` wrappers adapt the preset suites to
# the same signature.
FAMILY_CHECKS: Dict[str, object] = {
    "bucket-full": lambda laws=None: check_protocol(CLEAN),
    "bucket-delta": lambda laws=None: check_protocol(CLEAN_DELTA),
    "lifecycle-gc": lambda laws=None: check_protocol(CLEAN_GC),
    "membership": lambda laws=None: check_protocol(CLEAN_MEMBER),
    "gcra": check_gcra_protocol,
    "concurrency": check_conc_protocol,
    "hierquota": check_quota_protocol,
}


def check_repo() -> List[Finding]:
    """The stage-6 gate: the clean protocol — on the v1 full-state plane,
    the wire-v2 delta plane, a mixed v1/v2 cluster, AND both planes with
    bucket-lifecycle GC transitions enabled — must satisfy every
    invariant, and every registered mutation must be rejected by at
    least one."""
    findings = list(check_protocol(CLEAN))
    findings += check_protocol(CLEAN_DELTA)
    findings += check_protocol(CLEAN_MIXED)
    findings += check_protocol(CLEAN_GC)
    findings += check_protocol(CLEAN_GC_DELTA)
    findings += check_protocol(CLEAN_MEMBER)
    findings += check_protocol(CLEAN_MEMBER_DELTA)
    # Cert-kit kernel families under their clean laws (the seeded law
    # mutations are executed by scripts/protocol_repo.py against
    # ops/obligations.py's KERNEL_FAMILIES registry).
    findings += check_gcra_protocol()
    findings += check_conc_protocol()
    findings += check_quota_protocol()
    for name, sem in MUTATIONS.items():
        caught = check_protocol(sem)
        if not caught:
            findings.append(
                Finding(
                    "PTC005",
                    _SELF,
                    0,
                    f"seeded protocol mutation '{name}' was NOT rejected — "
                    "the checker has lost its teeth",
                )
            )
    return findings
