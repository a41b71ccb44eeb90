"""patrol-lin — replication-aware linearizability against a sequential
limiter spec (stage 8; the port's copy of the JAX package's
``analysis/linearizability.py``: the same specs, laws, suites and
mutations, with findings anchored in this file and the specs registered
in the port's ``ops/obligations.py``).

patrol-protocol (stage 6) certifies that the replicated lanes CONVERGE;
nothing before this module certified that the system *behaves like a
rate limiter*. This checker closes ROADMAP item 4's verification half
("Automatically Verifying Replication-aware Linearizability",
arXiv:2502.19967): every bounded schedule from the protocol model's
enumerator (:func:`protocol.enumerate_schedules` — takes × delivery ×
partition × heal × gc, one DFS + memoization shared with stage 6) is
replayed against a **sequential token-bucket specification**
(:class:`SequentialSpec`) through an explicit per-node **visibility
relation**.

The visibility relation is derived from the wire itself, not asserted:
every lane-effective operation (a granted take, a granted refill) is
identified by its own-lane watermark — the lane value the instant after
it executed — and a replica *sees* an operation exactly when a payload
(full-state datagram, delta interval, incast reply, heal-time
anti-entropy exchange) carrying that lane at-or-above the watermark was
merged into it. The per-node ledger is monotone: knowledge, once
delivered, is never unlearned — which is precisely what catches a
reclaim that forgets visible admits (the lanes lie; the ledger
remembers).

Replication-aware linearizability, per finding code:

====== ===============================================================
PTN001 per-node sequential soundness: every grant must be justified by
       the sequential spec replayed over the operations VISIBLE to the
       granting node at execution (a grant the visible history refuses
       means the node ignored delivered knowledge)
PTN002 visibility-respecting linearization: a deny the visible history
       would grant is justifiable only by *invisible* operations (no
       visibility-respecting linearization explains it); and once
       converged, every replica must know every lane-effective op and
       the converged lanes must equal the ledger's watermarks —
       nothing lost, nothing invented by the history
PTN003 full linearizability on sync-delivery schedules: with every
       emission delivered before the next event and no partition, each
       outcome must be EXACTLY the sequential spec's outcome — zero
       replication slack in either direction
PTN004 no manufactured grants: refills / GC re-creation / cap adoption
       must never produce a grant the spec refuses under ANY
       visibility extension (even granting the node every refill in
       history, the spend it saw already exhausts the bucket)
PTN005 trust story: a registered seeded mutation not rejected with its
       exact PTN code, or a mutation knob with no registered seeded
       mutation, is itself a finding — the checker must be able to fail
====== ===============================================================

Specs are registered per kernel family in ``ops/obligations.py``
(``LIN_SPECS``) and pinned to the port's kernels by the differential
tests in ``tests/test_torch_lin.py`` (on the CPU) and by
``chip_smoke.py`` phase 3k (on the card) — the model's take
law IS ops/take.py's admission (including the over-capacity forfeit
clamp), the delta visibility IS net/delta.py's absolute own-lane
intervals, the GC law IS the lifecycle IsZero reclaim with the
tombstoned own lane.

Justification replays the canonical linearization (ledger order, which
extends per-node program order and delivery order); granted historical
takes debit unconditionally — under partition the spec balance may go
negative, which is exactly the bounded AP overshoot PTC003 prices, and
each side's own grants must still be visible-justified (linearizable
*up to visibility*).

Pure python, no jax; deterministic by construction, same trust story as
stage 6: :data:`LIN_MUTATIONS` registers seeded linearizability bugs
and :func:`check_repo` asserts each is rejected with its exact code.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, FrozenSet, List, Optional, Tuple

from patrol_tpu_torch.analysis import protocol as proto
from patrol_tpu_torch.analysis.lint import Finding

_SELF = "patrol_tpu_torch/analysis/linearizability.py"


# ---------------------------------------------------------------------------
# the sequential specification


class SequentialSpec:
    """THE sequential token bucket: one integer balance, capacity
    ``limit``, no replication anywhere. ``take`` grants iff the balance
    covers the count; ``refill`` adds capped at capacity; ``gc`` is the
    sequential reclaim — permitted only when the bucket is full (where
    it is observationally the identity). The differential tests pin
    this object to the real kernels; the checker pins the replicated
    model to this object."""

    __slots__ = ("limit", "tokens")

    def __init__(self, limit: int):
        self.limit = limit
        self.tokens = limit

    def take(self, count: int = 1) -> bool:
        if self.tokens >= count:
            self.tokens -= count
            return True
        return False

    def refill(self, count: int = 1) -> None:
        self.tokens = min(self.limit, self.tokens + count)

    def debit(self, count: int = 1) -> None:
        """Replay a GRANTED historical take unconditionally: under
        partition both sides' grants are real, so the replayed balance
        may go negative — the bounded AP overshoot."""
        self.tokens -= count

    def gc(self) -> bool:
        return self.tokens == self.limit


class SequentialGcra:
    """THE sequential GCRA: one theoretical-arrival-time register,
    emission interval 1, tolerance ``limit - 1`` (burst = ``limit``) —
    the unreplicated object whose per-request loop ops/gcra.py's closed
    form compresses. ``take`` conforms iff TAT is within tolerance of
    now, then advances TAT one emission interval past ``max(TAT, now)``.
    """

    __slots__ = ("tol", "tat")

    def __init__(self, limit: int):
        self.tol = limit - 1
        self.tat = 0

    def take(self, now: int) -> bool:
        if self.tat <= now + self.tol:
            self.tat = max(self.tat, now) + 1
            return True
        return False


class SequentialConc:
    """THE sequential concurrency limiter with client-owned leases:
    acquire grants while total held < ``limit``; a client may release
    only its OWN holds. The kernel's own-lane release clamp
    (ops/concurrency.py) is exactly this ownership rule, sequentially —
    a release of someone else's lease is refused, not absorbed."""

    __slots__ = ("limit", "held")

    def __init__(self, limit: int, clients: int):
        self.limit = limit
        self.held = [0] * clients

    def acquire(self, client: int) -> bool:
        if sum(self.held) < self.limit:
            self.held[client] += 1
            return True
        return False

    def release(self, client: int) -> bool:
        if self.held[client] > 0:
            self.held[client] -= 1
            return True
        return False


class SequentialQuota:
    """THE sequential hierarchical quota for one path: a single spend
    counter checked against EVERY level's budget — a take debits all
    levels together (ops/hierquota.py's all-or-nothing packed debit),
    so one counter serves global, tenant and user alike."""

    __slots__ = ("limits", "spent")

    def __init__(self, limits: Tuple[int, int, int]):
        self.limits = limits
        self.spent = 0

    def take(self) -> bool:
        if all(self.spent < lim for lim in self.limits):
            self.spent += 1
            return True
        return False


# ---------------------------------------------------------------------------
# laws + seeded mutations


LAW_DOMAINS: Dict[str, Tuple[str, ...]] = {
    # How a replica decides a take. "local" is the kernel's law: admit
    # from the full local view (all visible lanes). The others are the
    # seeded bugs: "ignore-remote" admits from the own lane only
    # (delivered remote spend is ignored — PTN001), "off-by-one" admits
    # at a zero balance (one grant past the spec even fully synced —
    # PTN003), "clairvoyant" decides from the GLOBAL join including
    # state never delivered to the node (a deny only invisible
    # operations can justify — PTN002).
    "take": ("local", "ignore-remote", "off-by-one", "clairvoyant"),
    # How a reclaim treats admitted spend. "tombstone" is the engine's
    # law (IsZero predicate, own lane survives the collect);
    # "forget-admits" drops the own lane too, so visible admits vanish
    # from the lanes and stale echoes re-admit them (PTN004).
    "gc": ("tombstone", "forget-admits"),
}


@dataclasses.dataclass(frozen=True)
class LinLaws:
    take: str = "local"
    gc: str = "tombstone"


CLEAN_LAWS = LinLaws()


@dataclasses.dataclass(frozen=True)
class LinSpecFamily:
    """One kernel family's registration (``ops/obligations.py``'s
    ``LIN_SPECS``): which real kernel the spec is pinned to (by the
    differential tests), which wire plane its replication model rides
    (``"full"`` v1 datagrams / ``"delta"`` wire-v2 intervals), whether
    lifecycle events (refill + GC re-creation) are in its schedule
    alphabet, and which sequential ALGEBRA the checker replays against:
    ``"bucket"`` rides the LinCluster/visibility-ledger suites below;
    the cert-kit algebras (``"gcra"``, ``"conc"``, ``"quota"``) ride
    :func:`check_sync_algebra` over the shared protocol-model clusters.
    """

    name: str
    module: str
    func: str
    wire: str = "full"
    lifecycle: bool = False
    algebra: str = "bucket"
    note: str = ""


# Dispatchable sequential algebras (a LinSpecFamily.algebra must be one).
ALGEBRAS: Tuple[str, ...] = ("bucket", "gcra", "conc", "quota")


@dataclasses.dataclass(frozen=True)
class LinMutation:
    laws: LinLaws
    family: str  # LinSpecFamily.name the mutation runs against
    expect: str  # the exact PTN code a correct checker reports
    note: str = ""


LIN_MUTATIONS: Dict[str, LinMutation] = {
    # A node that admits from its own lane only ignores remote spend it
    # ALREADY MERGED: the visible history refuses the grant.
    "take-ignores-visible-remote-spend": LinMutation(
        LinLaws(take="ignore-remote"),
        family="ops.take.take_batch",
        expect="PTN001",
        note="delivered remote lanes excluded from the admission view",
    ),
    # An off-by-one admission grants at balance zero: even on a fully
    # synced schedule the spec refuses — no replication slack excuses it.
    "grant-exceeds-spec-on-sync-schedule": LinMutation(
        LinLaws(take="off-by-one"),
        family="ops.take.take_batch",
        expect="PTN003",
        note="admit iff tokens >= 0 instead of >= count",
    ),
    # A reclaim that drops the OWN lane forgets admits the cluster
    # already saw; stale echoes absorb the restarted spend and a later
    # grant exists that NO visibility extension justifies.
    "gc-forgets-visible-admits": LinMutation(
        LinLaws(gc="forget-admits"),
        family="ops.lifecycle.lifecycle_probe",
        expect="PTN004",
        note="collect drops the tombstoned own lane too",
    ),
    # A clairvoyant deny is decided by state never delivered to the
    # node: only a linearization violating the visibility relation
    # could explain the outcome — the checker must refuse to accept it.
    "visibility-violating-linearization-accepted": LinMutation(
        LinLaws(take="clairvoyant"),
        family="ops.take.take_batch",
        expect="PTN002",
        note="admission decided from the global join, not the local view",
    ),
}


# ---------------------------------------------------------------------------
# the visibility ledger


@dataclasses.dataclass(frozen=True)
class Op:
    """One lane-effective (or denied) operation in the global history.
    ``lane`` is the (kind, watermark) identity — the executing node's
    own-lane value the instant after the op, forfeit clamp included —
    by which receivers' visibility is derived from payloads. Denied
    takes have no lane identity (nothing propagates) but are still
    checked for justification at execution."""

    oid: int
    node: int
    kind: str  # "take" | "refill" | "gc"
    granted: bool
    count: int
    lane: Optional[Tuple[str, int]]
    visible: FrozenSet[int]


class Ledger:
    """The global operation history + per-(node, lane-kind) watermark
    index. Pure bookkeeping: the checker's memory of what happened and
    what each payload proves was delivered."""

    def __init__(self) -> None:
        self.ops: List[Op] = []
        self.lane_ops: Dict[Tuple[int, str], List[Tuple[int, int]]] = {}

    def record(self, op: Op) -> None:
        self.ops.append(op)
        if op.lane is not None:
            kind, watermark = op.lane
            self.lane_ops.setdefault((op.node, kind), []).append(
                (watermark, op.oid)
            )

    def upto(self, node: int, kind: str, value: int) -> List[int]:
        """Every op of (node, kind) whose watermark a lane value
        ``value`` proves delivered. A mutated law may reuse watermarks
        (that collision IS the forgetting); the scan is inclusive."""
        return [
            oid
            for (w, oid) in self.lane_ops.get((node, kind), ())
            if w <= value
        ]

    def replay(self, limit: int, oids) -> SequentialSpec:
        """The canonical visibility-respecting linearization: replay
        the given ops in ledger (schedule) order through a fresh
        sequential spec. Granted takes debit unconditionally."""
        spec = SequentialSpec(limit)
        for oid in sorted(oids):
            op = self.ops[oid]
            if not op.granted:
                continue
            if op.kind == "refill":
                spec.refill(op.count)
            elif op.kind == "take":
                spec.debit(op.count)
        return spec


# ---------------------------------------------------------------------------
# the replicated model under check


class LinCluster(proto.Cluster):
    """The protocol model cluster + the visibility ledger. Rides the
    SAME schedule enumerator as stage 6 via the snapshot/restore/
    memo-key hooks; overrides the event entry points to (a) apply the
    lin law under test and (b) check every take's justification at
    execution. Visibility is learned exclusively at payload ingest
    (:meth:`_apply_packet` / heal-time :meth:`_resync`) — knowledge is
    what the wire delivered, nothing else."""

    def __init__(
        self,
        n: int,
        limit: int,
        laws: LinLaws = CLEAN_LAWS,
        wire: str = "full",
        lifecycle: bool = False,
        sync: bool = False,
    ):
        self.laws = laws
        self.wire = wire
        self.lifecycle = lifecycle
        self.sync = sync
        gc_law = "off"
        if lifecycle:
            gc_law = "always" if laws.gc == "forget-admits" else "iszero"
        super().__init__(
            n, limit, proto.Semantics(wire=wire, gc=gc_law)
        )
        self.seen: List[set] = [set() for _ in range(n)]
        self.ledger = Ledger()
        self.partitioned = False  # sticky: a partition happened somewhere

    # -- enumerator hooks ----------------------------------------------------

    def _clone_empty(self) -> "LinCluster":
        return LinCluster(
            len(self.nodes),
            self.nodes[0].limit,
            laws=self.laws,
            wire=self.wire,
            lifecycle=self.lifecycle,
            sync=self.sync,
        )

    def _snapshot_extra(self):
        led = Ledger()
        led.ops = list(self.ledger.ops)
        led.lane_ops = {k: list(v) for k, v in self.ledger.lane_ops.items()}
        return ([set(s) for s in self.seen], led, self.partitioned)

    def _restore_extra(self, extra) -> None:
        seen, led, partitioned = extra
        self.seen = [set(s) for s in seen]
        self.ledger = Ledger()
        self.ledger.ops = list(led.ops)
        self.ledger.lane_ops = {k: list(v) for k, v in led.lane_ops.items()}
        self.partitioned = partitioned

    def _memo_extra(self):
        # Two lane-identical states with different visible histories are
        # NOT the same verification state: a denied take leaves no lane
        # trace but is still an outcome the spec must justify.
        return (
            tuple(tuple(sorted(s)) for s in self.seen),
            tuple(
                (o.node, o.kind, o.granted, o.lane) for o in self.ledger.ops
            ),
            self.partitioned,
        )

    # -- visibility ingest ---------------------------------------------------

    def _learn(self, j: int, lanes) -> None:
        if self.nodes[j].deaf:
            return  # a deaf node drops the payload; it learns nothing
        s = self.seen[j]
        for slot, a, t in lanes:
            s.update(self.ledger.upto(slot, "added", a))
            s.update(self.ledger.upto(slot, "taken", t))

    def _apply_packet(self, j: int, pkt: tuple, ack: bool = True) -> None:
        if pkt[0] == "full":
            self._learn(j, pkt[1])
        elif pkt[0] == "delta" and self.caps[j]:
            self._learn(j, pkt[3])
        super()._apply_packet(j, pkt, ack)

    def _resync(self, b: int, a: int) -> None:
        self._learn(b, self.nodes[a].packet())
        super()._resync(b, a)

    def set_partition(self, sides) -> None:
        if sides is not None:
            self.partitioned = True
        super().set_partition(sides)

    # -- events under the lin law, checked at execution ----------------------

    def take(self, i: int) -> None:
        node = self.nodes[i]
        law = self.laws.take
        if law == "ignore-remote":
            tokens = node.limit + node.added[i] - node.taken[i]
        elif law == "clairvoyant":
            joined = proto._join([n.state() for n in self.nodes])
            n = len(self.nodes)
            tokens = node.limit + sum(joined[:n]) - sum(joined[n:])
        else:
            tokens = node.limit + sum(node.added) - sum(node.taken)
        # The kernel's over-capacity forfeit clamp (ops/take.py): a view
        # past capacity — reachable once GC drops a peer's lane copy —
        # books the excess into the own taken lane before admission.
        if tokens > node.limit:
            node.taken[i] += tokens - node.limit
            tokens = node.limit
        granted = tokens >= (0 if law == "off-by-one" else 1)
        if granted:
            node.taken[i] += 1
            node.admitted += 1
        op = Op(
            oid=len(self.ledger.ops),
            node=i,
            kind="take",
            granted=granted,
            count=1,
            lane=("taken", node.taken[i]) if granted else None,
            visible=frozenset(self.seen[i]),
        )
        self.ledger.record(op)
        self.seen[i].add(op.oid)
        self._check_take(op)
        if granted:
            self._emit(i)

    def refill(self, i: int) -> None:
        node = self.nodes[i]
        if not node.refill():
            return  # at capacity: the spec's refill is a no-op there too
        op = Op(
            oid=len(self.ledger.ops),
            node=i,
            kind="refill",
            granted=True,
            count=1,
            lane=("added", node.added[i]),
            visible=frozenset(self.seen[i]),
        )
        self.ledger.record(op)
        self.seen[i].add(op.oid)
        self._emit(i)

    def gc(self, i: int) -> None:
        if not self.nodes[i].gc(self.sem):
            return
        op = Op(
            oid=len(self.ledger.ops),
            node=i,
            kind="gc",
            granted=True,
            count=0,
            lane=None,
            visible=frozenset(self.seen[i]),
        )
        self.ledger.record(op)
        self.seen[i].add(op.oid)
        self._emit(i)

    # -- the justification checks --------------------------------------------

    def _lane_visible(self, j: int) -> set:
        """The ops reflected in node j's CURRENT lanes. A reclaim may
        legitimately shrink this below the monotone ledger (dropped
        peer-lane copies, with stale echoes re-entering spend without
        its refill) — so this, not the ledger, is the deny side's
        justification base: the lanes ARE the admission input."""
        node = self.nodes[j]
        vis: set = set()
        for s in range(len(self.nodes)):
            vis.update(self.ledger.upto(s, "added", node.added[s]))
            vis.update(self.ledger.upto(s, "taken", node.taken[s]))
        return vis

    def _check_take(self, op: Op) -> None:
        """Asymmetric justification, deliberately: a GRANT answers to
        everything the node ever learned (monotone visibility —
        forgetting never excuses over-admission, the tombstone design
        intent), while a DENY answers to the lane-reflected history (a
        conservative deny after a reclaim dropped lanes is correct
        behavior; a deny even the node's own current view would grant
        required information no visibility relation delivered)."""
        limit = self.nodes[op.node].limit
        spec = self.ledger.replay(limit, op.visible)
        spec_grants = spec.tokens >= op.count
        if op.granted and not spec_grants:
            if self.sync:
                raise proto._Violation(
                    "PTN003",
                    f"sync-delivery grant exceeds the sequential spec: "
                    f"node {op.node} granted take #{op.oid} with every "
                    f"prior op delivered, but the spec balance is "
                    f"{spec.tokens} < {op.count} — not linearizable even "
                    "with zero replication slack",
                )
            # The most favorable visibility extension grants the node
            # every refill in history on top of what it saw, and adds no
            # further spend; the cap only lowers the balance, so this is
            # a sound upper bound on ANY extension's replay.
            refills_all = sum(
                o.count
                for o in self.ledger.ops
                if o.kind == "refill" and o.granted
            )
            granted_vis = sum(
                self.ledger.ops[v].count
                for v in op.visible
                if self.ledger.ops[v].kind == "take"
                and self.ledger.ops[v].granted
            )
            best = limit + refills_all - granted_vis
            if self.lifecycle and best < op.count:
                raise proto._Violation(
                    "PTN004",
                    f"manufactured grant: node {op.node} granted take "
                    f"#{op.oid} but the spend visible to it already "
                    f"exhausts the bucket under EVERY visibility "
                    f"extension (limit {limit} + {refills_all} refills "
                    f"- {granted_vis} visible grants = {best} < "
                    f"{op.count}) — a reclaim/refill invented tokens",
                )
            raise proto._Violation(
                "PTN001",
                f"unjustified grant: node {op.node} granted take "
                f"#{op.oid} but the sequential spec over its VISIBLE "
                f"history refuses (balance {spec.tokens} < {op.count}; "
                f"visible ops {sorted(op.visible)}) — delivered "
                "knowledge was ignored",
            )
        if not op.granted:
            lane_vis = self._lane_visible(op.node)
            lane_vis.discard(op.oid)
            lane_spec = self.ledger.replay(limit, lane_vis)
            if lane_spec.tokens >= op.count:
                if self.sync:
                    raise proto._Violation(
                        "PTN003",
                        f"sync-delivery deny diverges from the "
                        f"sequential spec: node {op.node} denied take "
                        f"#{op.oid} with every prior op delivered but "
                        f"the spec balance is {lane_spec.tokens} >= "
                        f"{op.count}",
                    )
                raise proto._Violation(
                    "PTN002",
                    f"visibility-violating deny: node {op.node} denied "
                    f"take #{op.oid} but the spec over the history its "
                    f"OWN lanes reflect grants (balance "
                    f"{lane_spec.tokens}); only operations never "
                    "delivered to the node could justify this outcome — "
                    "no visibility-respecting linearization explains it",
                )

    def check_terminal(self) -> None:
        """Converged-history checks (run after ``heal_and_converge``):
        every replica must have learned every lane-effective op, and the
        converged lanes must be EXACTLY the ledger's high watermarks —
        a converged state beyond (or below) every recorded op is state
        the history cannot linearize (PTN002)."""
        effective = {
            op.oid for op in self.ledger.ops if op.lane is not None
        }
        for j, s in enumerate(self.seen):
            missing = effective - s
            if missing:
                raise proto._Violation(
                    "PTN002",
                    f"converged node {j} never learned ops "
                    f"{sorted(missing)} — the heal delivered state "
                    "without the knowledge that justifies it",
                )
        n = len(self.nodes)
        converged = self.nodes[0].state()
        for i in range(n):
            for kind, value in (
                ("added", converged[i]),
                ("taken", converged[n + i]),
            ):
                marks = [
                    w for (w, _) in self.ledger.lane_ops.get((i, kind), ())
                ]
                expect = max(marks) if marks else 0
                if value != expect:
                    raise proto._Violation(
                        "PTN002",
                        f"converged lane ({i}, {kind}) = {value} != "
                        f"ledger watermark {expect} — the converged "
                        "state is not the replay of any linearization "
                        "of the recorded operations",
                    )


# ---------------------------------------------------------------------------
# suites


def _family_bounds(spec: LinSpecFamily) -> proto.ScheduleBounds:
    if spec.lifecycle:
        # Deep enough for the manufactured-grant witness: spend, refill
        # to full, reclaim, re-spend, stale echo back.
        return proto.ScheduleBounds(
            n_nodes=2, limit=1, takes=3, disruptions=1, refills=1, gcs=1
        )
    if spec.wire == "delta":
        return proto.ScheduleBounds(n_nodes=2, limit=2, takes=2, disruptions=2)
    return proto.ScheduleBounds(
        n_nodes=2, limit=2, takes=3, disruptions=2, partitions=1
    )


def check_async_lin(
    spec: LinSpecFamily,
    laws: LinLaws = CLEAN_LAWS,
    stop_at_first: bool = True,
) -> Tuple[int, List[Finding]]:
    """PTN001/PTN002/PTN004 under fully-adversarial delivery: every
    terminal of the SHARED stage-6 enumerator, with per-take
    justification checked at execution and the converged-history checks
    at each terminal. Returns (terminals explored, findings).
    ``stop_at_first=False`` (the mutation-rejection mode) keeps
    exploring after a witness and reports one witness PER CODE — a
    mutation's characteristic violation may sit behind a shallower
    symptom."""
    findings: List[Finding] = []
    explored = 0
    seen_codes: set = set()
    bounds = _family_bounds(spec)

    def factory(n: int, limit: int, _sem: proto.Semantics) -> LinCluster:
        return LinCluster(
            n, limit, laws=laws, wire=spec.wire, lifecycle=spec.lifecycle
        )

    for term in proto.enumerate_schedules(proto.CLEAN, bounds, factory):
        explored += 1
        v = term.violation
        if v is None:
            try:
                term.cluster.heal_and_converge()
                term.cluster.check_terminal()
                continue
            except proto._Violation as err:
                v = err
        if v.check not in seen_codes:
            seen_codes.add(v.check)
            findings.append(
                Finding(
                    v.check,
                    _SELF,
                    0,
                    f"[{spec.name}] {v.message} (schedule: "
                    f"{list(term.events)})",
                )
            )
        if stop_at_first:
            break  # one witness is enough
    return explored, findings


def check_sync_lin(
    spec: LinSpecFamily,
    laws: LinLaws = CLEAN_LAWS,
    stop_at_first: bool = True,
) -> Tuple[int, List[Finding]]:
    """PTN003 on sync-delivery schedules / PTN001-002 under partition:
    enumerate every event sequence with every emission flushed and
    delivered before the next event (the sync discipline). Without a
    partition this proves FULL linearizability — outcome-for-outcome
    equality with the sequential spec. Across every partition layout
    the same schedules prove linearizability up to visibility: each
    side's outcomes justified by side-visible history (the AP
    overshoot stays priced, never unexplained)."""
    findings: List[Finding] = []
    explored = 0
    seen_codes: set = set()
    n_nodes, limit, events = 2, 2, 4
    kinds = ("take", "refill", "gc") if spec.lifecycle else ("take",)
    alphabet = [(k, i) for k in kinds for i in range(n_nodes)]
    for layout in proto._partition_layouts(n_nodes):
        for seq in itertools.product(range(len(alphabet)), repeat=events):
            c = LinCluster(
                n_nodes,
                limit,
                laws=laws,
                wire=spec.wire,
                lifecycle=spec.lifecycle,
                sync=layout is None,
            )
            c.set_partition(layout)
            explored += 1
            try:
                for ev in seq:
                    kind, i = alphabet[ev]
                    getattr(c, kind)(i)
                    c.flush(i)
                    c.deliver_all(within_side_only=True)
                c.heal_and_converge()
                c.check_terminal()
            except proto._Violation as v:
                if v.check not in seen_codes:
                    seen_codes.add(v.check)
                    findings.append(
                        Finding(
                            v.check,
                            _SELF,
                            0,
                            f"[{spec.name}] {v.message} (events: "
                            f"{[alphabet[e] for e in seq]}, "
                            f"layout={layout})",
                        )
                    )
                if stop_at_first:
                    return explored, findings  # one witness is enough
    return explored, findings


# Path budgets for the quota algebra's replay: global pool tighter
# than the leaf allowance (the oversubscription shape — must match the
# protocol model's default so stage 8 and stage 6 witness the same
# object).
_QUOTA_LIMITS: Tuple[int, int, int] = (2, 3, 4)


def check_sync_algebra(
    spec: LinSpecFamily, stop_at_first: bool = True
) -> Tuple[int, List[Finding]]:
    """Linearizability for the non-bucket cert-kit algebras, on the
    SHARED protocol-model clusters: on every sync-delivered schedule,
    each partition side's outcomes must equal a per-side sequential
    replay — full linearizability when there is no partition (one side
    = the whole cluster, PTN003 on divergence), visibility-priced
    outcomes across every layout (PTN001 on divergence) — and every
    terminal must heal to the exact join. ``LinLaws`` does not apply to
    these algebras: their seeded law mutations live in the protocol
    model (``GcraLaws``/``ConcLaws``/``QuotaLaws``) and are executed by
    ``scripts/protocol_repo.py`` against ``obligations.KERNEL_FAMILIES``."""
    findings: List[Finding] = []
    explored = 0
    seen_codes: set = set()
    n_nodes, limit, events = 2, 2, 4
    take_moves = [("take", i) for i in range(n_nodes)]
    if spec.algebra == "gcra":
        alphabet = take_moves + [("advance", None)]
    elif spec.algebra == "conc":
        alphabet = take_moves + [("release", i) for i in range(n_nodes)]
    else:  # quota
        alphabet = take_moves
    for layout in proto._partition_layouts(n_nodes):
        side_of = {
            i: (0 if layout is None else layout[i]) for i in range(n_nodes)
        }
        sides = sorted(set(side_of.values()))
        for seq in itertools.product(alphabet, repeat=events):
            explored += 1
            if spec.algebra == "gcra":
                c = proto.GcraCluster(n_nodes, limit, proto.CLEAN)
                replays = {s: SequentialGcra(limit) for s in sides}
            elif spec.algebra == "conc":
                c = proto.ConcCluster(n_nodes, limit, proto.CLEAN)
                replays = {s: SequentialConc(limit, n_nodes) for s in sides}
            else:
                c = proto.QuotaCluster(
                    n_nodes, _QUOTA_LIMITS[2], proto.CLEAN,
                    limits=_QUOTA_LIMITS,
                )
                replays = {s: SequentialQuota(_QUOTA_LIMITS) for s in sides}
            c.set_partition(layout)
            try:
                for kind, i in seq:
                    replay = None if i is None else replays[side_of[i]]
                    if kind == "advance":
                        c.apply_extra(("advance",))
                    elif kind == "release":
                        before = c.releases
                        c.apply_extra(("release", i))
                        got = c.releases > before
                        want = replay.release(i)
                        if got != want:
                            raise proto._Violation(
                                "PTN003" if layout is None else "PTN001",
                                f"release on node {i} "
                                f"{'took effect' if got else 'was refused'}"
                                f" but the side's sequential replay says "
                                f"{want}",
                            )
                    else:
                        before = c.nodes[i].admitted
                        c.take(i)
                        got = c.nodes[i].admitted > before
                        if spec.algebra == "gcra":
                            want = replay.take(c.now)
                        elif spec.algebra == "conc":
                            want = replay.acquire(i)
                        else:
                            want = replay.take()
                        if got != want:
                            raise proto._Violation(
                                "PTN003" if layout is None else "PTN001",
                                f"take on node {i} "
                                f"{'granted' if got else 'denied'} but the "
                                f"side's sequential replay says {want}",
                            )
                    c.deliver_all(within_side_only=True)
                c.heal_and_converge()
            except proto._Violation as v:
                if v.check not in seen_codes:
                    seen_codes.add(v.check)
                    findings.append(
                        Finding(
                            v.check,
                            _SELF,
                            0,
                            f"[{spec.name}] {v.message} (events: "
                            f"{list(seq)}, layout={layout})",
                        )
                    )
                if stop_at_first:
                    return explored, findings  # one witness is enough
    return explored, findings


def check_family(
    spec: LinSpecFamily,
    laws: LinLaws = CLEAN_LAWS,
    stop_at_first: bool = True,
) -> Tuple[int, List[Finding]]:
    """Both suites for one registered kernel family (the non-bucket
    algebras dispatch to their sequential-replay suite)."""
    if spec.algebra != "bucket":
        return check_sync_algebra(spec, stop_at_first)
    explored, findings = check_async_lin(spec, laws, stop_at_first)
    sync_explored, sync_findings = check_sync_lin(spec, laws, stop_at_first)
    return explored + sync_explored, findings + sync_findings


# ---------------------------------------------------------------------------
# entry points


def check_repo(specs) -> Tuple[int, List[Finding]]:
    """The stage-8 gate over the registered spec families
    (``obligations.LIN_SPECS``, passed in by the driver so this module
    stays import-light): every family must be clean under the clean
    laws, every seeded mutation must be rejected with its EXACT code,
    and every mutation knob must be exercised by a registered mutation
    (PTN005 both ways — the trust story)."""
    findings: List[Finding] = []
    explored = 0
    by_name = {s.name: s for s in specs}
    for spec in specs:
        n, fs = check_family(spec, CLEAN_LAWS)
        explored += n
        findings += fs
    for name, mut in LIN_MUTATIONS.items():
        spec = by_name.get(mut.family)
        if spec is None:
            findings.append(
                Finding(
                    "PTN005",
                    _SELF,
                    0,
                    f"seeded linearizability mutation '{name}' targets "
                    f"unregistered family '{mut.family}' — register the "
                    "family in obligations.LIN_SPECS",
                )
            )
            continue
        n, fs = check_family(spec, mut.laws, stop_at_first=False)
        explored += n
        if not any(f.check == mut.expect for f in fs):
            got = sorted({f.check for f in fs}) or "clean"
            findings.append(
                Finding(
                    "PTN005",
                    _SELF,
                    0,
                    f"seeded linearizability mutation '{name}' was NOT "
                    f"rejected with {mut.expect} (got: {got}) — the "
                    "checker has lost its teeth",
                )
            )
    for field, values in LAW_DOMAINS.items():
        default = getattr(CLEAN_LAWS, field)
        for value in values:
            if value == default:
                continue
            if not any(
                getattr(m.laws, field) == value
                for m in LIN_MUTATIONS.values()
            ):
                findings.append(
                    Finding(
                        "PTN005",
                        _SELF,
                        0,
                        f"mutation knob {field}={value!r} has no "
                        "registered seeded mutation — an unregisterable "
                        "bug the trust story never exercises",
                    )
                )
    return explored, findings
