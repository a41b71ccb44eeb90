"""The port's patrol-protocol (stage 6) against the JAX package's.

``patrol_tpu_torch/analysis/protocol.py`` is a copy of the reference's
model; these tests hold the two to each other and to the port's kernels:

* a differential: for every ``Semantics`` preset and seeded mutation,
  and for the GCRA, concurrency and quota clusters under their clean and
  seeded laws, both packages enumerate the same schedules (counts and
  event trails, in order) and give the same findings (codes, messages
  and the witness schedules in them), line for line;
* every mutation the port's registry (``ops/obligations.py``) lists for
  the protocol stage is rejected by the port with the code the
  reference gives and the registry pins;
* the reference's own cases that need no JAX, run on the port's copy;
* the model's join and admission pinned to the port's kernels on the
  CPU (``merge_batch``, ``delta_fold``, ``HostLanes.take``).

Every comparison is exact: tolerance zero.
"""

import dataclasses

import numpy as np
import pytest
import torch

from patrol_tpu.analysis import protocol as J
from patrol_tpu_torch.analysis import protocol as P
from patrol_tpu_torch.ops.obligations import MUTATIONS as REGISTRY

pytestmark = pytest.mark.protocol

PRESETS = ["CLEAN", "CLEAN_DELTA", "CLEAN_MIXED", "CLEAN_GC", "CLEAN_GC_DELTA",
           "CLEAN_MEMBER", "CLEAN_MEMBER_DELTA"]
LAWS = {
    "gcra": ("GcraLaws", {"view": "own"}),
    "concurrency": ("ConcLaws", {"release": "uncapped"}),
    "hierquota": ("QuotaLaws", {"debit": "leaf-only"}),
}


def _key(findings):
    """A finding without its path (each package anchors in its own file)."""
    return [(f.check, f.line, f.message) for f in findings]


def _sems():
    """(label, reference Semantics, port Semantics) for every preset and
    seeded mutation."""
    out = [(name, getattr(J, name), getattr(P, name)) for name in PRESETS]
    out += [(name, J.MUTATIONS[name], P.MUTATIONS[name]) for name in sorted(J.MUTATIONS)]
    return out


SEMS = _sems()


class TestDifferential:
    def test_presets_and_mutations_are_the_reference_s(self):
        assert sorted(P.MUTATIONS) == sorted(J.MUTATIONS)
        for _, jsem, tsem in SEMS:
            assert dataclasses.asdict(jsem) == dataclasses.asdict(tsem)
        assert P._SELF == "patrol_tpu_torch/analysis/protocol.py"

    @pytest.mark.parametrize("label", [s[0] for s in SEMS])
    def test_check_protocol_gives_the_same_findings(self, label):
        _, jsem, tsem = next(s for s in SEMS if s[0] == label)
        jf, tf = J.check_protocol(jsem), P.check_protocol(tsem)
        assert _key(tf) == _key(jf)
        assert all(f.path == P._SELF for f in tf)

    @pytest.mark.parametrize("label", [s[0] for s in SEMS])
    def test_async_schedule_count_is_the_same(self, label):
        _, jsem, tsem = next(s for s in SEMS if s[0] == label)
        jn, jf = J.check_async_schedules(sem=jsem)
        tn, tf = P.check_async_schedules(sem=tsem)
        assert (tn, _key(tf)) == (jn, _key(jf))

    @pytest.mark.parametrize("bounds", [
        dict(takes=2, disruptions=1),
        dict(takes=2, disruptions=1, refills=1, gcs=1),
        dict(takes=2, disruptions=0, partitions=1),
        dict(n_nodes=3, takes=2, disruptions=0),
    ])
    @pytest.mark.parametrize("label", PRESETS + ["merge-assigns-lww", "gc-drops-admitted-tokens"])
    def test_enumerated_trails_are_the_same(self, label, bounds):
        _, jsem, tsem = next(s for s in SEMS if s[0] == label)

        def trails(mod, sem):
            return [
                (t.events, t.depth_capped,
                 None if t.violation is None else (t.violation.check, t.violation.message),
                 [n.state() for n in t.cluster.nodes])
                for t in mod.enumerate_schedules(sem, mod.ScheduleBounds(**bounds))
            ]

        got, want = trails(P, tsem), trails(J, jsem)
        assert got == want and len(got) > 0

    @pytest.mark.parametrize("family", sorted(J.FAMILY_CHECKS))
    def test_family_checks_clean_and_seeded_give_the_same_findings(self, family):
        assert _key(P.FAMILY_CHECKS[family]()) == _key(J.FAMILY_CHECKS[family]()) == []
        if family in LAWS:
            cls, kw = LAWS[family]
            jf = J.FAMILY_CHECKS[family](laws=getattr(J, cls)(**kw))
            tf = P.FAMILY_CHECKS[family](laws=getattr(P, cls)(**kw))
            assert _key(tf) == _key(jf) and tf

    @pytest.mark.parametrize("cluster", ["GcraCluster", "ConcCluster", "QuotaCluster"])
    def test_family_cluster_enumerations_are_the_same(self, cluster):
        bounds = dict(takes=2, disruptions=1, extras=2)

        def trails(mod):
            cls = getattr(mod, cluster)
            return [
                (t.events, t.depth_capped, t.cluster.memo_key())
                for t in mod.enumerate_schedules(
                    mod.CLEAN, mod.ScheduleBounds(**bounds), lambda n, l, s: cls(n, l, s)
                )
            ]

        got, want = trails(P), trails(J)
        assert got == want and len(got) > 0

    def test_check_repo_is_clean_in_both(self):
        assert P.check_repo() == [] and J.check_repo() == []


class TestRegisteredMutations:
    """Each protocol-stage mutation of the port's registry is rejected
    by the port with the code the reference gives, and that code is the
    one the registry pins."""

    @pytest.mark.parametrize("name", sorted(m.name for m in REGISTRY if m.stage == "protocol"))
    def test_rejected_with_the_reference_s_code(self, name):
        m = next(x for x in REGISTRY if x.name == name)
        if m.laws is not None:
            cls = type(m.laws).__name__
            kw = dataclasses.asdict(m.laws)
            tf = P.FAMILY_CHECKS[m.target](laws=m.laws)
            jf = J.FAMILY_CHECKS[m.target](laws=getattr(J, cls)(**kw))
        else:
            tf = P.check_protocol(P.MUTATIONS[m.target])
            jf = J.check_protocol(J.MUTATIONS[m.target])
        assert _key(tf) == _key(jf)
        assert m.expect in {f.check for f in tf}

    def test_registry_counts(self):
        stages = [m.stage for m in REGISTRY]
        assert stages.count("protocol") == 12 and stages.count("lin") == 4


class TestCleanProtocol:
    def test_clean_protocol_has_no_findings(self):
        assert P.check_protocol(P.CLEAN) == []

    def test_async_exploration_is_nontrivial(self):
        """The DFS must actually explore a schedule space, not
        short-circuit — a bound regression that collapses it to a handful
        of schedules would quietly gut the gate."""
        explored, findings = P.check_async_schedules()
        assert findings == []
        assert explored >= 20

    def test_ap_bound_exact_without_partition(self):
        """Sanity on the model itself: one side, sync delivery — admitted
        is exactly the limit, never more."""
        c = P.Cluster(3, 4, P.CLEAN)
        for i in [0, 1, 2, 0, 1, 2, 0, 1, 2]:
            c.take(i)
            c.deliver_all(within_side_only=True)
        assert sum(n.admitted for n in c.nodes) == 4

    def test_partitioned_sides_each_enforce_the_limit(self):
        c = P.Cluster(3, 2, P.CLEAN)
        c.set_partition({0: 0, 1: 1, 2: 1})
        for i in [0, 0, 0, 1, 2, 1, 2]:
            c.take(i)
            c.deliver_all(within_side_only=True)
        assert sum(n.admitted for n in c.nodes) == 4  # 2 sides × limit 2
        c.heal_and_converge()
        states = {n.state() for n in c.nodes}
        assert len(states) == 1


class TestMutationsRejected:
    @pytest.mark.parametrize("name", sorted(P.MUTATIONS))
    def test_mutation_is_caught(self, name):
        findings = P.check_protocol(P.MUTATIONS[name])
        assert findings, f"mutation {name!r} slipped through the checker"

    def test_check_repo_clean(self):
        assert P.check_repo() == []

    def test_check_repo_flags_a_toothless_checker(self, monkeypatch):
        """If a mutation stops being caught, check_repo must say so
        (PTC005) rather than silently passing."""
        monkeypatch.setitem(
            P.MUTATIONS, "no-op-mutation", P.Semantics()
        )
        findings = P.check_repo()
        assert any(f.check == "PTC005" for f in findings)


class TestDeltaProtocol:
    def test_clean_delta_and_mixed_pass_every_invariant(self):
        assert P.check_protocol(P.CLEAN_DELTA) == []
        assert P.check_protocol(P.CLEAN_MIXED) == []

    def test_v1_node_ignores_delta_packets(self):
        """Mixed cluster: delivering a v2 interval at the v1 node is a
        no-op (the real wire reads it as an incast request for a reserved
        name)."""
        c = P.Cluster(3, 2, P.CLEAN_MIXED)
        assert c.caps == [True, True, False]
        before = c.nodes[2].state()
        c._apply_packet(2, ("delta", 0, 1, ((0, 0, 1),)))
        assert c.nodes[2].state() == before
        # And the sender never addresses delta intervals to it.
        c.take(0)
        c.flush(0)
        assert all(p[0] == "full" for p in c.links[(0, 2)])
        assert all(p[0] == "delta" for p in c.links[(0, 1)])

    def test_interval_loss_recovered_by_retransmit_not_ae(self):
        """A dropped interval stays unacked; the convergence procedure's
        retransmit (NOT anti-entropy — pure-delta clusters get none)
        repairs it."""
        c = P.Cluster(2, 2, P.CLEAN_DELTA)
        c.take(0)
        c.flush(0)
        assert c.nodes[0].unacked[1] != {}
        c.drop(0, 1, 0)  # the interval is lost on the wire
        assert c.nodes[0].unacked[1] != {}  # ...but not forgotten
        c.heal_and_converge()  # raises PTC001 if retransmit were broken
        assert c.nodes[1].taken == c.nodes[0].taken

    def test_delivery_acks_and_gcs_the_interval(self):
        c = P.Cluster(2, 2, P.CLEAN_DELTA)
        c.take(0)
        c.flush(0)
        c.deliver(0, 1, 0)
        assert c.nodes[0].unacked[1] == {}  # ack vector GC'd the record


class TestModelMatchesKernels:
    """The model's joins and admission against the port's kernels on the
    CPU (the plain versions of ``join.cu`` and ``take.cu``)."""

    def test_model_join_is_the_merge_kernel_join(self):
        from patrol_tpu_torch.models.limiter import LimiterConfig, init_state
        from patrol_tpu_torch.ops.merge import MergeBatch, merge_batch

        nodes = 4
        state = init_state(LimiterConfig(buckets=8, nodes=nodes), device="cpu")
        rows = np.array([0, 0, 0, 0, 0, 0], np.int64)
        slots = np.array([0, 1, 0, 2, 1, 3], np.int64)
        added = np.array([5, 3, 2, 7, 9, 1], np.int64)
        taken = np.array([2, 8, 6, 1, 3, 4], np.int64)
        elapsed = np.array([1, 2, 3, 4, 5, 6], np.int64)
        out = merge_batch(
            state,
            MergeBatch(
                rows=torch.from_numpy(rows),
                slots=torch.from_numpy(slots),
                added_nt=torch.from_numpy(added),
                taken_nt=torch.from_numpy(taken),
                elapsed_ns=torch.from_numpy(elapsed),
            ),
        )
        node = P.Node(0, nodes, limit=0)
        for s, a, t in zip(slots, added, taken):
            node.merge([(int(s), int(a), int(t))], P.CLEAN)
        pn = out.pn[0].numpy()
        assert list(pn[:, 0]) == node.added
        assert list(pn[:, 1]) == node.taken

    def test_model_delta_join_is_the_delta_fold_kernel_join(self):
        from patrol_tpu_torch.models.limiter import LimiterConfig, init_state
        from patrol_tpu_torch.ops.delta import DeltaBatch, delta_fold

        nodes = 4
        state = init_state(LimiterConfig(buckets=8, nodes=nodes), device="cpu")
        slots = np.array([0, 1, 0, 2, 1, 3], np.int64)
        added = np.array([5, 3, 2, 7, 9, 1], np.int64)
        taken = np.array([2, 8, 6, 1, 3, 4], np.int64)
        out = delta_fold(
            state,
            DeltaBatch(
                rows=torch.zeros(6, dtype=torch.int64),
                slots=torch.from_numpy(slots),
                added_nt=torch.from_numpy(added),
                taken_nt=torch.from_numpy(taken),
                elapsed_ns=torch.zeros(6, dtype=torch.int64),
            ),
        )
        cluster = P.Cluster(nodes, 0, P.CLEAN_DELTA)
        for s, a, t in zip(slots, added, taken):
            cluster._apply_packet(0, ("delta", 1, 1, ((int(s), int(a), int(t)),)), ack=False)
        pn = out.pn[0].numpy()
        assert list(pn[:, 0]) == cluster.nodes[0].added
        assert list(pn[:, 1]) == cluster.nodes[0].taken

    def test_model_take_is_the_take_kernel_admission(self):
        """Admission rule parity on the no-refill path: the model admits
        iff the port's HostLanes algebra admits (zero-rate bucket:
        tokens = cap + Σadded − Σtaken)."""
        from patrol_tpu_torch.models.limiter import NANO
        from patrol_tpu_torch.ops.rate import Rate
        from patrol_tpu_torch.runtime.engine import HostLanes

        # Frozen clock ⇒ no grants: the exact algebra the model uses.
        lanes = HostLanes(nodes=2)
        rate = Rate(freq=3, per_ns=3600 * NANO)
        model = P.Node(0, 2, limit=3)
        for _ in range(5):
            _, ok = lanes.take(
                cap_base_nt=3 * NANO, created_ns=0, now_ns=0,
                rate=rate, count=1, node_slot=0,
            )
            assert ok == model.take(P.CLEAN)
        assert model.admitted == 3


class TestGcConservation:
    """Bucket-lifecycle GC transitions (ROADMAP item 4): the clean
    reclaim-with-tombstone design conserves admitted tokens and heals to
    the exact join on both wire planes; the two seeded lifecycle
    mutations are demonstrably rejected."""

    def test_clean_gc_passes_every_invariant(self):
        assert P.check_protocol(P.CLEAN_GC) == []
        assert P.check_protocol(P.CLEAN_GC_DELTA) == []

    def test_gc_predicate_gates_the_collect(self):
        """A spent (un-refilled) bucket refuses to collect; a refilled
        one collects, keeping the own lane (the tombstone residue)."""
        c = P.Cluster(2, 2, P.CLEAN_GC)
        c.take(0)
        assert not c.nodes[0].gc(P.CLEAN_GC)  # tokens < limit
        c.refill(0)
        assert c.nodes[0].gc(P.CLEAN_GC)
        assert c.nodes[0].taken[0] == 1  # own lane survived
        assert c.nodes[0].added[0] == 1

    def test_naive_gc_witness_loses_admitted_tokens(self):
        """The conservation witness, by hand: collect dropping the own
        lane, then the peer's stale echo absorbs the post-collect spend
        and the forgotten take re-admits."""
        sem = P.MUTATIONS["gc-drops-admitted-tokens"]
        c = P.Cluster(2, 1, sem)
        c.take(0)
        c.deliver_all()
        c.refill(0)
        c.deliver_all()
        c.gc(0)  # naive: own lane dropped with the bucket
        c.take(0)
        c.deliver_all()  # peer still holds the OLD t0=1 — echo absorbs
        c.take(1)
        admitted = sum(n.admitted for n in c.nodes)
        granted = sum(n.granted for n in c.nodes)
        assert admitted > 1 + granted  # the PTC006 bound breaks

    def test_gc_drops_admitted_tokens_rejected(self):
        f = P.check_protocol(P.MUTATIONS["gc-drops-admitted-tokens"])
        assert any(x.check == "PTC006" for x in f)

    def test_deaf_collected_bucket_rejected(self):
        f = P.check_protocol(P.MUTATIONS["gc-treats-collected-as-unknown"])
        assert any(x.check == "PTC001" for x in f)

    def test_forfeit_clamp_matches_kernel_law(self):
        """The model's over-capacity forfeit mirrors ops/take.py: a view
        past capacity admits at most `limit`, booking the excess into
        the own taken lane (monotone, never a negative grant)."""
        c = P.Cluster(2, 2, P.CLEAN_GC)
        n0 = c.nodes[0]
        n0.added[1] = 3  # a peer's granted lanes, spend copy dropped
        assert n0.take(P.CLEAN_GC)
        assert n0.taken[0] == 3 + 1  # forfeit 3 + the take itself
        admitted = 0
        while n0.take(P.CLEAN_GC):
            admitted += 1
        assert admitted == 1  # only `limit` worth was admittable

    def test_gc_mid_partition_heals_to_exact_join(self):
        """One side collects while the other still holds its lanes:
        heal + AE must reconverge bit-exactly to the join."""
        for sem in (P.CLEAN_GC, P.CLEAN_GC_DELTA):
            c = P.Cluster(2, 2, sem)
            c.take(0)
            c.take(1)
            c.flush(0)
            c.flush(1)
            c.deliver_all()
            c.set_partition({0: 0, 1: 1})
            c.refill(0)
            c.refill(0)
            c.flush(0)
            c.gc(0)  # full again on node 0's side: collect fires
            c.heal_and_converge()
            states = {n.state() for n in c.nodes}
            assert len(states) == 1, sem


class TestScheduleEnumerator:
    """The reusable enumerate_schedules generator (the ONE schedule
    space stages 6 and 8 both consume): terminals carry replayable
    event trails, the budget-derived depth cap is honored and marked,
    and a cluster_factory subclass rides the same enumeration."""

    def _replay(self, events, sem, bounds):
        c = P.Cluster(bounds.n_nodes, bounds.limit, sem)
        for mv in events:
            if mv[0] == "take":
                c.take(mv[1])
            elif mv[0] == "refill":
                c.refill(mv[1])
            elif mv[0] == "gc":
                c.gc(mv[1])
            elif mv[0] == "partition":
                c.set_partition(dict(mv[1]))
            elif mv[0] == "heal":
                c.set_partition(None)
            elif mv[0] == "flush":
                c.flush(mv[1])
            elif mv[0] == "deliver":
                c.deliver(mv[1], mv[2], mv[3])
            elif mv[0] == "dup":
                c.deliver(mv[1], mv[2], mv[3], dup=True)
            else:  # drop
                c.drop(mv[1], mv[2], mv[3])
        return c

    def test_every_terminal_trail_replays_to_its_state(self):
        bounds = P.ScheduleBounds(takes=2, disruptions=1)
        for term in P.enumerate_schedules(P.CLEAN, bounds):
            replayed = self._replay(term.events, P.CLEAN, bounds)
            assert [n.state() for n in replayed.nodes] == [
                n.state() for n in term.cluster.nodes
            ], term.events

    def test_explored_count_matches_the_stage6_consumer(self):
        """check_async_schedules is a thin consumer: on the clean
        protocol (no early break) its explored count IS the generator's
        terminal count for the same bounds."""
        explored, findings = P.check_async_schedules()
        assert findings == []
        terminals = sum(1 for _ in P.enumerate_schedules(P.CLEAN))
        assert terminals == explored

    def test_depth_cap_is_marked_not_silent(self):
        bounds = P.ScheduleBounds(takes=2, disruptions=0, depth=1)
        terms = list(P.enumerate_schedules(P.CLEAN, bounds))
        assert terms
        assert all(t.depth_capped for t in terms)
        assert all(len(t.events) <= 1 for t in terms)

    def test_cluster_factory_rides_the_enumeration(self):
        class Tagged(P.Cluster):
            def _clone_empty(self):
                return Tagged(len(self.nodes), self.nodes[0].limit, self.sem)

        made = []

        def factory(n, limit, sem):
            made.append((n, limit))
            return Tagged(n, limit, sem)

        bounds = P.ScheduleBounds(takes=1, disruptions=0)
        terms = list(P.enumerate_schedules(P.CLEAN, bounds, factory))
        assert made == [(bounds.n_nodes, bounds.limit)]
        assert terms and all(isinstance(t.cluster, Tagged) for t in terms)


class TestExtendedAlphabet:
    """enumerate_schedules with a family's OWN move alphabet (the
    ``extras`` budget → Cluster.extra_moves): trails that contain
    family moves still replay bit-exactly, the memoizer keys on the
    extra state (so advance/release-differing prefixes are not
    collapsed), and the depth cap marks extra-heavy schedules instead
    of silently dropping them."""

    def _replay_with(self, factory, events, sem, bounds):
        c = factory(bounds.n_nodes, bounds.limit, sem)
        for mv in events:
            if mv[0] == "take":
                c.take(mv[1])
            elif mv[0] == "refill":
                c.refill(mv[1])
            elif mv[0] == "gc":
                c.gc(mv[1])
            elif mv[0] == "partition":
                c.set_partition(dict(mv[1]))
            elif mv[0] == "heal":
                c.set_partition(None)
            elif mv[0] == "flush":
                c.flush(mv[1])
            elif mv[0] == "deliver":
                c.deliver(mv[1], mv[2], mv[3])
            elif mv[0] == "dup":
                c.deliver(mv[1], mv[2], mv[3], dup=True)
            elif mv[0] == "drop":
                c.drop(mv[1], mv[2], mv[3])
            else:  # a family-specific move rides the same replay path
                c.apply_extra(mv)
        return c

    def test_gcra_advance_trails_replay_to_their_state(self):
        bounds = P.ScheduleBounds(takes=2, disruptions=1, extras=2)
        factory = lambda n, l, s: P.GcraCluster(n, l, s)  # noqa: E731
        terms = list(P.enumerate_schedules(P.CLEAN, bounds, factory))
        assert terms
        with_advance = 0
        for term in terms:
            assert term.violation is None, term.events
            if any(mv[0] == "advance" for mv in term.events):
                with_advance += 1
            replayed = self._replay_with(
                factory, term.events, P.CLEAN, bounds
            )
            assert replayed.memo_key() == term.cluster.memo_key(), (
                term.events
            )
        assert with_advance > 0, "extras budget never spent"

    def test_conc_release_trails_replay_to_their_state(self):
        bounds = P.ScheduleBounds(takes=2, disruptions=1, extras=2)
        factory = lambda n, l, s: P.ConcCluster(n, l, s)  # noqa: E731
        terms = list(P.enumerate_schedules(P.CLEAN, bounds, factory))
        assert any(
            mv[0] == "release" for t in terms for mv in t.events
        ), "extras budget never spent"
        for term in terms:
            assert term.violation is None, term.events
            replayed = self._replay_with(
                factory, term.events, P.CLEAN, bounds
            )
            assert replayed.memo_key() == term.cluster.memo_key(), (
                term.events
            )

    def test_memoizer_keys_on_the_extra_state(self):
        """Two prefixes identical except for a family move must not be
        memo-collapsed — the extra state is part of memo_key."""
        g = P.GcraCluster(2, 2, P.CLEAN)
        before = g.memo_key()
        g.apply_extra(("advance",))
        assert g.memo_key() != before

        c = P.ConcCluster(2, 2, P.CLEAN)
        c.take(0)
        held = c.memo_key()
        c.apply_extra(("release", 0))
        assert c.memo_key() != held
        # Clamped no-op release (nothing of ours held): key unchanged.
        c2 = P.ConcCluster(2, 2, P.CLEAN)
        idle = c2.memo_key()
        c2.apply_extra(("release", 0))
        assert c2.memo_key() == idle

    def test_memoization_preserves_advance_distinct_terminals(self):
        """The enumeration must reach terminals at EVERY advance count
        the budget allows — a memoizer that ignored the clock would
        fold them together."""
        bounds = P.ScheduleBounds(takes=3, disruptions=0, extras=2)
        factory = lambda n, l, s: P.GcraCluster(n, l, s)  # noqa: E731
        terms = list(P.enumerate_schedules(P.CLEAN, bounds, factory))
        assert {t.cluster.advances for t in terms} == {0, 1, 2}

    def test_advance_extends_the_admission_frontier(self):
        """Clock advance admits conforming requests past the burst.
        On a single node (schedules whose takes all land on node 0 —
        cross-node schedules may legitimately overshoot while async):
        zero advances admit at most the burst (= limit); at least one
        advance schedule exceeds it."""
        bounds = P.ScheduleBounds(takes=3, disruptions=0, extras=2)
        factory = lambda n, l, s: P.GcraCluster(n, l, s)  # noqa: E731
        over_burst = 0
        for term in P.enumerate_schedules(P.CLEAN, bounds, factory):
            if any(
                mv[0] == "take" and mv[1] != 0 for mv in term.events
            ):
                continue
            admitted = term.cluster.nodes[0].admitted
            if term.cluster.advances == 0:
                assert admitted <= bounds.limit, term.events
            if admitted > bounds.limit:
                assert term.cluster.advances > 0, term.events
                over_burst += 1
        assert over_burst > 0

    def test_extra_budget_is_a_hard_bound(self):
        bounds = P.ScheduleBounds(takes=1, disruptions=0, extras=2)
        factory = lambda n, l, s: P.GcraCluster(n, l, s)  # noqa: E731
        for term in P.enumerate_schedules(P.CLEAN, bounds, factory):
            n_adv = sum(1 for mv in term.events if mv[0] == "advance")
            assert n_adv <= bounds.extras
            assert term.cluster.advances == n_adv

    def test_depth_cap_marks_extra_heavy_trails(self):
        bounds = P.ScheduleBounds(takes=1, disruptions=0, extras=2, depth=1)
        factory = lambda n, l, s: P.GcraCluster(n, l, s)  # noqa: E731
        terms = list(P.enumerate_schedules(P.CLEAN, bounds, factory))
        assert terms
        assert all(t.depth_capped for t in terms)
        assert all(len(t.events) <= 1 for t in terms)
