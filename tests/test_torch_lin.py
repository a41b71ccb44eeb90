"""The port's patrol-lin (stage 8) against the JAX package's, and its
sequential specs pinned to the port's kernels.

* **differential**: ``check_family`` of every registered family, under
  the clean laws and under each seeded mutation, gives the same explored
  counts and findings (codes, messages with their witness schedules) in
  ``patrol_tpu_torch.analysis.linearizability`` and
  ``patrol_tpu.analysis.linearizability``; the registries list the same
  families and mutations;
* **kernel pins** (the counterparts of ``tests/test_lin.py``'s
  differential tests, on the port's kernels on the CPU, i.e. their plain
  versions): ``HostLanes.take`` and ``take_n_batch`` against the
  sequential take spec on a frozen clock, ``delta_fold`` against the
  model's delta visibility, ``host_lifecycle_full`` and
  ``lifecycle_probe`` against the GC gate, and ``gcra_take_batch``,
  ``conc_acquire_batch`` and ``quota_take_batch`` against
  ``SequentialGcra``, ``SequentialConc`` and ``SequentialQuota``
  (``analysis/lin_pins.py``, which ``chip_smoke.py`` phase 3k runs on
  the card), each pin shown to fail on a spec off by one;
* the reference's spec, fixture, mutation and trust-story cases on the
  port's copy and registry. The repo gate runs once per module, and the
  three trust-story defects share one further run.

Every comparison is exact: tolerance zero.
"""

import numpy as np
import pytest
import torch

from patrol_tpu.analysis import linearizability as JL
from patrol_tpu_torch.analysis import lin_pins
from patrol_tpu_torch.analysis import linearizability as L
from patrol_tpu_torch.analysis import protocol as P

pytestmark = pytest.mark.lin

NANO = 1_000_000_000


def specs():
    from patrol_tpu_torch.ops.obligations import LIN_SPECS

    return LIN_SPECS


def ref_specs():
    from patrol_tpu.ops.obligations import LIN_SPECS

    return LIN_SPECS


def spec_by_name(name):
    return next(s for s in specs() if s.name == name)


def codes(findings):
    return sorted({f.check for f in findings})


def _key(findings):
    return [(f.check, f.line, f.message) for f in findings]


def _family_runs(mod, spec_list):
    """name → (explored, findings): every family under the clean laws,
    and every seeded mutation (by its name) on its family."""
    by_name = {s.name: s for s in spec_list}
    out = {s.name: mod.check_family(s, mod.CLEAN_LAWS) for s in spec_list}
    for name, mut in mod.LIN_MUTATIONS.items():
        out[name] = mod.check_family(by_name[mut.family], mut.laws, stop_at_first=False)
    return out


@pytest.fixture(scope="module")
def families():
    return {"port": _family_runs(L, specs()), "ref": _family_runs(JL, ref_specs())}


@pytest.fixture(scope="module")
def repo_gate():
    return L.check_repo(specs())


@pytest.fixture(scope="module")
def defective_gate():
    """One gate run with the three trust-story defects at once: a
    mutation that does nothing, one on an unregistered family, and the
    ``clairvoyant`` knob left without a mutation."""
    pruned = {k: v for k, v in L.LIN_MUTATIONS.items() if v.laws.take != "clairvoyant"}
    pruned["does-nothing"] = L.LinMutation(
        L.CLEAN_LAWS, family="ops.take.take_batch", expect="PTN001"
    )
    pruned["orphan"] = L.LinMutation(
        L.LinLaws(take="off-by-one"), family="ops.nonexistent.kernel", expect="PTN003"
    )
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(L, "LIN_MUTATIONS", pruned)
        return L.check_repo(specs())


class TestDifferential:
    def test_registries_list_the_same_families_and_mutations(self):
        mine = [(s.name, s.func, s.wire, s.lifecycle, s.algebra) for s in specs()]
        ref = [(s.name, s.func, s.wire, s.lifecycle, s.algebra) for s in ref_specs()]
        assert mine == ref
        assert all(s.module == "patrol_tpu_torch." + s.name.rsplit(".", 1)[0]
                   for s in specs())
        assert {k: (m.family, m.expect, m.laws.take, m.laws.gc)
                for k, m in L.LIN_MUTATIONS.items()} == {
            k: (m.family, m.expect, m.laws.take, m.laws.gc) for k, m in JL.LIN_MUTATIONS.items()}
        assert L.LAW_DOMAINS == JL.LAW_DOMAINS and L.ALGEBRAS == JL.ALGEBRAS

    @pytest.mark.parametrize(
        "run", [s.name for s in ref_specs()] + sorted(JL.LIN_MUTATIONS)
    )
    def test_check_family_gives_the_same_findings(self, families, run):
        (tn, tf), (jn, jf) = families["port"][run], families["ref"][run]
        assert (tn, _key(tf)) == (jn, _key(jf))
        assert all(f.path == "patrol_tpu_torch/analysis/linearizability.py" for f in tf)

    def test_repo_gates_agree(self, repo_gate):
        jn, jf = JL.check_repo(ref_specs())
        tn, tf = repo_gate
        assert (tn, _key(tf)) == (jn, _key(jf)) == (jn, [])


class TestSequentialSpec:
    def test_take_grants_down_to_zero_then_refuses(self):
        s = L.SequentialSpec(2)
        assert s.take() and s.take() and not s.take()
        assert s.tokens == 0

    def test_refill_caps_at_capacity(self):
        s = L.SequentialSpec(2)
        s.take()
        s.refill(5)
        assert s.tokens == 2

    def test_debit_replays_partition_overshoot_negative(self):
        s = L.SequentialSpec(1)
        s.debit()
        s.debit()
        assert s.tokens == -1  # the priced AP overshoot, not a grant

    def test_gc_is_permitted_only_at_full(self):
        s = L.SequentialSpec(2)
        assert s.gc()
        s.take()
        assert not s.gc()
        s.refill()
        assert s.gc()


class TestDifferentialTakeKernel:
    """The model's take law IS the port's admission — grant-for-grant
    against HostLanes.take (the host twin of take-n) and take_n_batch on
    a frozen clock."""

    def _lanes(self, nodes=2):
        from patrol_tpu_torch.runtime.engine import HostLanes

        return HostLanes(nodes=nodes)

    def _rate(self):
        from patrol_tpu_torch.ops.rate import Rate

        return Rate(freq=3, per_ns=3600 * NANO)

    def test_spec_is_the_kernel_admission_sequence(self):
        lanes, rate = self._lanes(), self._rate()
        spec = L.SequentialSpec(3)
        for _ in range(5):
            _, ok = lanes.take(
                cap_base_nt=3 * NANO, created_ns=0, now_ns=0,
                rate=rate, count=1, node_slot=0,
            )
            assert ok == spec.take()

    def test_model_take_is_the_kernel_admission_sequence(self):
        lanes, rate = self._lanes(), self._rate()
        c = L.LinCluster(2, 3)
        for k in range(5):
            _, ok = lanes.take(
                cap_base_nt=3 * NANO, created_ns=0, now_ns=0,
                rate=rate, count=1, node_slot=0,
            )
            c.take(0)
            assert c.ledger.ops[k].granted == ok
        assert [int(t) // NANO for t in lanes.taken] == c.nodes[0].taken

    def test_forfeit_clamp_matches_the_kernel(self):
        lanes, rate = self._lanes(), self._rate()
        lanes.added[1] = 5 * NANO  # merged remote refills push past cap
        _, ok = lanes.take(
            cap_base_nt=3 * NANO, created_ns=0, now_ns=0,
            rate=rate, count=1, node_slot=0,
        )
        assert ok
        c = L.LinCluster(2, 3)
        c.nodes[0].added[1] = 5
        c.take(0)
        assert c.ledger.ops[0].granted
        assert [int(t) // NANO for t in lanes.taken] == c.nodes[0].taken
        assert [int(a) // NANO for a in lanes.added] == c.nodes[0].added
        assert c.ledger.ops[0].lane == ("taken", 6)

    def test_take_batch_is_the_spec_one_request_at_a_time(self):
        """take_batch (the unpacked take-n) at nreq = 1, call by call, on
        a frozen clock: the sequential spec's grants and balances."""
        from patrol_tpu_torch.models.limiter import LimiterConfig, init_state
        from patrol_tpu_torch.ops.take import TakeRequest, take_batch

        state = init_state(LimiterConfig(buckets=4, nodes=2), device="cpu")
        spec = L.SequentialSpec(3)

        def col(v):
            return torch.tensor([v], dtype=torch.int64)

        for i in range(5):
            have = spec.tokens
            state, res = take_batch(state, TakeRequest(
                rows=col(1), now_ns=col(0), freq=col(3), per_ns=col(3600 * NANO),
                count_nt=col(NANO), nreq=col(1), cap_base_nt=col(3 * NANO),
                created_ns=col(0),
            ), node_slot=i % 2)
            assert int(res.admitted[0]) == int(spec.take())
            assert int(res.have_nt[0]) == have * NANO


class TestDifferentialDeltaVisibility:
    """The delta-plane visibility is the wire-v2 fold: the model's lane
    state after ingesting an interval equals the port's delta_fold over
    the same interval."""

    def test_model_fold_is_the_delta_fold_kernel(self):
        from patrol_tpu_torch.models.limiter import LimiterConfig, init_state
        from patrol_tpu_torch.ops.delta import DeltaBatch, delta_fold

        c = L.LinCluster(2, 2, wire="delta")
        c.take(0)
        c.take(0)
        c.flush(0)
        c.deliver_all()
        out = delta_fold(
            init_state(LimiterConfig(buckets=4, nodes=2), device="cpu"),
            DeltaBatch(
                rows=torch.zeros(1, dtype=torch.int64),
                slots=torch.zeros(1, dtype=torch.int64),
                added_nt=torch.tensor([c.nodes[0].added[0]]),
                taken_nt=torch.tensor([c.nodes[0].taken[0]]),
                elapsed_ns=torch.zeros(1, dtype=torch.int64),
            ),
        )
        pn = out.pn[0].numpy()
        assert list(pn[:, 0]) == c.nodes[1].added
        assert list(pn[:, 1]) == c.nodes[1].taken

    def test_fold_watermarks_carry_visibility(self):
        c = L.LinCluster(2, 2, wire="delta")
        c.take(0)
        c.take(0)
        assert c.seen[1] == set()
        c.flush(0)
        c.deliver_all()
        assert c.seen[1] == {0, 1}

    def test_undelivered_ops_stay_invisible(self):
        c = L.LinCluster(2, 2)
        c.take(0)
        assert c.seen[1] == set()


class TestDifferentialLifecycle:
    """The model's GC law is the lifecycle IsZero reclaim, through the
    port's host twin and its probe (plain version on the CPU)."""

    def _full(self, sum_added_nt, sum_taken_nt, cap_nt):
        from patrol_tpu_torch.ops.lifecycle import host_lifecycle_full

        return bool(
            host_lifecycle_full(
                np.asarray([sum_added_nt], np.int64),
                np.asarray([sum_taken_nt], np.int64),
                np.asarray([0], np.int64),
                np.asarray([cap_nt], np.int64),
                np.asarray([0], np.int64),
                np.asarray([0], np.int64),
                np.asarray([3600 * NANO], np.int64),
            )[0]
        )

    def test_gc_gate_is_the_iszero_verdict(self):
        c = L.LinCluster(2, 2, lifecycle=True)
        c.take(0)
        node = c.nodes[0]
        assert not self._full(
            NANO * sum(node.added), NANO * sum(node.taken), 2 * NANO
        )
        assert not node.gc(c.sem)
        c.refill(0)
        assert self._full(
            NANO * sum(node.added), NANO * sum(node.taken), 2 * NANO
        )
        assert node.gc(c.sem)

    def test_clean_collect_keeps_the_tombstoned_own_lane(self):
        c = L.LinCluster(2, 1, lifecycle=True)
        c.take(0)
        c.refill(0)
        c.gc(0)
        assert c.nodes[0].added[0] == 1
        assert c.nodes[0].taken[0] == 1

    def test_forget_admits_collect_drops_the_own_lane(self):
        c = L.LinCluster(
            2, 1, laws=L.LinLaws(gc="forget-admits"), lifecycle=True
        )
        c.take(0)
        c.refill(0)
        c.gc(0)
        assert c.nodes[0].added[0] == 0
        assert c.nodes[0].taken[0] == 0


class TestKernelPins:
    """analysis/lin_pins.py on the CPU: every spec equals its kernel's
    plain version over histories from a seed, and each pin rejects a spec
    that is off by one (the pins are not vacuous)."""

    @pytest.mark.parametrize("pin", sorted(lin_pins.PINS))
    @pytest.mark.parametrize("seed", [0, 1])
    def test_spec_equals_the_kernel(self, pin, seed):
        res = lin_pins.PINS[pin]("cpu", np.random.default_rng(seed))
        assert res["mismatches"] == [] and res["mismatch_count"] == 0
        assert res["calls"] == 24 and res["columns"] == 24 * 64

    @pytest.mark.parametrize("pin,cls,method,mutant", [
        ("take", "SequentialSpec", "take", "_take_at_one_short"),
        ("lifecycle", "SequentialSpec", "gc", "_gc_one_short_of_full"),
        ("gcra", "SequentialGcra", "take", "_gcra_window_one_wide"),
        ("conc", "SequentialConc", "acquire", "_conc_one_over"),
        ("quota", "SequentialQuota", "take", "_quota_one_over"),
    ])
    def test_pin_rejects_a_spec_off_by_one(self, monkeypatch, pin, cls, method, mutant):
        monkeypatch.setattr(getattr(lin_pins, cls), method, globals()[mutant])
        res = lin_pins.PINS[pin]("cpu", np.random.default_rng(0))
        assert res["mismatch_count"] > 0 and res["mismatches"]


def _take_at_one_short(self, count=1):
    if self.tokens >= count - 1:
        self.tokens -= count
        return True
    return False


def _gc_one_short_of_full(self):
    return self.tokens >= self.limit - 1


def _gcra_window_one_wide(self, now):
    if self.tat <= now + self.tol + 1:
        self.tat = max(self.tat, now) + 1
        return True
    return False


def _conc_one_over(self, client):
    if sum(self.held) <= self.limit:
        self.held[client] += 1
        return True
    return False


def _quota_one_over(self):
    if all(self.spent <= lim for lim in self.limits):
        self.spent += 1
        return True
    return False


class TestFindingFixtures:
    """Every PTN code both ways: fires on its seeded law, silent on the
    clean law, with the EXACT expected code."""

    def test_clean_take_family_is_silent(self, families):
        explored, findings = families["port"]["ops.take.take_batch"]
        assert findings == []
        assert explored > 100

    def test_clean_delta_family_is_silent(self, families):
        _, findings = families["port"]["ops.delta.delta_fold"]
        assert findings == []

    def test_clean_lifecycle_family_is_silent(self, families):
        _, findings = families["port"]["ops.lifecycle.lifecycle_probe"]
        assert findings == []

    @pytest.mark.parametrize("name", sorted(L.LIN_MUTATIONS))
    def test_each_seeded_mutation_rejected_with_its_exact_code(self, name, families):
        mut = L.LIN_MUTATIONS[name]
        _, findings = families["port"][name]
        assert mut.expect in codes(findings), (name, codes(findings))

    def test_ptn001_message_names_the_ignored_knowledge(self, families):
        _, findings = families["port"]["take-ignores-visible-remote-spend"]
        f = next(x for x in findings if x.check == "PTN001")
        assert "delivered knowledge was ignored" in f.message
        assert "schedule:" in f.message or "events:" in f.message

    def test_ptn003_sync_schedules_prove_full_linearizability(self):
        """The acceptance claim, stated positively: on sync-delivery
        schedules with no partition the clean model is outcome-for-
        outcome the sequential spec (zero PTN003 findings over the
        whole sync suite)."""
        for name in (
            "ops.take.take_batch",
            "ops.lifecycle.lifecycle_probe",
        ):
            explored, findings = L.check_sync_lin(
                spec_by_name(name), L.CLEAN_LAWS
            )
            assert findings == []
            assert explored >= 32  # ≥ (no-partition + split) × |alphabet|^4

    def test_ptn002_partition_schedules_linearizable_up_to_visibility(self):
        """Partition layouts run inside the same sync suite with
        sync=False: each side's outcomes must be justified by side-
        visible history — clean laws produce no PTN002 anywhere."""
        c = L.LinCluster(2, 2)
        c.set_partition({0: 0, 1: 1})
        # Both sides spend their full view independently: the AP
        # overshoot is priced (debit may go negative) but every grant
        # is visible-justified.
        for i in (0, 1):
            c.take(i)
            c.take(i)
            c.take(i)
        c.heal_and_converge()
        c.check_terminal()
        assert sum(n.admitted for n in c.nodes) == 4  # limit × sides

    def test_ptn004_fires_only_with_lifecycle_in_the_alphabet(self):
        """The manufactured-grant class needs a reclaim/refill to do the
        manufacturing: the non-lifecycle families must report the
        ignore-remote bug as PTN001, never PTN004."""
        _, findings = L.check_family(
            spec_by_name("ops.take.take_batch"),
            L.LinLaws(take="ignore-remote"),
            stop_at_first=False,
        )
        assert "PTN004" not in codes(findings)

    def test_findings_carry_replayable_witness_schedules(self, families):
        mut = L.LIN_MUTATIONS["grant-exceeds-spec-on-sync-schedule"]
        _, findings = families["port"]["grant-exceeds-spec-on-sync-schedule"]
        f = next(x for x in findings if x.check == mut.expect)
        assert "(" in f.message and "take" in f.message


class TestTrustStory:
    """PTN005 both ways: the meta-check flags a checker that lost its
    teeth, an unregistered family, and an unexercised mutation knob (one
    gate run with all three defects), and stays silent on the shipped
    registry."""

    def test_toothless_mutation_is_flagged(self, defective_gate):
        _, findings = defective_gate
        assert any(
            f.check == "PTN005" and "does-nothing" in f.message
            for f in findings
        )

    def test_unregistered_family_is_flagged(self, defective_gate):
        _, findings = defective_gate
        assert any(
            f.check == "PTN005" and "unregistered family" in f.message
            for f in findings
        )

    def test_unexercised_law_knob_is_flagged(self, defective_gate):
        _, findings = defective_gate
        assert any(
            f.check == "PTN005" and "clairvoyant" in f.message
            for f in findings
        )

    def test_every_law_knob_has_a_registered_mutation(self):
        for field, values in L.LAW_DOMAINS.items():
            default = getattr(L.CLEAN_LAWS, field)
            for value in values:
                if value == default:
                    continue
                assert any(
                    getattr(m.laws, field) == value
                    for m in L.LIN_MUTATIONS.values()
                ), (field, value)

    def test_every_mutation_expects_a_distinct_code(self):
        expected = {m.expect for m in L.LIN_MUTATIONS.values()}
        assert expected == {"PTN001", "PTN002", "PTN003", "PTN004"}

    def test_registry_pins_the_lin_mutations(self):
        from patrol_tpu_torch.ops.obligations import MUTATIONS

        reg = {m.target: m.expect for m in MUTATIONS if m.stage == "lin"}
        assert reg == {k: m.expect for k, m in L.LIN_MUTATIONS.items()}


class TestRepoGate:
    def test_stage8_repo_gate_is_clean(self, repo_gate):
        explored, findings = repo_gate
        assert findings == [], "\n".join(str(f) for f in findings)
        assert explored > 10_000  # the sweep is not vacuous

    def test_registered_families_cover_the_take_capable_kernels(self):
        import importlib

        names = {s.name for s in specs()}
        assert names == {
            "ops.take.take_batch",
            "ops.take.take_n_batch",
            "ops.delta.delta_fold",
            "ops.lifecycle.lifecycle_probe",
            "ops.gcra.gcra_take_batch",
            "ops.concurrency.conc_acquire_batch",
            "ops.hierquota.quota_take_batch",
        }
        for s in specs():
            assert callable(getattr(importlib.import_module(s.module), s.func)), s.name

    def test_shared_enumerator_is_stage6s(self):
        bounds = P.ScheduleBounds(takes=2, disruptions=1)
        base = {
            t.events
            for t in P.enumerate_schedules(P.CLEAN, bounds)
        }
        lin = {
            t.events
            for t in P.enumerate_schedules(
                P.CLEAN,
                bounds,
                lambda n, limit, sem: L.LinCluster(n, limit),
            )
        }
        assert base and base <= lin
