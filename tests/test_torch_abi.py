"""The port's patrol-abi (stage 5) against its own ``libpatrolhost.so``
(PTA001-PTA005; counterpart of ``tests/test_abi.py``).

Every code is proven BOTH ways: each pass stays silent on the port's
library AND rejects an injected defect — a perturbed Python reference
fold or classify (PTA001), a mutated merge kernel twin (the state-level
differential), a lying take model and illegal lock orderings (PTA004),
seeded rx-ring bugs, and an effects table missing, stale or short of an
export (PTA005; the table is pinned to the library's ``nm -D`` export
list). The fold's kernel twins run on the CPU here (the plain versions);
the ``cuda``-marked case runs them as ``join.cu`` and skips without a
card. A differential holds the port's ``_reference_fold``,
``_reference_classify`` and fold domain to the JAX package's on the same
deltas and seeds. The library is built as the port's other native tests
build it; without a toolchain every case that needs it skips with that
reason. Every comparison is exact: tolerance zero.
"""

import os

import numpy as np
import pytest
import torch

from patrol_tpu_torch import native
from patrol_tpu_torch.analysis import abi
from patrol_tpu_torch.native import NATIVE_EFFECTS
from patrol_tpu_torch.ops.obligations import ABI_OBLIGATIONS

pytestmark = pytest.mark.abi

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NANO = abi.NANO

OBS = {ob.check: ob for ob in ABI_OBLIGATIONS}


@pytest.fixture(scope="module")
def lib():
    if native.load() is None:
        pytest.skip("the port's native host library does not build here (no g++?)")
    return abi._load_lib()


def codes(findings):
    return sorted({f.check for f in findings})


# --- PTA001: fold conformance ---------------------------------------------


class TestFoldConformance:
    def test_shipped_fold_is_silent(self, lib):
        assert abi.check_fold_conformance(OBS["fold_conformance"], lib) == []

    def test_seeded_mutation_of_reference_fold_is_rejected(
        self, lib, monkeypatch
    ):
        """Perturb the Python-side reference fold (the max→add class of
        refactor mistake, applied to the oracle so the built .so plays the
        role of the broken side): the conformance pass must refuse."""
        orig = abi._reference_fold

        def add_fold(*args, **kw):
            out = orig(*args, **kw)
            if out is None:
                return None
            out = list(out)
            out[2] = out[2] + out[3]  # sparse added lane: join became add
            return tuple(out)

        monkeypatch.setattr(abi, "_reference_fold", add_fold)
        f = abi.check_fold_conformance(OBS["fold_conformance"], lib)
        assert "PTA001" in codes(f), f

    def test_kernel_root_mutation_is_rejected(self, lib, monkeypatch):
        """The twins resolve at call time through KERNEL_ROOTS: mutating
        the port's merge_batch (the raw-path oracle) to an add must break
        the state-level agreement."""
        import patrol_tpu_torch.ops.merge as merge_mod

        def add_merge_batch(state, batch):
            pair = torch.stack([batch.added_nt, batch.taken_nt], dim=-1)
            state.pn.index_put_((batch.rows, batch.slots), pair, accumulate=True)
            state.elapsed.scatter_reduce_(0, batch.rows, batch.elapsed_ns, reduce="amax")
            return state

        monkeypatch.setattr(merge_mod, "merge_batch", add_merge_batch)
        f = abi.check_fold_conformance(OBS["fold_conformance"], lib)
        assert "PTA001" in codes(f)
        assert any("state diverges" in x.message for x in f)

    def test_native_fold_bails_exactly_like_reference(self, lib):
        bad_slot = np.array([[0, 9, 1, 0, 0]], np.int64)
        kw = dict(nodes=2, row_dense_min=2, max_distinct=8, cap_dense=8)
        assert abi._fold_of(lib, bad_slot, **kw) is None
        assert (
            abi._reference_fold(
                bad_slot[:, 0], bad_slot[:, 1], bad_slot[:, 2],
                bad_slot[:, 3], bad_slot[:, 4], **kw
            )
            is None
        )

    def test_state_paths_agree_on_the_cpu(self, lib):
        """The two paths into state, through the port's merge wrappers
        on an explicit CPU device: the native fold applied through
        merge_batch_folded/merge_rows_dense equals the raw batch through
        merge_batch."""
        kernels = abi._resolve_twins(OBS["fold_conformance"])
        batch = np.array(
            [[1, 0, 3, 0, 3], [1, 1, 0, 3, 0], [1, 0, 1, 1, 1], [0, 1, 3, 3, 3]], np.int64
        )
        out = abi._fold_of(lib, batch, **abi._FOLD_KW)
        via_fold = abi._apply_fold_via_kernels(out, 3, 2, kernels, device="cpu")
        via_raw = abi._apply_raw_via_merge_batch(batch, 3, 2, kernels, device="cpu")
        assert np.array_equal(via_fold[0], via_raw[0])
        assert np.array_equal(via_fold[1], via_raw[1])
        assert via_raw[0][1].tolist() == [[3, 1], [0, 3]]


@pytest.mark.cuda
def test_abi_on_the_card_launches_the_join():
    """Every obligation on the card (a card run; chip_smoke.py phase 3k
    runs the same): clean, with the fold's twins launching join.cu."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels do not run on the CPU")
    from patrol_tpu_torch.ops import _build

    _build.reset_launches()
    assert abi.abi_all(device="cuda") == []
    assert _build.LAUNCHES["pair_join"] + _build.LAUNCHES["row_join"] > 0


class TestReferenceDifferential:
    """The port's Python references equal the JAX package's, on the same
    deltas and seeds."""

    def test_fold_domain_is_the_reference_s(self):
        from patrol_tpu.analysis.prove import JoinDomain

        assert np.array_equal(
            abi._fold_domain_deltas(), JoinDomain(B=3, N=2).deltas((0, 3))
        )

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_reference_fold_is_the_reference_s(self, seed):
        from patrol_tpu.analysis import abi as jabi

        rng = np.random.default_rng(seed)
        deltas = abi._fold_domain_deltas()
        for n in (1, 2, 5, 9, 24, 64):
            batch = deltas[rng.integers(0, len(deltas), size=n)].copy()
            if n == 9:
                batch[3, 1] = 7  # a malformed slot: both bail
            for kw in (abi._FOLD_KW, dict(abi._FOLD_KW, cap_dense=1),
                       dict(abi._FOLD_KW, max_distinct=2)):
                cols = [batch[:, i] for i in range(5)]
                got, want = abi._reference_fold(*cols, **kw), jabi._reference_fold(*cols, **kw)
                assert abi._fold_outputs_equal(got, want), (n, kw)

    @pytest.mark.parametrize("seed", [0, 1])
    def test_reference_classify_is_the_reference_s(self, seed):
        from patrol_tpu.analysis import abi as jabi

        rng = np.random.default_rng(seed)
        names = [b"a", b"b", b"zz"]
        bound = {b"a": 0, b"b": 1}
        for _ in range(40):
            n = int(rng.integers(1, 9))
            forms = [abi._FORMS[i] for i in rng.integers(0, len(abi._FORMS), n)]
            fields = dict(
                names=[names[i] for i in rng.integers(0, 3, n)],
                slots=[int(s) for s in rng.integers(-1, 3, n)],
                added=[abi._F_VALS[i] for i in rng.integers(0, len(abi._F_VALS), n)],
                taken=[abi._T_VALS[i] for i in rng.integers(0, len(abi._T_VALS), n)],
                elapsed=[abi._E_VALS[i] for i in rng.integers(0, len(abi._E_VALS), n)],
                caps=[f[0] for f in forms], lane_a=[f[1] for f in forms],
                lane_t=[f[2] for f in forms], no_trailer=[f[3] for f in forms],
            )
            lens = [len(x) if rng.random() > 0.1 else -1 for x in fields["names"]]
            tb = abi._ClassifyBatch(lens=lens, **fields)
            jb = jabi._ClassifyBatch(lens=lens, **fields)
            side = [np.zeros(8, np.int64), np.zeros(8, np.int32), np.zeros(8, np.int64)]
            side[0][1] = 5 * NANO
            jside = [a.copy() for a in side]
            got = abi._reference_classify(bound, *side, tb, 2, 99)
            want = jabi._reference_classify(bound, *jside, jb, 2, 99)
            for g, w in zip(got, want):
                assert np.array_equal(g, w)
            for g, w in zip(side, jside):
                assert np.array_equal(g, w)


# --- PTA001: classify conformance ------------------------------------------


class TestClassifyConformance:
    def test_shipped_classify_is_silent(self, lib):
        assert (
            abi.check_classify_conformance(OBS["classify_conformance"], lib)
            == []
        )

    def test_reference_mutation_is_rejected(self, lib, monkeypatch):
        """Same shape as the fold mutation: a perturbed reference
        classify (sanitize off by one nanotoken) must trip PTA001."""
        orig = abi._reference_classify

        def skewed(*args, **kw):
            rows, out_a, out_t, out_e, out_s = orig(*args, **kw)
            out_a = out_a + (rows >= 0)  # off-by-one on surviving entries
            return rows, out_a, out_t, out_e, out_s

        monkeypatch.setattr(abi, "_reference_classify", skewed)
        f = abi.check_classify_conformance(OBS["classify_conformance"], lib)
        assert "PTA001" in codes(f)

    def test_folded_duplicates_release_their_pin(self, lib):
        """The -4 dedup contract, driven raw: duplicates of one
        (row, slot, code) key leave exactly ONE pin on the row."""
        with abi._DirHarness(lib, [b"a"]) as d:
            b = abi._ClassifyBatch(
                names=[b"a"] * 3, lens=[1] * 3, slots=[0] * 3,
                added=[1.0, 5.0, 3.0], taken=[2.0, 0.0, 9.0],
                elapsed=[1, 2, 3], caps=[-1] * 3, lane_a=[-1] * 3,
                lane_t=[-1] * 3, no_trailer=[0] * 3,
            )
            rows, out_a, out_t, out_e, _ = abi._native_classify(
                lib, d, b, 2, now=5
            )
            assert rows.tolist() == [0, -4, -4]
            assert int(d.pins[0]) == 1
            # The survivor carries the elementwise max of the fold.
            assert (out_a[0], out_t[0], out_e[0]) == (5 * NANO, 9 * NANO, 3)


# --- PTA002/PTA003: merge laws on the native side ---------------------------


class TestNativeMergeLaws:
    def test_fold_order_and_duplication_freedom(self, lib):
        kw = dict(nodes=2, row_dense_min=2, max_distinct=8, cap_dense=8)
        batch = np.array(
            [[0, 0, 3, 1, 2], [1, 1, 1, 3, 0], [0, 0, 1, 2, 3], [1, 0, 2, 2, 1]],
            np.int64,
        )
        base = abi._fold_of(lib, batch, **kw)
        assert abi._fold_outputs_equal(
            base, abi._fold_of(lib, batch[::-1].copy(), **kw)
        )
        assert abi._fold_outputs_equal(
            base, abi._fold_of(lib, np.concatenate([batch, batch]), **kw)
        )

    def test_classify_agg_is_order_free(self, lib):
        with abi._DirHarness(lib, [b"a", b"b"]) as d:
            b = abi._ClassifyBatch(
                names=[b"a", b"b", b"a", b"b"], lens=[1] * 4,
                slots=[0, 1, 0, 1], added=[3.0, 1.0, 7.0, 2.0],
                taken=[1.0, 0.0, 0.5, 4.0], elapsed=[4, 3, 2, 1],
                caps=[-1] * 4, lane_a=[-1] * 4, lane_t=[-1] * 4,
                no_trailer=[0] * 4,
            )
            a1 = abi._classify_agg(abi._native_classify(lib, d, b, 2, 9), b)
            d.pins[:] = 0
            rev = b.subset([3, 2, 1, 0])
            a2 = abi._classify_agg(
                abi._native_classify(lib, d, rev, 2, 9), rev
            )
            assert a1 == a2


# --- PTA004: the schedule explorer ------------------------------------------


class TestScheduleExplorer:
    def test_builtin_scenarios_are_silent(self, lib):
        assert (
            abi.check_hls_interleavings(OBS["hls_interleavings"], lib) == []
        )

    def test_illegal_unlock_ordering_is_rejected(self, lib):
        """The ISSUE's injected defect: an unlock before the lock — the
        effects table (requires_host_mu on pt_hls_unlock) makes it a
        lock-protocol finding, not undefined behavior."""
        bad = abi.HlsScenario(
            name="bad-unlock",
            names=(b"k0",),
            cap_base=(2 * NANO,),
            scripts=(
                (abi.HlsOp("unlock"), abi.HlsOp("lock")),
                (abi.HlsOp("probe", name=b"k0", freq=3, per_ns=NANO),),
            ),
        )
        f = abi.explore_scenario(bad, lib)
        assert codes(f) == ["PTA004"]
        assert any("lock-protocol violation" in x.message for x in f)

    def test_locked_op_without_lock_is_rejected(self, lib):
        bad = abi.HlsScenario(
            name="bad-drain",
            names=(b"k0",),
            cap_base=(NANO,),
            scripts=((abi.HlsOp("drain"),),),
        )
        f = abi.explore_scenario(bad, lib)
        assert codes(f) == ["PTA004"]

    def test_leaked_lock_is_rejected(self, lib):
        bad = abi.HlsScenario(
            name="bad-leak",
            names=(b"k0",),
            cap_base=(NANO,),
            scripts=((abi.HlsOp("lock"), abi.HlsOp("drain")),),
        )
        f = abi.explore_scenario(bad, lib)
        assert any("leaked lock" in x.message for x in f)

    def test_self_deadlock_is_rejected(self, lib):
        bad = abi.HlsScenario(
            name="bad-reacquire",
            names=(b"k0",),
            cap_base=(NANO,),
            scripts=(
                (
                    abi.HlsOp("lock"),
                    abi.HlsOp("probe", name=b"k0", freq=1, per_ns=NANO),
                ),
            ),
        )
        f = abi.explore_scenario(bad, lib)
        assert any("self-deadlock" in x.message for x in f)

    def test_model_differential_is_live(self, lib, monkeypatch):
        """A lying model (off-by-one remaining) must produce findings in
        every scenario that probes — the differential is doing work."""
        orig = abi._HlsModel.probe

        def lying(self, op, now):
            rc, rem = orig(self, op, now)
            return rc, (rem + 1 if rc == 1 and rem is not None else rem)

        monkeypatch.setattr(abi._HlsModel, "probe", lying)
        f = abi.explore_scenario(abi.builtin_scenarios()[0], lib)
        assert codes(f) == ["PTA004"]
        assert any("diverges from the model" in x.message for x in f)

    def test_blocked_callers_defer_instead_of_interleaving(self, lib):
        """While a caller holds the store mutex, takes_host_mu ops of the
        others must not be scheduled — the lock/drain/unlock triple is
        atomic against probes in every enumerated schedule."""
        sc = abi.builtin_scenarios()[0]
        schedules, violations = abi._enumerate_schedules(
            sc, NATIVE_EFFECTS, 4096
        )
        assert violations == set()
        assert len(schedules) == 30  # 6 probe orders × 5 block positions
        for schedule in schedules:
            kinds = [op.kind for _, op in schedule]
            i = kinds.index("lock")
            assert kinds[i : i + 3] == ["lock", "drain", "unlock"]

    def test_token_conservation_post_invariant(self, lib):
        """The explicit native-bytes invariant: a 3-token bucket admits
        exactly 3 of 4 zero-refill-window takes in EVERY schedule."""
        f = abi.explore_scenario(abi.builtin_scenarios()[0], lib)
        assert f == []


# --- PTA005: effects-table completeness -------------------------------------


class TestRxRingSchedules:
    """PTA004 on the zero-copy rx ring (device-resident ingest): every
    lease/commit-vs-pump interleaving matches the lowest-free-first
    model on the shipped library, and seeded ownership bugs — a lease
    policy that hands out the wrong plane, a commit that accepts
    double-commits — are demonstrably rejected."""

    def test_shipped_ring_is_silent(self, lib):
        assert abi.check_rxring_interleavings(
            OBS["rxring_interleavings"], lib
        ) == []

    def test_registered_with_pta004(self):
        ob = OBS["rxring_interleavings"]
        assert ob.codes == ("PTA004",)
        assert ob.symbol == "pt_rx_ring_lease"

    class _Shim:
        """Delegating facade over the real lib for seeded mutations."""

        def __init__(self, lib):
            self._lib = lib

        def __getattr__(self, name):
            return getattr(self._lib, name)

    def test_seeded_wrong_lease_policy_rejected(self, lib):
        """A lease that returns the HIGHEST free plane instead of the
        lowest — plausible after a free-list refactor — diverges from
        the model and must fire PTA004."""
        shim = self._Shim(lib)

        def high_lease(h):
            a = lib.pt_rx_ring_lease(h)
            b = lib.pt_rx_ring_lease(h)
            if b < 0:
                return a
            lib.pt_rx_ring_commit(h, a)
            return b

        shim.pt_rx_ring_lease = high_lease
        f = abi.check_rxring_interleavings(OBS["rxring_interleavings"], shim)
        assert codes(f) == ["PTA004"]
        assert "lease" in f[0].message

    def test_seeded_double_commit_acceptance_rejected(self, lib):
        """A commit that silently accepts an un-leased plane (the
        use-after-recycle door) must fire PTA004 via the refusal probe."""
        shim = self._Shim(lib)

        def lax_commit(h, plane):
            rc = lib.pt_rx_ring_commit(h, plane)
            return 0 if rc == -22 else rc  # swallow EINVAL

        shim.pt_rx_ring_commit = lax_commit
        f = abi.check_rxring_interleavings(OBS["rxring_interleavings"], shim)
        assert codes(f) == ["PTA004"]

    def test_deferred_destroy_protects_leased_planes(self, lib):
        """destroy while a plane is leased must NOT free it: the handle
        refuses new leases, the outstanding commit still lands, and only
        then does the ring free (exercised via a fresh handle reusing
        the slot table without crashing)."""
        h = lib.pt_rx_ring_create(2, 4, 256)
        assert h >= 0
        plane = lib.pt_rx_ring_lease(h)
        assert plane >= 0
        ptr = lib.pt_rx_ring_plane(h, plane)
        assert ptr != 0
        assert lib.pt_rx_ring_destroy(h) == 0  # deferred
        assert lib.pt_rx_ring_lease(h) < 0  # closing: no new leases
        # The leased plane's memory is still live — write through the view.
        import ctypes

        buf = (ctypes.c_uint8 * 16).from_address(ptr)
        buf[0] = 0x5A
        assert lib.pt_rx_ring_commit(h, plane) == 0  # last commit frees


class TestEffectsTable:
    def test_table_is_complete_both_ways(self):
        assert abi.check_effects_table(OBS["effects_table"]) == []

    def test_table_covers_every_export_of_the_built_library(self, lib):
        """The effects table against the library's dynamic symbol table
        (``nm -D``): every exported ``pt_*`` function has an entry, and
        the source scan the stage uses finds exactly those exports."""
        import shutil
        import subprocess

        if shutil.which("nm") is None:
            pytest.skip("nm (binutils) is not installed: cannot read the export list")
        out = subprocess.run(
            ["nm", "-D", "--defined-only", str(native.lib_path())],
            capture_output=True, text=True, check=True,
        ).stdout
        exported = {ln.split()[-1] for ln in out.splitlines()
                    if ln.split() and ln.split()[-1].startswith("pt_")}
        assert len(exported) >= 40
        assert exported == set(NATIVE_EFFECTS)
        assert exported == set(abi.cpp_exports())

    def test_unregistered_export_is_rejected(self, tmp_path, monkeypatch):
        """A new C ABI function in the sources, neither bound nor given
        effects, is a PTA005 anchored at its definition."""
        import shutil

        native_dir = tmp_path / "patrol_tpu_torch" / "native"
        native_dir.mkdir(parents=True)
        for name in ("patrol_host.cpp", "patrol_http.cpp", "__init__.py"):
            shutil.copy(os.path.join(REPO_ROOT, "patrol_tpu_torch", "native", name), native_dir)
        host = native_dir / "patrol_host.cpp"
        text = host.read_text()
        host.write_text(text + "\nextern \"C\" {\nint pt_new_export(int x) { return x; }\n}\n")
        monkeypatch.setattr(abi, "_REPO_ROOT", str(tmp_path))
        f = abi.check_effects_table(OBS["effects_table"])
        assert [(x.check, x.path, x.line) for x in f] == [
            ("PTA005", "patrol_tpu_torch/native/patrol_host.cpp", text.count("\n") + 3)
        ]
        assert "pt_new_export" in f[0].message

    def test_missing_entry_is_rejected(self, monkeypatch):
        import patrol_tpu_torch.native as native_mod

        trimmed = dict(NATIVE_EFFECTS)
        trimmed.pop("pt_http_poll")
        monkeypatch.setattr(native_mod, "NATIVE_EFFECTS", trimmed)
        f = abi.check_effects_table(OBS["effects_table"])
        assert codes(f) == ["PTA005"]
        assert any("pt_http_poll" in x.message for x in f)

    def test_stale_entry_is_rejected(self, monkeypatch):
        import patrol_tpu_torch.native as native_mod

        bloated = dict(NATIVE_EFFECTS)
        bloated["pt_made_up"] = native_mod.NativeEffect(
            False, False, False, True
        )
        monkeypatch.setattr(native_mod, "NATIVE_EFFECTS", bloated)
        f = abi.check_effects_table(OBS["effects_table"])
        assert codes(f) == ["PTA005"]
        assert any("stale" in x.message for x in f)

    def test_locked_family_declares_the_protocol(self):
        """The explorer's legality rules lean on these exact bits."""
        for sym in (
            "pt_hls_host_locked", "pt_hls_unhost_locked",
            "pt_hls_drain_locked", "pt_hls_unlock",
        ):
            assert NATIVE_EFFECTS[sym].requires_host_mu, sym
        for sym in ("pt_hls_lock", "pt_hls_stats", "pt_hls_take_probe"):
            assert NATIVE_EFFECTS[sym].takes_host_mu, sym
        assert NATIVE_EFFECTS["pt_http_poll"].blocks
        assert not NATIVE_EFFECTS["pt_hls_events"].takes_host_mu


# --- suppression + drivers ---------------------------------------------------


class TestSuppressionAndDrivers:
    def test_pta_codes_ride_the_lint_directive(self):
        from patrol_tpu_torch.analysis.lint import Module

        mod = Module(
            "patrol_tpu_torch/ops/x.py",
            "a = 1  # patrol-lint: disable=PTA001,PTA004\n",
        )
        assert mod.suppressed("PTA001", 1)
        assert mod.suppressed("PTA004", 1)
        assert not mod.suppressed("PTA002", 1)

    def test_abi_repo_filters_suppressed_findings(self, tmp_path, monkeypatch):
        from patrol_tpu_torch.analysis.lint import Finding

        src = tmp_path / "patrol_tpu_torch" / "ops"
        src.mkdir(parents=True)
        (src / "fake.py").write_text(
            "x = 1\ny = 2  # patrol-lint: disable=PTA001\n"
        )
        crafted = [
            Finding("PTA001", "patrol_tpu_torch/ops/fake.py", 1, "kept"),
            Finding("PTA001", "patrol_tpu_torch/ops/fake.py", 2, "suppressed"),
        ]
        monkeypatch.setattr(abi, "abi_all", lambda only=None, device="cpu": crafted)
        out = abi.abi_repo(str(tmp_path))
        assert [f.line for f in out] == [1]

    def test_stale_pta_suppression_is_reported(self, tmp_path, monkeypatch):
        """A PTA directive that suppressed nothing comes back as PTL006."""
        src = tmp_path / "patrol_tpu_torch" / "ops"
        src.mkdir(parents=True)
        (src / "fake.py").write_text("x = 1  # patrol-lint: disable=PTA003\n")
        monkeypatch.setattr(abi, "abi_all", lambda only=None, device="cpu": [])
        out = abi.abi_repo(str(tmp_path))
        assert [(f.check, f.path, f.line) for f in out] == [
            ("PTL006", "patrol_tpu_torch/ops/fake.py", 1)
        ]

    def test_cpp_findings_cannot_be_suppressed(self):
        """apply_suppressions must keep findings anchored in .cpp sources
        (no python directive table exists there to honor)."""
        from patrol_tpu_torch.analysis.lint import Finding, apply_suppressions

        f = [Finding("PTA001", "patrol_tpu_torch/native/patrol_host.cpp", 1, "x")]
        assert apply_suppressions(f, REPO_ROOT) == f


class TestRepoAbiClean:
    def test_repo_abi_proves_clean(self):
        """The stage-5 contract: zero findings, zero suppressions, on the
        shipped tree."""
        findings = abi.abi_repo(REPO_ROOT)
        assert findings == [], "\n".join(str(f) for f in findings)

    def test_registry_covers_the_native_joins(self):
        names = {ob.name for ob in ABI_OBLIGATIONS}
        for required in (
            "native.pt_fold_hybrid",
            "native.pt_rx_classify",
            "native.hls_schedules",
            "native.effects_table",
        ):
            assert required in names, required

    def test_every_code_is_declared_somewhere(self):
        declared = set()
        for ob in ABI_OBLIGATIONS:
            declared.update(ob.codes)
        assert declared == set(abi.ALL_CODES)

    def test_fold_twins_resolve_through_kernel_roots(self):
        import patrol_tpu_torch.ops.merge as merge_mod

        ob = OBS["fold_conformance"]
        twins = abi._resolve_twins(ob)
        assert set(twins) == set(ob.twins)
        assert twins["ops.merge.merge_batch"] is merge_mod.merge_batch
        assert twins["ops.merge.merge_batch_folded"] is merge_mod.merge_batch_folded
        assert twins["ops.merge.merge_rows_dense"] is merge_mod.merge_rows_dense

    def test_every_kernel_root_resolves(self):
        import importlib

        from patrol_tpu_torch.ops.obligations import KERNEL_FAMILIES, KERNEL_ROOTS

        for name, (module, func) in KERNEL_ROOTS.items():
            assert module.startswith("patrol_tpu_torch."), name
            assert callable(getattr(importlib.import_module(module), func)), name
        for fam in KERNEL_FAMILIES:
            for ob in fam.abi:
                assert set(ob.twins) <= set(KERNEL_ROOTS), ob.name
            assert fam.wire_codec is None or fam.wire_codec in KERNEL_ROOTS
            for key in fam.absent:
                assert key.rsplit(":", 1)[0] in fam.roots, key

    def test_registry_matches_the_reference_s(self):
        from patrol_tpu.ops.obligations import ABI_OBLIGATIONS as REF

        def view(obs):
            return [(o.name, o.symbol, o.codes, o.check, o.twins) for o in obs]

        assert view(ABI_OBLIGATIONS) == view(REF)
