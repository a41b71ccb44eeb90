"""The port's cert stage (``patrol_tpu_torch/analysis/cert.py`` and
``patrol_tpu_torch/scripts/cert_repo.py``, stage 9, ``pytest -m cert``)
against the JAX package's, on the CPU.

* **Every case of ``tests/test_cert.py``, on the port.** The real-repo
  gate (the live ``KERNEL_FAMILIES`` registry passes every meta-check and
  one seeded prove mutant is executed end to end, here with
  ``device="cpu"``), and for each PTK code a synthetic family that should
  fire it does while the minimally-correct variant stays silent. The
  bench-field cases read ``chip_smoke.py``, the port's end-to-end run on
  the card; the PTK004 cases read the port's kernel launchers (the
  ``count_launch`` callers under ``patrol_tpu_torch/ops/``).
* **Against the reference.** Both registries carry the same families and
  the same mutations (name, stage, expect), and the same tampering
  applied to a copy of each registry draws the same findings (code and
  message) from both stages: a dropped protocol hook, a tampered expect
  (executed), a blank ``absent`` reason, a duplicate root, a stale
  justification.
* **The port's own.** Every ``bench_fields`` key is a quoted literal in
  ``chip_smoke.py``; each ``LAUNCHES`` key resolves to its launcher; a
  ``count_launch`` caller no root reaches, and a key no caller passes,
  fire PTK004.
* **The driver.** ``cert_repo``'s clean line (the reference's, word for
  word), ``--list``, ``--mutation`` for each of the 22 mutations, its
  exit codes, and ``--device`` defaulting to the card.

Exact comparisons only (codes, messages, exit statuses): tolerance zero.
"""

import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import pytest

from patrol_tpu.analysis import cert as jcert
from patrol_tpu.ops import obligations as job
from patrol_tpu_torch.analysis import cert
from patrol_tpu_torch.analysis.lint import repo_sources
from patrol_tpu_torch.analysis.prove import CallGraph, ProveRoot
from patrol_tpu_torch.ops import _build
from patrol_tpu_torch.ops import obligations as ob
from patrol_tpu_torch.scripts import cert_repo

pytestmark = pytest.mark.cert

REPO = Path(__file__).resolve().parent.parent
FAMS = {f.name: f for f in ob.KERNEL_FAMILIES}
JFAMS = {f.name: f for f in job.KERNEL_FAMILIES}
MUTS = [m for f in ob.KERNEL_FAMILIES for m in f.mutations]
CLEAN_LINE = ("patrol-cert: clean (8 families, 18 seeded mutations executed + 4 stage-8 "
              "references pinned, all rejected with their exact codes)")


def _codes(findings):
    return sorted(f.check for f in findings)


def _messages(findings):
    return "\n".join(str(f) for f in findings)


def _said(findings):
    """What a finding says, less its anchor (each package's own file)."""
    return sorted((f.check, f.message) for f in findings)


def _root(**kw):
    """A synthetic prove root; defaults declare every PTP code so the
    absence checker has nothing to say unless a test removes one."""
    base = dict(
        name="fixture.ops.kernel",
        module="patrol_tpu_torch.ops.merge",
        attr="merge_batch",
        obligations=("PTP001", "PTP002", "PTP003", "PTP004", "PTP005"),
        structural=None,
        model=None,
    )
    base.update(kw)
    return ProveRoot(**base)


def _fam(**kw):
    """A synthetic family that passes every check unless a test breaks
    one field: a fully-declared root, exemptions everywhere else."""
    base = dict(
        name="fixture-family",
        domain="fixture lattice for checker self-tests",
        prove_roots=(_root(),),
        protocol_exempt="fixture: no replication plane",
        lin_exempt="fixture: no linearizable surface",
        bench_exempt="fixture: no smoke leg",
        mutations_exempt="fixture: checker self-test record",
    )
    base.update(kw)
    return ob.KernelFamily(**base)


# ---------------------------------------------------------------------------
# Real-repo gate.


class TestRepoGate:
    def test_registry_is_clean_without_execution(self):
        findings = cert.check_repo(execute_mutations=False)
        assert not findings, _messages(findings)

    def test_cert_kit_families_are_fully_registered(self):
        for name, algebra in (
            ("gcra", "gcra"),
            ("concurrency", "conc"),
            ("hierquota", "quota"),
        ):
            fam = FAMS[name]
            assert fam.prove_roots, name
            assert fam.protocol, name
            assert fam.wire_codec in {r.name for r in fam.prove_roots}
            assert fam.bench_fields, name
            assert len(fam.mutations) >= 2, name
            assert {s.algebra for s in fam.lin_specs} == {algebra}

    def test_derived_registries_aggregate_the_families(self):
        fam_roots = [r for f in ob.KERNEL_FAMILIES for r in f.prove_roots]
        assert tuple(fam_roots) == ob.PROVE_ROOTS
        fam_specs = [s for f in ob.KERNEL_FAMILIES for s in f.lin_specs]
        assert tuple(fam_specs) == ob.LIN_SPECS
        names = [r.name for r in ob.PROVE_ROOTS]
        assert len(names) == len(set(names))

    def test_seeded_gcra_mutant_is_rejected_live(self):
        """One end-to-end execution: the seeded off-by-one window mutant
        must be rejected with exactly its registered code."""
        fam = FAMS["gcra"]
        mut = next(m for m in fam.mutations if m.stage == "prove")
        only = dataclasses.replace(fam, mutations=(mut,))
        findings = cert.check_mutations(families=[only], execute=True, device="cpu")
        assert not findings, _messages(findings)

    def test_tampered_expect_code_is_caught_on_execution(self):
        """The same mutant with a WRONG pinned code must be a PTK002
        finding — the 'gone soft' detector works both ways."""
        fam = FAMS["gcra"]
        mut = next(m for m in fam.mutations if m.stage == "prove")
        bad = dataclasses.replace(
            fam, mutations=(dataclasses.replace(mut, expect="PTP004"),)
        )
        findings = cert.check_mutations(families=[bad], execute=True, device="cpu")
        hits = [f for f in findings if "gone soft" in f.message]
        assert hits and _codes(hits) == ["PTK002"]


# ---------------------------------------------------------------------------
# PTK001 — stage reachability, both ways.


class TestReachability:
    def test_fully_exempt_family_is_clean(self):
        assert cert.check_reachability(families=[_fam()]) == []

    def test_no_prove_roots_fires(self):
        findings = cert.check_reachability(families=[_fam(prove_roots=())])
        assert "PTK001" in _codes(findings)
        assert "never reaches stage 4" in _messages(findings)

    def test_undispatchable_model_tag_fires(self):
        fam = _fam(prove_roots=(_root(model="no-such-model"),))
        findings = cert.check_reachability(families=[fam])
        assert _codes(findings) == ["PTK001"]
        assert "cannot dispatch" in _messages(findings)

    def test_undispatchable_join_batch_suffix_fires(self):
        fam = _fam(prove_roots=(_root(model="join_batch:no-such"),))
        assert _codes(cert.check_reachability(families=[fam])) == ["PTK001"]

    def test_known_join_batch_suffix_is_clean(self):
        fam = _fam(prove_roots=(_root(model="join_batch:merge_batch"),))
        assert cert.check_reachability(families=[fam]) == []

    def test_missing_protocol_hook_without_exemption_fires(self):
        fam = _fam(protocol_exempt="")
        findings = cert.check_reachability(families=[fam])
        assert _codes(findings) == ["PTK001"]
        assert "stage 6 never sees" in _messages(findings)

    def test_unknown_protocol_key_fires(self):
        fam = _fam(protocol="no-such-hook")
        findings = cert.check_reachability(families=[fam])
        assert _codes(findings) == ["PTK001"]
        assert "FAMILY_CHECKS" in _messages(findings)

    def test_missing_lin_spec_without_exemption_fires(self):
        fam = _fam(lin_exempt="")
        findings = cert.check_reachability(families=[fam])
        assert _codes(findings) == ["PTK001"]
        assert "stage 8" in _messages(findings)

    def test_unknown_lin_algebra_fires(self):
        spec = FAMS["gcra"].lin_specs[0]
        fam = _fam(
            lin_specs=(dataclasses.replace(spec, algebra="no-such"),),
            lin_exempt="",
        )
        assert _codes(cert.check_reachability(families=[fam])) == ["PTK001"]

    def test_missing_bench_field_without_exemption_fires(self):
        fam = _fam(bench_exempt="")
        findings = cert.check_reachability(families=[fam])
        assert _codes(findings) == ["PTK001"]
        assert "smoke gate" in _messages(findings)

    def test_bench_field_not_emitted_by_chip_smoke_fires(self):
        fam = _fam(bench_fields=("no_such_smoke_field",), bench_exempt="")
        findings = cert.check_reachability(families=[fam])
        assert _codes(findings) == ["PTK001"]
        assert "not" in _messages(findings) and "chip_smoke.py" in _messages(findings)

    def test_emitted_bench_field_is_clean(self):
        fam = _fam(bench_fields=("cert_gcra_admitted",), bench_exempt="")
        assert cert.check_reachability(families=[fam]) == []


# ---------------------------------------------------------------------------
# PTK002 — mutation registration, both ways (no execution needed).


class TestMutationRegistration:
    def test_prove_mutation_with_unknown_root_fires(self):
        fam = _fam(
            mutations=(
                ob.CertMutation(
                    name="fixture-unknown-root",
                    stage="prove",
                    target="no.such.root",
                    expect="PTP002",
                    mutant=lambda *a: None,
                ),
            ),
            mutations_exempt="",
        )
        findings = cert.check_mutations(families=[fam], execute=False)
        assert _codes(findings) == ["PTK002"]
        assert "unknown prove root" in _messages(findings)

    def test_prove_mutation_without_mutant_fires(self):
        fam = _fam(
            mutations=(
                ob.CertMutation(
                    name="fixture-no-mutant",
                    stage="prove",
                    target="fixture.ops.kernel",
                    expect="PTP002",
                ),
            ),
        )
        findings = cert.check_mutations(families=[fam], execute=False)
        assert _codes(findings) == ["PTK002"]
        assert "no mutant kernel" in _messages(findings)

    def test_law_mutation_targeting_foreign_hook_fires(self):
        gcra = FAMS["gcra"]
        law_mut = next(m for m in gcra.mutations if m.laws is not None)
        fam = dataclasses.replace(gcra, protocol="bucket-full", mutations=(law_mut,))
        findings = cert.check_mutations(families=[fam], execute=False)
        assert _codes(findings) == ["PTK002"]
        assert "not the family's own protocol hook" in _messages(findings)

    def test_registry_reference_to_unknown_semantics_fires(self):
        fam = _fam(
            mutations=(
                ob.CertMutation(
                    name="fixture-unknown-sem",
                    stage="protocol",
                    target="no-such-registered-mutation",
                    expect="PTC001",
                ),
            ),
        )
        findings = cert.check_mutations(families=[fam], execute=False)
        assert _codes(findings) == ["PTK002"]
        assert "protocol.MUTATIONS" in _messages(findings)

    def test_lin_reference_to_unknown_mutation_fires(self):
        fam = _fam(
            mutations=(
                ob.CertMutation(
                    name="fixture-unknown-lin",
                    stage="lin",
                    target="no-such-lin-mutation",
                    expect="PTN001",
                ),
            ),
        )
        findings = cert.check_mutations(families=[fam], execute=False)
        assert _codes(findings) == ["PTK002"]
        assert "LIN_MUTATIONS" in _messages(findings)

    def test_lin_expect_disagreement_fires(self):
        """Stage 8 registers PTN004 for the gc mutation — a family that
        pins any other code is a registry split-brain finding."""
        fam = _fam(
            lin_specs=FAMS["lifecycle"].lin_specs,
            lin_exempt="",
            mutations=(
                ob.CertMutation(
                    name="fixture-wrong-lin-code",
                    stage="lin",
                    target="gc-forgets-visible-admits",
                    expect="PTN001",
                ),
            ),
        )
        findings = cert.check_mutations(families=[fam], execute=False)
        assert "PTK002" in _codes(findings)
        assert "registries disagree" in _messages(findings)

    def test_lin_mutation_against_unregistered_spec_fires(self):
        """A family may only claim lin mutations that run against a
        spec it actually registers."""
        fam = _fam(
            mutations=(
                ob.CertMutation(
                    name="fixture-foreign-spec",
                    stage="lin",
                    target="gc-forgets-visible-admits",
                    expect="PTN004",
                ),
            ),
        )
        findings = cert.check_mutations(families=[fam], execute=False)
        assert _codes(findings) == ["PTK002"]
        assert "does not register" in _messages(findings)


# ---------------------------------------------------------------------------
# PTK003 — absence justifications, both ways.


class TestAbsenceJustifications:
    def test_fully_declared_root_needs_no_justification(self):
        assert cert.check_absent_justifications(families=[_fam()]) == []

    def test_unjustified_absence_fires_per_missing_code(self):
        root = _root(obligations=("PTP001", "PTP004", "PTP005"))
        fam = _fam(prove_roots=(root,))
        findings = cert.check_absent_justifications(families=[fam])
        assert _codes(findings) == ["PTK003", "PTK003"]
        msgs = _messages(findings)
        assert "PTP002" in msgs and "PTP003" in msgs
        assert "silence is not a design decision" in msgs

    def test_written_justification_silences_the_absence(self):
        root = _root(obligations=("PTP001", "PTP004", "PTP005"))
        fam = _fam(
            prove_roots=(root,),
            absent={
                "fixture.ops.kernel:PTP002": "host-side scalar path",
                "fixture.ops.kernel:PTP003": "no wire surface",
            },
        )
        assert cert.check_absent_justifications(families=[fam]) == []

    def test_blank_justification_is_not_a_justification(self):
        root = _root(obligations=("PTP001", "PTP002", "PTP003", "PTP004"))
        fam = _fam(prove_roots=(root,), absent={"fixture.ops.kernel:PTP005": "   "})
        findings = cert.check_absent_justifications(families=[fam])
        assert _codes(findings) == ["PTK003"]

    def test_stale_justification_for_declared_code_fires(self):
        fam = _fam(absent={"fixture.ops.kernel:PTP003": "was absent once"})
        findings = cert.check_absent_justifications(families=[fam])
        assert _codes(findings) == ["PTK003"]
        assert "stale" in _messages(findings)

    def test_justification_for_unknown_root_fires(self):
        fam = _fam(absent={"no.such.root:PTP003": "orphaned entry"})
        findings = cert.check_absent_justifications(families=[fam])
        assert _codes(findings) == ["PTK003"]
        assert "does not register" in _messages(findings)


# ---------------------------------------------------------------------------
# PTK004 — the ops/ kernel-launcher sweep, both ways.


class TestUnregisteredKernels:
    def test_every_kernel_launcher_is_registered(self):
        findings = cert.check_unregistered_kernels()
        assert not findings, _messages(findings)

    def test_deregistering_a_kernel_is_caught(self, monkeypatch):
        # lifecycle_probe is the one root that reaches the lifecycle
        # kernel's launcher.
        pruned = tuple(r for r in ob.PROVE_ROOTS if r.attr != "lifecycle_probe")
        monkeypatch.setattr(ob, "PROVE_ROOTS", pruned)
        findings = cert.check_unregistered_kernels()
        assert _codes(findings) == ["PTK004"]
        assert "patrol_tpu_torch.ops.lifecycle_kernel.probe" in _messages(findings)
        assert "cannot land uncertified" in _messages(findings)


# ---------------------------------------------------------------------------
# PTK005 — registry integrity, both ways.


class TestRegistryIntegrity:
    def test_wellformed_family_is_clean(self):
        assert cert.check_registry_integrity(families=[_fam()]) == []

    def test_duplicate_family_name_fires(self):
        findings = cert.check_registry_integrity(families=[_fam(), _fam()])
        assert "PTK005" in _codes(findings)
        assert "duplicate family name" in _messages(findings)

    def test_empty_domain_fires(self):
        findings = cert.check_registry_integrity(families=[_fam(domain=" ")])
        assert _codes(findings) == ["PTK005"]
        assert "empty domain" in _messages(findings)

    def test_root_claimed_by_two_families_fires(self):
        findings = cert.check_registry_integrity(
            families=[_fam(name="fixture-a"), _fam(name="fixture-b")]
        )
        assert _codes(findings) == ["PTK005"]
        assert "also" in _messages(findings)

    def test_single_mutation_without_exemption_fires(self):
        fam = _fam(
            mutations=(
                ob.CertMutation(
                    name="fixture-lonely",
                    stage="lin",
                    target="gc-forgets-visible-admits",
                    expect="PTN004",
                ),
            ),
            mutations_exempt="",
        )
        findings = cert.check_registry_integrity(families=[fam])
        assert _codes(findings) == ["PTK005"]
        assert ">= 2" in _messages(findings)

    def test_unknown_stage_fires(self):
        fam = _fam(
            mutations=(
                ob.CertMutation(name="fixture-bad-stage", stage="bench", target="x",
                                expect="PTK001"),
                ob.CertMutation(name="fixture-bad-stage-2", stage="race", target="x",
                                expect="PTK001"),
            ),
        )
        findings = cert.check_registry_integrity(families=[fam])
        assert _codes(findings) == ["PTK005", "PTK005"]
        assert "unknown stage" in _messages(findings)

    def test_malformed_expect_code_fires(self):
        fam = _fam(
            mutations=(
                ob.CertMutation(name="fixture-bad-code", stage="lin", target="x",
                                expect="PTX01"),
                ob.CertMutation(name="fixture-bad-code-2", stage="lin", target="x",
                                expect="not-a-code"),
            ),
        )
        findings = cert.check_registry_integrity(families=[fam])
        assert _codes(findings) == ["PTK005", "PTK005"]
        assert "not a PT code" in _messages(findings)

    def test_wire_codec_must_name_a_family_root(self):
        fam = _fam(wire_codec="some.other.codec")
        findings = cert.check_registry_integrity(families=[fam])
        assert _codes(findings) == ["PTK005"]
        assert "ship uncertified" in _messages(findings)

    def test_wire_codec_naming_own_root_is_clean(self):
        fam = _fam(wire_codec="fixture.ops.kernel")
        assert cert.check_registry_integrity(families=[fam]) == []


# ---------------------------------------------------------------------------
# Against the reference: one registry shape, one verdict per tampering.


def _both(tamper, check):
    """``tamper(fams, obligations module)`` → a tampered family list for
    each package; → each stage's findings on it (anchors dropped)."""
    got = _said(check(cert, tamper(list(ob.KERNEL_FAMILIES), ob)))
    want = _said(check(jcert, tamper(list(job.KERNEL_FAMILIES), job)))
    return got, want


class TestAgainstTheReference:
    def test_same_families_and_mutations(self):
        assert list(FAMS) == list(JFAMS)
        assert [(m.name, m.stage, m.expect) for m in MUTS] == [
            (m.name, m.stage, m.expect) for f in job.KERNEL_FAMILIES for m in f.mutations
        ]
        for name, fam in FAMS.items():
            j = JFAMS[name]
            assert (fam.protocol, fam.wire_codec, bool(fam.bench_fields),
                    bool(fam.protocol_exempt), bool(fam.lin_exempt), bool(fam.mutations_exempt)
                    ) == (j.protocol, j.wire_codec, bool(j.bench_fields),
                          bool(j.protocol_exempt), bool(j.lin_exempt), bool(j.mutations_exempt))
            assert [s.name for s in fam.lin_specs] == [s.name for s in j.lin_specs]
            # The reference's roots are the port's (the port adds the mesh's
            # and the row RMW's to merge-join).
            assert {r.name: r.obligations for r in j.prove_roots}.items() <= {
                r.name: r.obligations for r in fam.prove_roots}.items()

    def test_both_registries_clean_without_execution(self):
        got, want = _both(lambda fams, _: fams, lambda c, fams: (
            c.check_registry_integrity(fams) + c.check_reachability(fams)
            + c.check_absent_justifications(fams) + c.check_mutations(fams, execute=False)))
        assert got == want == []

    @pytest.mark.parametrize("name", [n for n, f in FAMS.items() if f.protocol])
    def test_dropped_protocol_hook(self, name):
        def tamper(fams, _):
            return [dataclasses.replace(f, protocol=None, protocol_exempt="")
                    for f in fams if f.name == name]

        got, want = _both(tamper, lambda c, fams: c.check_reachability(fams))
        assert got == want and [c for c, _ in got] == ["PTK001"]

    @pytest.mark.parametrize("mut", MUTS, ids=[m.name for m in MUTS])
    def test_tampered_expect_executed(self, mut):
        wrong = {"prove": "PTP005", "protocol": "PTC005", "lin": "PTN005"}[mut.stage]

        def tamper(fams, _):
            fam = next(f for f in fams if any(m.name == mut.name for m in f.mutations))
            m = next(m for m in fam.mutations if m.name == mut.name)
            return [dataclasses.replace(fam, mutations=(dataclasses.replace(m, expect=wrong),))]

        got, want = _both(tamper, lambda c, fams: c.check_mutations(
            fams, execute=True, **({"device": "cpu"} if c is cert else {})))
        assert got == want and [c for c, _ in got] == ["PTK002"]

    @pytest.mark.parametrize("name", [n for n, f in FAMS.items() if f.absent])
    def test_blank_absent_reason(self, name):
        key = sorted(set(FAMS[name].absent) & set(JFAMS[name].absent))[0]

        def tamper(fams, _):
            fam = next(f for f in fams if f.name == name)
            return [dataclasses.replace(fam, absent={**fam.absent, key: "  "})]

        got, want = _both(tamper, lambda c, fams: c.check_absent_justifications(fams))
        assert got == want and [c for c, _ in got] == ["PTK003"]

    @pytest.mark.parametrize("name", list(FAMS))
    def test_duplicate_root(self, name):
        def tamper(fams, _):
            i = [f.name for f in fams].index(name)
            other = fams[(i + 1) % len(fams)]
            root = fams[i].prove_roots[0]
            fams[(i + 1) % len(fams)] = dataclasses.replace(
                other, prove_roots=other.prove_roots + (root,))
            return fams

        got, want = _both(tamper, lambda c, fams: c.check_registry_integrity(fams))
        assert got == want and [c for c, _ in got] == ["PTK005"]
        assert "is also claimed by family" in got[0][1]

    @pytest.mark.parametrize("name", list(FAMS))
    def test_stale_justification(self, name):
        root = JFAMS[name].prove_roots[0]
        key = f"{root.name}:{root.obligations[0]}"

        def tamper(fams, _):
            fam = next(f for f in fams if f.name == name)
            return [dataclasses.replace(fam, absent={**fam.absent, key: "was absent once"})]

        got, want = _both(tamper, lambda c, fams: c.check_absent_justifications(fams))
        assert got == want and [c for c, _ in got] == ["PTK003"]
        assert "stale" in got[0][1]


# ---------------------------------------------------------------------------
# The registry itself.


SMOKE = (REPO / "chip_smoke.py").read_text()


class TestRegistry:
    @pytest.mark.parametrize("field", sorted({k for f in FAMS.values() for k in f.bench_fields}))
    def test_bench_field_is_a_quoted_key_of_chip_smoke(self, field):
        assert re.search(rf'"{field}"\s*[:\]]', SMOKE), field

    def test_exempt_families_name_their_reason(self):
        for fam in FAMS.values():
            assert bool(fam.bench_fields) != bool(fam.bench_exempt.strip()), fam.name
        assert "chip_smoke.py" in FAMS["scalar-merge"].bench_exempt

    def test_each_launch_key_resolves_to_its_launcher(self):
        keys = cert.launch_keys_passed(CallGraph(repo_sources(str(REPO))))
        ops = "patrol_tpu_torch/ops/"
        assert keys == {
            "pair_join": {(ops + "join_kernel.py", "_launch")},
            "row_join": {(ops + "join_kernel.py", "_launch")},
            "tick_join": {(ops + "join_kernel.py", "_launch")},
            "take_n": {(ops + "take_kernel.py", "take_n")},
            "decode_fold": {(ops + "ingest_kernel.py", "decode_fold")},
            "row_rmw": {(ops + "row_rmw_kernel.py", "row_rmw")},
            "lifecycle_probe": {(ops + "lifecycle_kernel.py", "probe")},
            "gcra_admit": {(ops + "cert_kernel.py", "fused")},
            "conc_admit": {(ops + "cert_kernel.py", "fused")},
            "quota_admit": {(ops + "cert_kernel.py", "fused")},
            "mesh_gather": {(ops + "converge_kernel.py", "_launch")},
            "converge": {(ops + "converge_kernel.py", "_launch")},
        }

    def test_a_launcher_no_root_reaches_fires(self):
        srcs = repo_sources(str(REPO))
        srcs["patrol_tpu_torch/ops/fixture_kernel.py"] = (
            "from patrol_tpu_torch.ops import _build\n\n\n"
            "def launch(x):\n"
            "    _build.count_launch(\"take_n\")\n"
            "    return x\n"
        )
        findings = cert.check_unregistered_kernels(srcs)
        assert [(f.check, f.path, f.line) for f in findings] == [
            ("PTK004", "patrol_tpu_torch/ops/fixture_kernel.py", 5)]
        assert "'patrol_tpu_torch.ops.fixture_kernel.launch'" in findings[0].message

    def test_an_exempt_launcher_is_silent(self, monkeypatch):
        srcs = repo_sources(str(REPO))
        srcs["patrol_tpu_torch/ops/fixture_kernel.py"] = (
            "from patrol_tpu_torch.ops import _build\n\n\n"
            "def launch(x):\n"
            "    _build.count_launch(\"take_n\")\n"
        )
        monkeypatch.setattr(ob, "PROVE_EXEMPT", ob.PROVE_EXEMPT | {
            ("patrol_tpu_torch.ops.fixture_kernel", "launch")})
        assert cert.check_unregistered_kernels(srcs) == []

    def test_a_launch_key_no_launcher_passes_fires(self, monkeypatch):
        monkeypatch.setitem(_build.LAUNCHES, "ghost_kernel", 0)
        findings = cert.check_unregistered_kernels()
        assert [(f.check, f.path) for f in findings] == [
            ("PTK004", "patrol_tpu_torch/ops/_build.py")]
        assert "'ghost_kernel'" in findings[0].message


# ---------------------------------------------------------------------------
# The driver.


class TestCertRepo:
    def test_clean_run_prints_the_reference_s_line(self, capsys):
        assert cert_repo.main(["--device", "cpu"]) == 0
        out = capsys.readouterr().out.splitlines()
        assert out[-1] == CLEAN_LINE
        # One line per executed mutation, with its codes.
        lines = {ln.split()[0]: ln for ln in out[:-1]}
        assert sorted(lines) == sorted(m.name for m in MUTS if m.stage != "lin")
        for m in MUTS:
            if m.stage != "lin":
                assert f"[{m.stage}]: " in lines[m.name] and m.expect in lines[m.name]

    def test_no_execute(self, capsys):
        assert cert_repo.main(["--no-execute"]) == 0
        assert capsys.readouterr().out.splitlines() == [CLEAN_LINE]

    def test_list(self, capsys):
        assert cert_repo.main(["--list"]) == 0
        out = capsys.readouterr().out.splitlines()
        assert [ln.split()[1] for ln in out if ln.startswith("family ")] == list(FAMS)
        assert [ln.split()[1] for ln in out if ln.startswith("mutation ") and "exempt" not in ln
                ] == [m.name for m in MUTS]
        assert "family   scalar-merge  [prove protocol:exempt lin:exempt bench:exempt]" in out
        assert "family   gcra  [prove protocol=gcra lin bench]" in out

    @pytest.mark.parametrize("mut", MUTS, ids=[m.name for m in MUTS])
    def test_each_mutation_is_rejected_with_its_code(self, capsys, mut):
        fam = next(f for f in ob.KERNEL_FAMILIES if mut in f.mutations)
        assert cert_repo.main(["--device", "cpu", "--mutation", mut.name]) == 0
        assert capsys.readouterr().out.splitlines()[-1] == (
            f"patrol-cert: mutation '{mut.name}' rejected with {mut.expect} (family {fam.name})")

    def test_tampered_expect_exits_1(self, monkeypatch, capsys):
        fam = FAMS["gcra"]
        mut = next(m for m in fam.mutations if m.stage == "prove")
        bad = dataclasses.replace(fam, mutations=tuple(
            dataclasses.replace(m, expect="PTP004") if m is mut else m for m in fam.mutations))
        monkeypatch.setattr(ob, "KERNEL_FAMILIES", tuple(
            bad if f is fam else f for f in ob.KERNEL_FAMILIES))
        assert cert_repo.main(["--device", "cpu", "--mutation", mut.name]) == 1
        out = capsys.readouterr().out.splitlines()[-1]
        assert out.startswith(f"patrol-cert: mutation '{mut.name}' NOT rejected: ")
        assert "was NOT rejected with PTP004" in out

    def test_findings_exit_1(self, monkeypatch, capsys):
        fam = FAMS["lifecycle"]
        lin = next(m for m in fam.mutations if m.stage == "lin")
        bad = dataclasses.replace(fam, mutations=tuple(
            dataclasses.replace(m, expect="PTN001") if m is lin else m for m in fam.mutations))
        monkeypatch.setattr(ob, "KERNEL_FAMILIES", tuple(
            bad if f is fam else f for f in ob.KERNEL_FAMILIES))
        assert cert_repo.main(["--no-execute"]) == 1
        cap = capsys.readouterr()
        line = cap.out.splitlines()[0]
        assert re.match(r"patrol_tpu_torch/ops/obligations\.py:\d+: PTK002 \[lifecycle\] "
                        r"mutation 'gc-forgets-visible-admits' pins PTN001 but stage 8 "
                        r"registers PTN004", line)
        assert "patrol-cert: 1 finding(s)" in cap.err

    def test_unknown_mutation_is_a_usage_error(self, capsys):
        assert cert_repo.main(["--mutation", "no-such"]) == 2
        assert "unknown mutation: no-such" in capsys.readouterr().err

    def test_device_defaults_to_cuda(self, monkeypatch):
        seen = {}

        def record(execute_mutations=True, device="cpu", stats=None):
            seen["device"] = device
            return []

        monkeypatch.setattr(cert, "check_repo", record)
        assert cert_repo.main([]) == 0
        assert seen == {"device": "cuda"}

    def test_runs_as_a_module(self):
        res = subprocess.run(
            [sys.executable, "-m", "patrol_tpu_torch.scripts.cert_repo", "--device", "cpu",
             "--mutation", "gcra-window-off-by-one"],
            cwd=REPO, capture_output=True, text=True, timeout=300,
        )
        assert res.returncode == 0, res.stderr
        assert res.stdout.splitlines()[-1] == (
            "patrol-cert: mutation 'gcra-window-off-by-one' rejected with PTP002 (family gcra)")
