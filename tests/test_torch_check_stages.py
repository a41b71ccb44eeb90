"""The port's stage drivers (``patrol_tpu_torch/scripts/{protocol,lin,abi,lint,race}_repo.py``)
and the shared machinery under them (``analysis/driver.py``,
``analysis/lint.py``), on the CPU.

The exit contract is the reference's: 0 when clean (a summary on
stdout), 1 with findings printed as ``path:line: CODE message``, 2 for
an unknown name, and 77 from ``abi_repo`` when the port's library cannot
load (a loud skip on stderr, never a pass). A clean protocol or lin run
prints each seeded mutation's verdict with its code; ``--list`` and
``--mutation`` behave as the reference's. Exact comparisons only
(codes, exit statuses, lines): tolerance zero.
"""

import subprocess
import sys
from pathlib import Path

import pytest

from patrol_tpu_torch.analysis import abi, driver, lint
from patrol_tpu_torch.analysis import linearizability as L
from patrol_tpu_torch.analysis import protocol as P
from patrol_tpu_torch.ops.obligations import MUTATIONS
from patrol_tpu_torch.analysis import race as R
from patrol_tpu_torch.scripts import abi_repo, lin_repo, lint_repo, protocol_repo, race_repo

REPO = Path(__file__).resolve().parent.parent


class TestProtocolRepo:
    def test_clean_run_prints_every_verdict_with_its_code(self, capsys):
        assert protocol_repo.main([]) == 0
        out = capsys.readouterr().out.splitlines()
        for m in MUTATIONS:
            if m.stage == "protocol":
                assert f"patrol-protocol: mutation '{m.name}' REJECTED by {m.expect} (good)" in out
        assert out[-1].startswith("patrol-protocol: clean (async states explored=31, 14 seeded")

    def test_list_names_the_model_s_and_the_registry_s_mutations(self, capsys):
        assert protocol_repo.main(["--list"]) == 0
        names = capsys.readouterr().out.split()
        assert names == list(P.MUTATIONS) + [
            "gcra-conformance-own-lane-only", "conc-phantom-release-model", "quota-debit-leaf-only"]

    @pytest.mark.parametrize("name,code", [
        ("merge-assigns-lww", "PTC002"), ("quota-debit-leaf-only", "PTC006"),
    ])
    def test_one_mutation(self, capsys, name, code):
        assert protocol_repo.main(["--mutation", name]) == 0
        out = capsys.readouterr().out
        assert f"{P._SELF}:0: {code} " in out
        assert out.splitlines()[-1] == f"patrol-protocol: mutation '{name}' REJECTED by {code} (good)"

    def test_unknown_mutation_is_a_usage_error(self, capsys):
        assert protocol_repo.main(["--mutation", "no-such"]) == 2
        assert "unknown mutation: no-such" in capsys.readouterr().err

    def test_a_mutation_caught_by_another_code_fails_the_run(self, monkeypatch, capsys):
        # The registry pins incast-gate-bypass to PTC003: a model that
        # only caught it under another code is a finding (PTC005).
        real = protocol_repo.mutation_findings

        def skewed(name):
            findings, expect = real(name)
            if name == "incast-gate-bypass":
                findings = [P.Finding("PTC001", P._SELF, 0, "elsewhere")]
            return findings, expect

        monkeypatch.setattr(protocol_repo, "mutation_findings", skewed)
        assert protocol_repo.main([]) == 1
        cap = capsys.readouterr()
        assert "mutation 'incast-gate-bypass' NOT caught by PTC003 (got: ['PTC001']) (bad)" in cap.out
        assert f"{P._SELF}:0: PTC005 seeded protocol mutation 'incast-gate-bypass'" in cap.out
        assert "patrol-protocol: 1 finding(s)" in cap.err

    def test_runs_as_a_module(self):
        res = subprocess.run(
            [sys.executable, "-m", "patrol_tpu_torch.scripts.protocol_repo", "--mutation",
             "delta-gc-before-ack"], cwd=REPO, capture_output=True, text=True, timeout=300,
        )
        assert res.returncode == 0, res.stderr
        assert res.stdout.splitlines()[-1] == (
            "patrol-protocol: mutation 'delta-gc-before-ack' REJECTED by PTC001 (good)")


class TestLinRepo:
    def test_list(self, capsys):
        assert lin_repo.main(["--list"]) == 0
        out = capsys.readouterr().out.splitlines()
        assert sum(ln.startswith("family ") for ln in out) == 7
        assert sum(ln.startswith("mutation ") for ln in out) == 4

    def test_one_mutation(self, capsys):
        assert lin_repo.main(["--mutation", "take-ignores-visible-remote-spend"]) == 0
        last = capsys.readouterr().out.splitlines()[-1]
        assert last.startswith(
            "patrol-lin: mutation 'take-ignores-visible-remote-spend' REJECTED by PTN001 (good)")

    def test_unknown_mutation_is_a_usage_error(self, capsys):
        assert lin_repo.main(["--mutation", "no-such"]) == 2

    def test_verdicts_follow_the_gate(self, monkeypatch, capsys):
        # A gate that reports one mutation as not rejected: its verdict
        # line says so, the others say REJECTED, and the run fails.
        miss = L.Finding("PTN005", L._SELF, 0,
                         "seeded linearizability mutation 'gc-forgets-visible-admits' was "
                         "NOT rejected with PTN004 (got: clean)")
        monkeypatch.setattr(L, "check_repo", lambda specs: (123, [miss]))
        assert lin_repo.main([]) == 1
        out = capsys.readouterr().out
        assert "mutation 'gc-forgets-visible-admits' NOT caught by PTN004 (bad)" in out
        assert "mutation 'take-ignores-visible-remote-spend' REJECTED by PTN001 (good)" in out
        assert f"{L._SELF}:0: PTN005 seeded linearizability mutation" in out

    def test_clean_gate_exits_0(self, monkeypatch, capsys):
        monkeypatch.setattr(L, "check_repo", lambda specs: (16411, []))
        assert lin_repo.main([]) == 0
        out = capsys.readouterr().out.splitlines()
        assert out[-1].startswith("patrol-lin: clean (schedules explored=16411 across 7")
        assert sum("REJECTED by" in ln for ln in out) == 4


class TestAbiRepo:
    def test_clean_on_the_cpu(self, capsys):
        from patrol_tpu_torch import native

        if native.load() is None:
            pytest.skip("the port's native host library does not build here (no g++?)")
        assert abi_repo.main(["--device", "cpu"]) == 0
        assert capsys.readouterr().out.splitlines()[-1] == (
            "patrol-abi: clean (5 obligations, all hold, fold twins on cpu)")

    def test_unavailable_library_is_a_loud_77(self, monkeypatch, capsys):
        def unavailable():
            raise abi.NativeUnavailable("no toolchain")

        monkeypatch.setattr(abi, "_load_lib", unavailable)
        assert abi_repo.main(["--device", "cpu"]) == 77
        assert "patrol-abi: SKIPPED — no toolchain" in capsys.readouterr().err

    def test_findings_exit_1(self, monkeypatch, capsys):
        f = lint.Finding("PTA001", "patrol_tpu_torch/native/patrol_host.cpp", 3, "diverges")
        monkeypatch.setattr(abi, "abi_all", lambda only=None, device="cpu": [f])
        assert abi_repo.main(["--device", "cpu", "--only", "fold"]) == 1
        cap = capsys.readouterr()
        assert cap.out.splitlines() == ["patrol_tpu_torch/native/patrol_host.cpp:3: PTA001 diverges"]
        assert "patrol-abi: 1 finding(s) across 1 file(s)" in cap.err

    def test_device_defaults_to_cuda(self, monkeypatch):
        seen = {}

        def record(only=None, device="cpu"):
            seen["device"] = device
            return []

        monkeypatch.setattr(abi, "abi_all", record)
        assert abi_repo.main(["--only", "fold"]) == 0
        assert seen == {"device": "cuda"}

    def test_list(self, capsys):
        assert abi_repo.main(["--list"]) == 0
        out = capsys.readouterr().out.splitlines()
        assert [ln.split()[0] for ln in out] == [
            "native.pt_fold_hybrid", "native.pt_rx_classify", "native.hls_schedules",
            "native.rx_ring_schedules", "native.effects_table"]


class TestLintRepo:
    def test_clean_on_the_tree(self, capsys):
        assert lint_repo.main([]) == 0
        assert capsys.readouterr().out.splitlines() == ["patrol-lint: clean"]

    def test_findings_exit_1(self, tmp_path, capsys):
        pkg = tmp_path / "patrol_tpu_torch"
        pkg.mkdir()
        (pkg / "x.py").write_text("import time\n\ndef f():\n    return time.time()\n")
        assert lint_repo.main(["--root", str(tmp_path)]) == 1
        cap = capsys.readouterr()
        assert [ln.split(" ", 2)[:2] for ln in cap.out.splitlines()] == [
            ["patrol_tpu_torch/x.py:4:", "PTL001"]]
        assert cap.err.strip() == "patrol-lint: 1 finding(s) across 1 file(s)"

    def test_runs_as_a_module(self):
        res = subprocess.run(
            [sys.executable, "-m", "patrol_tpu_torch.scripts.lint_repo"], cwd=REPO,
            capture_output=True, text=True, timeout=300,
        )
        assert (res.returncode, res.stdout) == (0, "patrol-lint: clean\n"), res.stderr


class TestRaceRepo:
    CLEAN = ("patrol-race: clean (seam states explored=157 across 3 scenarios, 3 seeded "
             "mutations all rejected; 57 guarded attrs, 8 thread-ensemble files)")

    def test_clean_run_prints_the_reference_s_line(self, capsys):
        assert race_repo.main([]) == 0
        assert capsys.readouterr().out.splitlines() == [self.CLEAN]

    def test_static_only(self, capsys):
        assert race_repo.main(["--static-only"]) == 0
        assert capsys.readouterr().out.splitlines() == [self.CLEAN]

    def test_list(self, capsys):
        assert race_repo.main(["--list"]) == 0
        assert capsys.readouterr().out.split() == [
            "completion-before-park", "ring-slot-reuse-without-fence",
            "ack-without-holding-mutex"]

    @pytest.mark.parametrize("name,code", [
        ("completion-before-park", "PTR001"), ("ring-slot-reuse-without-fence", "PTR002"),
        ("ack-without-holding-mutex", "PTR002"),
    ])
    def test_each_mutation_is_rejected_with_its_code(self, capsys, name, code):
        assert race_repo.main(["--mutation", name]) == 0
        out = capsys.readouterr().out.splitlines()
        assert out[-1] == f"patrol-race: mutation '{name}' REJECTED by {code} (good)"
        assert any(ln.startswith(f"{R._HTTP_CPP}:") and f" {code} " in ln for ln in out[:-1])

    def test_unknown_mutation_is_a_usage_error(self, capsys):
        assert race_repo.main(["--mutation", "no-such"]) == 2
        assert "unknown mutation: no-such" in capsys.readouterr().err

    def test_findings_exit_1(self, monkeypatch, capsys):
        f = lint.Finding("PTR003", "patrol_tpu_torch/runtime/engine.py", 9, "unguarded")
        monkeypatch.setattr(R, "race_repo", lambda root: [f])
        assert race_repo.main([]) == 1
        cap = capsys.readouterr()
        assert cap.out.splitlines() == ["patrol_tpu_torch/runtime/engine.py:9: PTR003 unguarded"]
        assert "patrol-race: 1 finding(s)" in cap.err

    def test_a_seam_mutation_that_slips_through_fails(self, monkeypatch, capsys):
        monkeypatch.setitem(R.SEAM_MUTATIONS, "no-op", (R.SEAM_CLEAN, "PTR001"))
        assert race_repo.main(["--mutation", "no-op"]) == 1
        assert capsys.readouterr().out.splitlines()[-1] == (
            "patrol-race: mutation 'no-op' NOT caught (bad)")

    def test_runs_as_a_module(self):
        res = subprocess.run(
            [sys.executable, "-m", "patrol_tpu_torch.scripts.race_repo", "--mutation",
             "completion-before-park"], cwd=REPO, capture_output=True, text=True, timeout=300,
        )
        assert res.returncode == 0, res.stderr
        assert res.stdout.splitlines()[-1] == (
            "patrol-race: mutation 'completion-before-park' REJECTED by PTR001 (good)")


class TestSharedMachinery:
    def test_repo_root_is_the_checkout(self):
        assert driver.repo_root_for(protocol_repo.__file__) == str(REPO)

    def test_native_effects_reads_the_port_s_table(self):
        from patrol_tpu_torch.native import NATIVE_EFFECTS

        assert set(lint.native_effects()) == set(NATIVE_EFFECTS)

    def test_directives_come_from_comments_only(self):
        src = 's = "# patrol-lint: disable=PTN001"\nx = 1  # patrol-lint: disable=PTN002,PTA001\n'
        assert lint.directive_map(src) == {2: {"PTN002", "PTA001"}}

    def test_stale_sweep_flags_only_unused_tokens_of_its_family(self):
        mod = lint.Module("patrol_tpu_torch/x.py", "a = 1  # patrol-lint: disable=PTL001\n"
                          "b = 2  # patrol-lint: disable=PTL004\n"
                          "c = 3  # patrol-lint: disable=PTL005,PTL006\n")
        assert mod.suppressed("PTL004", 2)
        out = lint.stale_suppression_findings([mod])
        assert [(f.check, f.line) for f in out] == [("PTL006", 1)]
        assert "stale suppression `PTL001`" in out[0].message
