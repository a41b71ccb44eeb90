"""The port's dispatch stage (``patrol_tpu_torch/analysis/dispatch.py``,
stage 10), on the CPU.

* PTD003 finds C8 — ``zero_rows``'s boolean-mask read of a device tensor,
  under ``_state_mu`` on four engine paths — in a text copy of the old
  function, and the tree is clean.
* The declared waits: the engine's own readbacks on the serve graph are
  exactly the registry's ``DECLARED_WAITS``; a wait nobody declared is a
  finding, and so is a declared wait that was removed.
* PTD005: a launch key without a spec, a spec with neither witness nor
  reason, a bucket law no ``_pad_size`` site has.
* The witness's CPU half passes (shapes, dtypes, reached wrappers), and
  a path that launches more than its registry entry is PTD004. Its event
  waits (counted on the card) are held to ``WITNESS_WAITS``: a wait at an
  undeclared site, or a path off its entry, is PTD004.
* ``DeviceEngine.read_rows`` leaves the staging pool with few shapes.
* The driver's exit codes. The ``cuda``-marked case runs the witness
  under ``torch.cuda.set_sync_debug_mode("error")``.
"""

import dataclasses
import os

import pytest
import torch

from patrol_tpu_torch.analysis import dispatch as D
from patrol_tpu_torch.analysis import lint
from patrol_tpu_torch.ops import _build
from patrol_tpu_torch.ops import obligations as ob
from patrol_tpu_torch.scripts import dispatch_repo

pytestmark = pytest.mark.dispatch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE = "patrol_tpu_torch/runtime/engine.py"
MERGE = "patrol_tpu_torch/ops/merge.py"


@pytest.fixture(scope="module")
def sources():
    return lint.repo_sources(REPO)


def codes(findings):
    return sorted({f.check for f in findings})


def line_of(src: str, text: str) -> int:
    assert src.count(text) == 1, text
    return src[: src.index(text)].count("\n") + 1


class TestC8:
    def test_the_tree_is_clean(self, sources):
        assert D.check_sources(sources) == []

    def test_the_old_zero_rows_is_found(self, sources):
        old = D._with_old_zero_rows(sources)
        f = D.check_sources(old)
        # The mask read sits on the old file's line 167.
        assert line_of(old[MERGE], "    rows = rows[(rows >= 0) & (rows < b)]\n") == 167
        assert [(x.check, x.path, x.line) for x in f] == [("PTD003", MERGE, 167)]
        assert "boolean-mask index of a device value inside zero_rows()" in f[0].message

    def test_the_new_zero_rows_reads_nothing_back(self, sources):
        mods = [lint.Module(r, s) for r, s in sources.items()]
        sites, _ = D.wait_sites(mods)
        assert not [s for s in sites if s.path == MERGE]


class TestDeclaredWaits:
    def test_the_waits_are_the_engine_s_readbacks(self, sources):
        mods = [lint.Module(r, s) for r, s in sources.items()]
        sites, _ = D.wait_sites(mods)
        got = sorted((s.path, s.qualname, s.what) for s in sites)
        assert got == sorted((p, q, w) for p, q, w, _ in ob.DECLARED_WAITS)
        assert len(got) == 8 and all(w == ".synchronize()" for _, _, w in got)
        # Each is an event wait behind a launch, on the lines it names.
        eng = sources[ENGINE]
        lines = sorted(s.line for s in sites if s.path == ENGINE)
        assert lines == sorted(
            i + 1 for i, ln in enumerate(eng.splitlines())
            if ln.strip() in ("ev.synchronize()", "copied.synchronize()",
                              "self._device_event().synchronize()"))

    def test_an_undeclared_wait_is_a_finding(self, sources):
        src = D._undeclared_wait(sources)
        f = D.check_sources(src)
        assert [(x.check, x.path) for x in f] == [("PTD003", ENGINE)]
        assert "torch.cuda.synchronize()" in f[0].message
        assert f[0].line == line_of(src[ENGINE], "            torch.cuda.synchronize()\n")

    def test_a_removed_declared_wait_is_a_finding(self, sources):
        eng = sources[ENGINE]
        gone = "        if ev is not None:\n            ev.synchronize()\n        out = pn_buf"
        assert eng.count(gone) == 1
        src = {**sources, ENGINE: eng.replace(gone, "        out = pn_buf")}
        f = D.check_sources(src)
        assert [x.check for x in f] == ["PTD003"]
        assert "DeviceEngine.read_rows is no longer on the serve graph" in f[0].message

    def test_a_blocking_copy_is_a_finding(self, sources):
        eng = sources[ENGINE]
        nb = "        pn_buf.copy_(got.pn, non_blocking=True)\n"
        src = {**sources, ENGINE: eng.replace(nb, "        pn_buf.copy_(got.pn)\n")}
        f = D.check_sources(src)
        assert [x.check for x in f] == ["PTD003"] and "blocking copy_" in f[0].message

    def test_a_suppression_pardons_and_is_swept(self, sources, tmp_path):
        src = D._undeclared_wait(sources)
        src = {**src, ENGINE: src[ENGINE].replace(
            "            torch.cuda.synchronize()\n",
            "            torch.cuda.synchronize()  # patrol-lint: disable=PTD003\n")}
        used = set()
        assert D.check_sources(src, used_out=used) == []
        assert any(tok == "PTD003" for _, _, tok in used)


class TestCompleteness:
    def test_a_launch_key_without_a_spec(self, sources):
        f = D.check_sources(sources, launch_keys=(*_build.LAUNCHES, "shadow"))
        assert [x.check for x in f] == ["PTD005"] and "'shadow'" in f[0].message

    def test_a_launcher_without_a_spec(self, sources):
        f = D.check_sources(D._unspecced_launch(sources),
                            launch_keys=(*_build.LAUNCHES, "shadow"))
        assert codes(f) == ["PTD005"]
        assert any("shadow_kernel.shadow() counts kernel launches" in x.message for x in f)

    def test_a_spec_with_neither_witness_nor_reason(self, sources):
        specs = tuple(dataclasses.replace(s, witness_absent="") if s.name == "merge_dense"
                      else s for s in ob.DISPATCH_SPECS)
        f = D.check_sources(sources, specs=specs)
        assert [x.check for x in f] == ["PTD005"] and "neither a witness" in f[0].message

    def test_a_drifted_bucket_law(self, sources):
        specs = tuple(dataclasses.replace(s, bucket_hi="4096") if s.name == "take_n"
                      else s for s in ob.DISPATCH_SPECS)
        f = D.check_sources(sources, specs=specs)
        assert [x.check for x in f] == ["PTD005"] and "bucket law" in f[0].message

    def test_ptd001_and_ptd002_are_absences_on_record(self, sources):
        f = D.check_sources(sources, absent={"PTD001": ob.DISPATCH_ABSENT["PTD001"]})
        assert [x.check for x in f] == ["PTD005"] and "PTD002" in f[0].message

    def test_every_key_and_caller_has_a_spec(self):
        assert {s.name for s in ob.DISPATCH_SPECS} >= set(_build.LAUNCHES)
        assert {"zero_rows", "read_rows", "merge_dense"} <= {s.name for s in ob.DISPATCH_SPECS}
        assert set(ob.WITNESS_LAUNCHES) == set(D.WITNESS_PATHS) and len(D.WITNESS_PATHS) == 22


class TestWitness:
    def test_the_cpu_half_passes(self):
        r = D.run_witness("cpu")
        assert r.findings == [], [str(f) for f in r.findings]
        assert r.half.startswith("the CPU half") and r.paths == D.WITNESS_PATHS
        for path, want in ob.WITNESS_LAUNCHES.items():
            got = {k: v for k, v in r.reached[path].items() if k in _build.LAUNCHES}
            assert got == {k: v for k, v in want.items() if v}, path
            assert r.launches[path] == {}, path  # no kernel runs on the CPU
        assert r.reached["zero_rows"] == {"zero_rows": 1}
        assert r.reached["read_rows"] == {"read_rows": 1}
        assert r.builds_after_warmup == 0

    def test_an_extra_launch_is_ptd004(self):
        r = D.run_witness("cpu", only=("take_n",), mutate="extra_launch")
        assert codes(r.findings) == ["PTD004"]
        assert "reached the kernel wrappers {'take_n': 2}" in r.findings[0].message

    def test_the_wait_counter_names_the_site(self, monkeypatch):
        # The counter patches the class's method; a stand-in keeps the
        # CPU from touching CUDA. Sites are spelled as DECLARED_WAITS
        # spells them: file::qualname with <locals> dropped.
        seen = []
        monkeypatch.setattr(torch.cuda.Event, "synchronize", lambda ev: seen.append(ev))
        stand_in = torch.cuda.Event.synchronize

        def reader():
            torch.cuda.Event.synchronize("ev")

        with D._Waits(True) as w:
            reader()
            reader()
        assert torch.cuda.Event.synchronize is stand_in and seen == ["ev", "ev"]
        assert w.counts == {"tests/test_torch_dispatch.py::TestWitness."
                            "test_the_wait_counter_names_the_site.reader": 2}
        with D._Waits(False) as off:
            reader()
        assert off.counts == {}

    def test_waits_are_held_to_the_registry(self):
        read = f"{ENGINE}::DeviceEngine.read_rows"
        assert D.wait_findings("read_rows", {read: 1}) == []
        # A wait at no declared site.
        f = D.wait_findings("read_rows", {read: 1, f"{ENGINE}::DeviceEngine.take": 1})
        assert codes(f) == ["PTD004"] and "DECLARED_WAITS does not list" in f[0].message
        # A declared wait the path's entry does not name, and one it misses.
        f = D.wait_findings("gcra", {read: 1})
        assert codes(f) == ["PTD004"] and "WITNESS_WAITS entry declares" in f[0].message
        f = D.wait_findings("read_rows", {})
        assert codes(f) == ["PTD004"]
        # The commit timing's wait is expected only while timing is on.
        assert D.wait_findings("merge_scalar", {}, timed=False) == []
        assert codes(D.wait_findings("merge_scalar", {})) == ["PTD004"]

    def test_every_path_has_a_waits_entry_of_declared_waits(self, sources, monkeypatch):
        declared = {q for _p, q, _w, _why in ob.DECLARED_WAITS}
        assert set(ob.WITNESS_WAITS) == set(D.WITNESS_PATHS)
        assert {q for qs in ob.WITNESS_WAITS.values() for q in qs} <= declared
        monkeypatch.setitem(ob.WITNESS_WAITS, "read_rows", ("DeviceEngine.no_such",))
        f = D.check_sources(sources)
        assert [x.check for x in f] == ["PTD005"] and "'DeviceEngine.no_such'" in f[0].message


class TestDriver:
    def test_clean_on_the_cpu(self, capsys):
        assert dispatch_repo.main(["--device", "cpu"]) == 0
        out = capsys.readouterr().out.splitlines()
        assert out[0].startswith("witness on cpu (the CPU half")
        assert out[-1] == ("patrol-dispatch: clean (15 specs, 22 witness paths on cpu, "
                           "8 declared waits; PTD001, PTD002 absent on record)")

    def test_list(self, capsys):
        assert dispatch_repo.main(["--device", "cpu", "--list"]) == 0
        out = capsys.readouterr().out
        assert out.count("\npath: ") + out.startswith("path: ") == 22
        assert "absent: PTD001" in out and "absent: PTD002" in out

    @pytest.mark.parametrize("name", ["zero-rows-mask-read", "undeclared-wait",
                                      "unspecced-launch", "extra-launch"])
    def test_mutation(self, capsys, name):
        assert dispatch_repo.main(["--device", "cpu", "--mutation", name]) == 0
        code = D.DISPATCH_MUTATIONS[name][0]
        assert capsys.readouterr().out.splitlines()[-1] == (
            f"patrol-dispatch: mutation '{name}' REJECTED by {code} (good)")

    def test_unknown_mutation(self):
        assert dispatch_repo.main(["--device", "cpu", "--mutation", "no-such"]) == 2


def test_read_rows_pool_keeps_few_shapes():
    """Many distinct K leave the staging pool with power-of-two shapes
    only, and none above MAX_MERGE_ROWS rows; every read equals the
    plain gather."""
    import numpy as np

    from patrol_tpu_torch.models.limiter import LimiterConfig
    from patrol_tpu_torch.runtime import engine as engine_mod

    eng = engine_mod.DeviceEngine(LimiterConfig(64, 2), node_slot=0, device="cpu")
    try:
        rng = np.random.default_rng(7)
        eng.state.pn.copy_(torch.from_numpy(rng.integers(0, 1 << 40, (64, 2, 2))))
        eng.state.elapsed.copy_(torch.from_numpy(rng.integers(0, 1 << 40, 64)))
        before = set(eng._staging._free)
        big = engine_mod.MAX_MERGE_ROWS + 5
        for k in list(range(0, 70)) + [300, 1000, 4097, big]:
            rows = rng.integers(-64, 64, k)
            pn, el = eng.read_rows(rows)
            assert pn.shape == (k, 2, 2) and el.shape == (k,)
            np.testing.assert_array_equal(pn, eng.state.pn.numpy()[rows])
            np.testing.assert_array_equal(el, eng.state.elapsed.numpy()[rows])
        new = set(eng._staging._free) - before
        kps = {key[1] for key in new}
        assert all(kp & (kp - 1) == 0 and 8 <= kp <= engine_mod.MAX_MERGE_ROWS for kp in kps)
        assert len(new) <= 2 * 11, sorted(new)  # (kp,) and (kp, N, 2) for 8 .. 8192
    finally:
        eng.stop()


@pytest.mark.cuda
def test_the_witness_on_the_card_under_the_sync_detector():
    """Every path warm, then under set_sync_debug_mode("error") (chip_smoke.py
    phase 3m runs the same): nothing raises, each path's launches as
    declared."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels do not run on the CPU")
    r = D.run_witness("cuda")
    assert r.findings == [], [str(f) for f in r.findings]
    for path, want in ob.WITNESS_LAUNCHES.items():
        assert r.launches[path] == {k: v for k, v in want.items() if v}, path
    assert torch.cuda.get_sync_debug_mode() == 0
