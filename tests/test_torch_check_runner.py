"""The port's check runner (``patrol_tpu_torch/scripts/check.sh``) and its
CI gate (``patrol_tpu_torch/scripts/ci_gate.sh``), run as subprocesses on
the CPU.

* ``--stage tidy`` without ``clang-tidy`` is a loud skip (exit 77 inside,
  the runner's summary line says ``skipped=tidy``) and exits 0; the CI
  gate turns that skip into a failure unless ``--allow-skip tidy`` waives
  it.
* An unknown stage or device is a usage error (exit 2).
* ``--stage cert --device cpu`` runs ``cert_repo`` and the cert
  self-tests and passes. Neither the runner nor the gate takes an option
  that leaves a stage's self-tests unrun (exit 2).
* ``--stage san`` builds both sanitizer drivers of
  ``patrol_tpu_torch/native/san/`` against the port's library under
  thread, address and undefined, and passes; pointed at a copy of the
  tree whose UDP driver races on an unsynchronized counter, the stage
  fails under TSan, so it is not vacuous. Where the toolchain lacks one
  of the three sanitizer runtimes, the san cases skip and say which.

Exact comparisons of the summary line and exit codes: tolerance zero.
"""

import os
import shutil
import subprocess
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
CHECK = REPO / "patrol_tpu_torch" / "scripts" / "check.sh"
GATE = REPO / "patrol_tpu_torch" / "scripts" / "ci_gate.sh"


def run(script, *args, timeout=600):
    res = subprocess.run(
        ["bash", str(script), *args], cwd=REPO, capture_output=True, text=True,
        timeout=timeout, env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    return res.returncode, res.stdout, res.stderr


def summary(out: str) -> str:
    return [ln for ln in out.splitlines() if ln.startswith("PATROL_CHECK ")][-1]


@pytest.fixture
def sanitizers():
    """Skip unless g++ ships all three sanitizer runtimes the san stage
    links (decided here, at test time)."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host: the san stage cannot build its drivers")
    missing = []
    for lib in ("libtsan.so", "libasan.so", "libubsan.so"):
        path = subprocess.run(["g++", f"-print-file-name={lib}"], capture_output=True,
                              text=True).stdout.strip()
        if not (os.path.isabs(path) and os.path.exists(path)):
            missing.append(lib)
    if missing:
        pytest.skip(f"this toolchain lacks {', '.join(missing)}: the san stage cannot link")


def test_tidy_is_a_loud_skip_without_clang_tidy():
    rc, out, _ = run(CHECK, "--stage", "tidy")
    assert rc == 0
    if shutil.which("clang-tidy") is None:
        assert "clang-tidy not installed: SKIPPED" in out
        assert summary(out) == (
            "PATROL_CHECK stages=1 pass=0 skip=1 fail=0 skipped=tidy failed=-")
    else:
        assert summary(out) == "PATROL_CHECK stages=1 pass=1 skip=0 fail=0 skipped=- failed=-"


def test_ci_gate_fails_on_a_skipped_tidy_unless_waived():
    rc, out, err = run(GATE, "--stage", "tidy")
    if shutil.which("clang-tidy") is None:
        assert rc == 1
        assert "ci_gate: clang-tidy not installed" in err
    else:
        assert rc == 0
    rc, out, err = run(GATE, "--stage", "tidy", "--allow-skip", "tidy")
    assert rc == 0, err
    assert out.splitlines()[-1].startswith("ci_gate: PASS — PATROL_CHECK stages=1 ")


@pytest.mark.parametrize("args", [("--stage", "nope"), ("--stage", "lint,nope"),
                                  ("--device", "tpu"), ("--bogus",), ("--no-selftests",)])
def test_usage_errors_exit_2(args):
    rc, out, err = run(CHECK, *args)
    assert rc == 2
    assert "PATROL_CHECK" not in out
    assert "unknown" in err


def test_cert_stage_passes_on_the_cpu():
    rc, out, err = run(CHECK, "--stage", "cert", "--device", "cpu", timeout=900)
    assert rc == 0, out[-3000:] + err[-3000:]
    assert ("patrol-cert: clean (8 families, 18 seeded mutations executed + 4 stage-8 "
            "references pinned, all rejected with their exact codes)") in out.splitlines()
    assert " passed" in out and "NOTICE" not in out  # the cert self-tests ran
    assert summary(out) == "PATROL_CHECK stages=1 pass=1 skip=0 fail=0 skipped=- failed=-"
    assert out.splitlines()[-1] == "patrol-check: ALL CLEAN"


@pytest.mark.parametrize("args", [("--bogus",), ("--no-selftests",)])
def test_ci_gate_usage_errors_exit_2(args):
    rc, out, err = run(GATE, "--allow-skip", "tidy", *args)
    assert rc == 2
    assert "PATROL_CHECK" not in out
    assert f"ci_gate: unknown argument {args[0]}" in err


def test_san_stage_passes(sanitizers):
    rc, out, err = run(CHECK, "--stage", "san")
    assert rc == 0, out[-3000:] + err[-3000:]
    for san in ("thread", "address", "undefined"):
        assert f"-- host driver / {san}: clean in " in out
        assert f"-- http driver / {san}: clean in " in out
    assert out.count("tsan driver ok: 25600 packets received") == 3
    assert out.count("san http driver ok: ") == 3
    assert summary(out) == "PATROL_CHECK stages=1 pass=1 skip=0 fail=0 skipped=- failed=-"


RACE = """
// A deliberate data race: two threads bump one counter with no lock.
static long pt_unsynchronized_counter = 0;
static struct PtRace {
  PtRace() {
    auto bump = [] { for (int i = 0; i < 100000; ++i) ++pt_unsynchronized_counter; };
    std::thread a(bump), b(bump);
    a.join();
    b.join();
  }
} pt_race;
"""


def test_san_stage_catches_a_race(sanitizers, tmp_path):
    pkg = tmp_path / "patrol_tpu_torch"
    (pkg / "scripts").mkdir(parents=True)
    shutil.copy(CHECK, pkg / "scripts" / "check.sh")
    shutil.copytree(REPO / "patrol_tpu_torch" / "native", pkg / "native",
                    ignore=shutil.ignore_patterns("__pycache__", "*.py"))
    driver = pkg / "native" / "san" / "tsan_driver.cpp"
    driver.write_text(driver.read_text() + RACE)
    rc, out, err = run(pkg / "scripts" / "check.sh", "--stage", "san")
    assert rc == 1
    assert "WARNING: ThreadSanitizer: data race" in out + err
    assert "pt_unsynchronized_counter" in out + err
    assert summary(out) == "PATROL_CHECK stages=1 pass=0 skip=0 fail=1 skipped=- failed=san"
