"""The port's lint stage (``patrol_tpu_torch/analysis/lint.py``) against
the JAX package's, and its own tables and repairs, on the CPU.

**Against the reference.** Every test of ``tests/test_lint.py`` that
lints a fixture runs here with the reference's ``lint_sources`` (and
``apply_suppressions``) recording what it was given and what it found.
Each recorded fixture, its paths and imports re-keyed from ``patrol_tpu``
to ``patrol_tpu_torch``, then goes through the port's function:

* as it stands, the port gives the reference's findings exactly, less
  the PTL002 ones: a ``jax.jit`` root is not a launch root;
* with a kernel launch put in front of the first statement of each of
  the reference's jit roots (``_build.count_launch("fixture"); ``, on the
  same line, so no line moves), the port gives every one of the
  reference's findings with the same code, path, line and message, the
  PTL002 messages read with the port's wording for the root
  (:data:`PTL002_WORDING`).

**The port's own.** PTL002's launch roots, primitives, CPU-branch and
boundary cut, and its ``.cu`` half; torch's constructor spellings for
PTL004; the tables name things that exist; the tree lints clean; and a
test for each repair (``ops/merge.py``'s ``arange`` dtype, the commit
ring's counter table, the counters declared in ``_KNOWN``, the four
``clock-seam`` markers). Exact comparisons only: tolerance zero.
"""

import ast
import importlib.util
import inspect
import re
import shutil
from pathlib import Path

import numpy as np
import pytest

from patrol_tpu.analysis import lint as ref_lint
from patrol_tpu_torch.analysis import lint

pytestmark = pytest.mark.lint

REPO = Path(__file__).resolve().parent.parent
PKG = "patrol_tpu_torch"

# The reference's PTL002 message, re-worded for a launch root.
PTL002_WORDING = (
    ("which is reachable from a jitted take/merge kernel (reachable from jit root via",
     "which is on a CUDA kernel's launch path (reachable from a launch root via"),
    ("which is reachable from a jitted take/merge kernel",
     "which is on a CUDA kernel's launch path"),
)
LAUNCH = '_build.count_launch("fixture"); '


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_ref_{name}", REPO / "tests" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_REF = _load("test_lint")


def _fixture_cases():
    out = []
    for cname, cls in sorted(vars(_REF).items()):
        if not (cname.startswith("Test") and inspect.isclass(cls)):
            continue
        for mname, fn in sorted(vars(cls).items()):
            if not (mname.startswith("test_") and callable(fn)):
                continue
            src = inspect.getsource(fn)
            if "lint_sources(" in src or "apply_suppressions(" in src:
                out.append((cname, mname))
    return out


CASES = _fixture_cases()


def rekey(text: str) -> str:
    return re.sub(r"\bpatrol_tpu\b", PKG, text)


def _reworded(msg: str) -> str:
    for old, new in PTL002_WORDING:
        msg = msg.replace(old, new)
    return msg


def _rows(findings, port_wording=False):
    return [
        (f.check, rekey(f.path), f.line, _reworded(rekey(f.message)) if port_wording else rekey(f.message))
        for f in findings
    ]


def launch_twin(sources):
    """The fixture with a kernel launch in front of the first statement
    of each of the reference's jit roots, on the same line."""
    mods = [ref_lint.Module(p, s) for p, s in sorted(sources.items())]
    index = ref_lint._FuncIndex(mods)
    at = {}
    for rel, key in ref_lint._jit_roots(mods, index):
        first = index.funcs[(rel, key)].body[0]
        assert not isinstance(first, (ast.If, ast.For, ast.While, ast.With, ast.Try,
                                      ast.FunctionDef, ast.ClassDef)), key
        at.setdefault(rel, set()).add((first.lineno, first.col_offset))
    out = {}
    for rel, src in sources.items():
        lines = src.splitlines(keepends=True)
        for ln, col in sorted(at.get(rel, ()), reverse=True):
            lines[ln - 1] = lines[ln - 1][:col] + LAUNCH + lines[ln - 1][col:]
        out[rel] = "".join(lines)
    return out


def _run_recording(case, monkeypatch, tmp_path):
    cname, mname = case
    calls = []
    real_lint, real_apply = ref_lint.lint_sources, ref_lint.apply_suppressions

    def lint_sources(sources):
        found = real_lint(sources)
        calls.append(("lint", dict(sources), None, found))
        return found

    def apply_suppressions(findings, repo_root, stale_family=None, inline_used=None):
        found = real_apply(findings, repo_root, stale_family=stale_family, inline_used=inline_used)
        files = {
            str(p.relative_to(repo_root)): p.read_text()
            for p in Path(repo_root).rglob("*.py")
        }
        calls.append(("apply", files, (list(findings), stale_family, inline_used), found))
        return found

    monkeypatch.setattr(ref_lint, "lint_sources", lint_sources)
    monkeypatch.setattr(ref_lint, "apply_suppressions", apply_suppressions)
    method = getattr(getattr(_REF, cname)(), mname)
    params = inspect.signature(method).parameters
    ref_root = tmp_path / "ref"
    ref_root.mkdir()
    method(**({"tmp_path": ref_root} if "tmp_path" in params else {}))
    monkeypatch.undo()
    assert calls, f"{cname}.{mname} linted nothing"
    return calls


@pytest.mark.parametrize("case", CASES, ids=["::".join(c) for c in CASES])
def test_reference_fixture_gives_the_reference_findings(case, monkeypatch, tmp_path):
    for kind, files, extra, ref_found in _run_recording(case, monkeypatch, tmp_path):
        if kind == "lint":
            port_src = {rekey(p): rekey(s) for p, s in files.items()}
            want = _rows(ref_found)
            assert _rows(lint.lint_sources(port_src)) == [
                r for r in want if r[0] != "PTL002"
            ]
            twin = launch_twin(files)
            got = lint.lint_sources({rekey(p): rekey(s) for p, s in twin.items()})
            assert _rows(got) == _rows(ref_found, port_wording=True)
        else:
            findings, family, used = extra
            root = tmp_path / "port"
            for rel, src in files.items():
                dst = root / rekey(rel)
                dst.parent.mkdir(parents=True, exist_ok=True)
                dst.write_text(rekey(src))
            got = lint.apply_suppressions(
                [lint.Finding(f.check, rekey(f.path), f.line, f.message) for f in findings],
                str(root), stale_family=family,
                inline_used={(rekey(p), ln, t) for p, ln, t in used} if used else used,
            )
            assert _rows(got) == _rows(ref_found)
            shutil.rmtree(root)


def test_every_ptl002_fixture_is_replayed_as_a_launch_twin():
    """Non-vacuous: the recorded fixtures include the reference's PTL002
    cases through the call graph, instance attributes and the native
    boundary, and the silent ones."""
    names = {m for _, m in CASES}
    assert {"test_fires_through_the_call_graph", "test_fires_through_instance_attribute",
            "test_fires_on_blocking_native_call_in_jit_root",
            "test_silent_when_sync_is_not_reachable", "test_family_sweep_honors_inline_used",
            } <= names
    assert len(CASES) >= 60


# ---------------------------------------------------------------------------
# PTL002, the port's launch roots.

TAKE = f"{PKG}/ops/take_kernel.py"
TAKE_CU = f"{PKG}/csrc/take.cu"
LAUNCH_LINE = '    _build.count_launch("take_n")\n'
CPU_LINE = "        return take_n_plain(pn, elapsed, packed, node_slot)\n"


@pytest.fixture(scope="module")
def take_src():
    return (REPO / TAKE).read_text()


@pytest.fixture(scope="module")
def take_cu():
    return (REPO / TAKE_CU).read_text()


def _line_of(src, needle):
    return src[: src.index(needle)].count("\n") + 1


def _after_launch(src, stmt):
    assert src.count(LAUNCH_LINE) == 1
    return src.replace(LAUNCH_LINE, LAUNCH_LINE + f"    {stmt}\n")


class TestLaunchSync:
    def test_item_in_the_card_path_is_flagged(self, take_src):
        src = _after_launch(take_src, "out[1].sum().item()")
        f = lint.lint_sources({TAKE: src})
        line = _line_of(take_src, LAUNCH_LINE) + 1
        assert [(x.check, x.path, x.line) for x in f] == [("PTL002", TAKE, line)]
        assert f[0].message == (
            "host-device sync .item() inside take_n(), which is on a CUDA kernel's launch path")

    def test_tolist_in_the_cpu_branch_is_not(self, take_src):
        src = take_src.replace(CPU_LINE, "        packed.tolist()\n" + CPU_LINE)
        assert src != take_src
        assert lint.lint_sources({TAKE: src}) == []

    def test_the_else_of_a_cpu_branch_is_walked(self):
        src = (
            "def wrapper(x, dev):\n"
            "    if dev.type == 'cpu':\n"
            "        return x.tolist()\n"
            "    else:\n"
            "        x.cpu()\n"
            "    _build.count_launch('k')\n"
        )
        f = lint.lint_sources({f"{PKG}/ops/k.py": src})
        assert [(x.check, x.line) for x in f] == [("PTL002", 5)]

    @pytest.mark.parametrize("stmt,what", [
        ("out.cpu()", ".cpu()"),
        ("out.tolist()", ".tolist()"),
        ("out.numpy()", ".numpy()"),
        ("torch.cuda.synchronize()", ".synchronize()"),
        ("torch.cuda.current_stream().synchronize()", ".synchronize()"),
        ("torch.nonzero(out[1])", ".nonzero()"),
        ("out[1].nonzero()", ".nonzero()"),
        ("torch.unique(out[0])", ".unique()"),
        ("torch.masked_select(out, out > 0)", ".masked_select()"),
        ("n = int(out.sum())", "int(.sum())"),
        ("n = float(out.max())", "float(.max())"),
        ("n = bool(out.any())", "bool(.any())"),
        ("live = out[:, out[1] > 0]", "a boolean-mask index"),
        ("out[~(out > 0)] = 0", "a boolean-mask index"),
        ("np.asarray(out)", "np.asarray()"),
    ])
    def test_each_primitive_is_flagged(self, take_src, stmt, what):
        src = _after_launch("import numpy as np\n" + take_src, stmt)
        f = lint.lint_sources({TAKE: src})
        assert [x.check for x in f] == ["PTL002"]
        assert f[0].message.startswith(f"host-device sync {what} inside take_n()")

    @pytest.mark.parametrize("test", ["if out.any():\n        pass", "while not out.all():\n        pass"])
    def test_a_branch_on_any_or_all_is_flagged(self, take_src, test):
        f = lint.lint_sources({TAKE: _after_launch(take_src, test)})
        assert [x.check for x in f] == ["PTL002"]
        assert "a branch on ." in f[0].message

    @pytest.mark.parametrize("stmt", [
        "n = int(out.numel())", "n = int(pn.shape[0])", "out[:, 0:2] = 0", "k = bool(k)",
    ])
    def test_host_scalars_are_not_syncs(self, take_src, stmt):
        assert lint.lint_sources({TAKE: _after_launch(take_src, stmt)}) == []

    def test_through_the_call_graph_and_across_modules(self):
        helper = "def pull(x):\n    return x.cpu()\n"
        wrapper = (
            f"from {PKG}.ops import _build\nfrom {PKG}.ops.helper import pull\n\n"
            "def launch(x):\n    pull(x)\n    _build.count_launch('k')\n"
        )
        f = lint.lint_sources({f"{PKG}/ops/helper.py": helper, f"{PKG}/ops/k.py": wrapper})
        assert [(x.path, x.line) for x in f] == [(f"{PKG}/ops/helper.py", 2)]
        assert f[0].message.endswith("(reachable from a launch root via launch)")

    def test_a_declared_boundary_is_not_entered(self):
        # take_n_plain is declared in SYNC_BOUNDARIES: the plain version
        # may sync, and the walk never enters it.
        src = (
            "def take_n_plain(x):\n    return x.tolist()\n\n"
            "def take_n(x):\n    take_n_plain(x)\n    _build.count_launch('take_n')\n"
        )
        assert lint.lint_sources({TAKE: src}) == []
        # The same function under a name the table does not declare is.
        other = src.replace("take_n_plain", "helper")
        assert [x.line for x in lint.lint_sources({TAKE: other})] == [2]

    def test_a_declared_extra_root_is_walked(self):
        src = "def run_pieces(state):\n    return state.pn.sum().item()\n"
        f = lint.lint_sources({f"{PKG}/parallel/topology.py": src})
        assert [(x.check, x.line) for x in f] == [("PTL002", 2)]

    def test_suppressible_inline(self, take_src):
        src = _after_launch(take_src, "out.cpu()  # patrol-lint: disable=PTL002")
        assert lint.lint_sources({TAKE: src}) == []


class TestLaunchSyncCuda:
    def test_a_sync_in_the_entry_is_flagged_on_its_line(self, take_src, take_cu):
        guard = "  if (K <= 0) return 0;\n"
        i = take_cu.index('extern "C" int patrol_take_n(')
        j = take_cu.index(guard, i) + len(guard)
        cu = take_cu[:j] + "  cudaDeviceSynchronize();\n" + take_cu[j:]
        f = lint.lint_sources({TAKE: take_src}, {TAKE_CU: cu})
        line = cu[:j].count("\n") + 1
        assert [(x.check, x.path, x.line) for x in f] == [("PTL002", TAKE_CU, line)]
        assert f[0].message == (
            'blocking CUDA call cudaDeviceSynchronize() inside extern "C" patrol_take_n(), '
            "which take_n() launches through ctypes")

    def test_the_shipped_entry_is_clean(self, take_src, take_cu):
        assert lint.lint_sources({TAKE: take_src}, {TAKE_CU: take_cu}) == []

    @pytest.mark.parametrize("call,hit", [
        ("cudaMemcpy(a, b, 8, cudaMemcpyDeviceToHost)", True),
        ("cudaDeviceSynchronize()", True),
        ("cudaStreamSynchronize(s)", True),
        ("cudaEventSynchronize(e)", True),
        ("cudaMalloc(&p, 8)", True),
        ("cudaFree(p)", True),
        ("cudaMemcpyAsync(a, b, 8, cudaMemcpyDeviceToHost, s)", False),
        ("cudaMallocAsync(&p, 8, s)", False),
        ("cudaFreeAsync(p, s)", False),
        ("// cudaDeviceSynchronize()", False),
        ("/* cudaFree(p) */", False),
    ])
    def test_each_blocking_call(self, call, hit):
        py = "def launch(x):\n    lib().patrol_k(x)\n    _build.count_launch('k')\n"
        cu = (
            "__global__ void k_kernel() {}\n"
            "static int helper() { cudaDeviceSynchronize(); return 0; }\n"
            'extern "C" int patrol_k(void* x) {\n'
            f"  {call};\n"
            "  return (int)cudaGetLastError();\n"
            "}\n"
        )
        f = lint.lint_sources({f"{PKG}/ops/k.py": py}, {f"{PKG}/csrc/k.cu": cu})
        assert [(x.path, x.line) for x in f] == ([(f"{PKG}/csrc/k.cu", 4)] if hit else [])

    def test_a_launch_into_a_missing_entry_is_flagged(self, take_src):
        f = lint.lint_sources({TAKE: take_src}, {})
        assert [(x.check, x.path) for x in f] == [("PTL002", TAKE)]
        assert "patrol_take_n, which no extern \"C\" entry" in f[0].message

    def test_every_entry_a_root_launches_is_found(self):
        entries = lint.cuda_entries(lint.repo_cuda_sources(str(REPO)))
        assert set(entries) == {
            "patrol_join", "patrol_take_n", "patrol_decode_fold", "patrol_row_rmw",
            "patrol_lifecycle_probe", "patrol_cert_occupancy", "patrol_cert_fused",
            "patrol_converge",
        }
        for name, (rel, text, start, end) in entries.items():
            assert text[start:end].rstrip().endswith("}"), name
            assert f"{name}(" in text[start:end], name


class TestLaunchRootsOnTheTree:
    @pytest.fixture(scope="class")
    def mods(self):
        srcs = lint.repo_sources(str(REPO))
        return [lint.Module(p, s) for p, s in sorted(srcs.items())]

    def test_roots_are_every_count_launch_caller_and_run_step(self, mods):
        roots = lint._launch_roots(mods, lint._FuncIndex(mods))
        assert roots == {
            (f"{PKG}/ops/take_kernel.py", "take_n"),
            (f"{PKG}/ops/lifecycle_kernel.py", "probe"),
            (f"{PKG}/ops/ingest_kernel.py", "decode_fold"),
            (f"{PKG}/ops/converge_kernel.py", "_launch"),
            (f"{PKG}/ops/join_kernel.py", "_launch"),
            (f"{PKG}/ops/row_rmw_kernel.py", "row_rmw"),
            (f"{PKG}/ops/cert_kernel.py", "fused"),
            (f"{PKG}/parallel/topology.py", "run_pieces"),
        }
        callers = {
            p for p in (REPO / PKG).rglob("*.py")
            if "_build.count_launch(" in p.read_text() and p.name != "_build.py"
        }
        assert {REPO / r for r, _ in roots} >= callers

    def test_the_mesh_root_reaches_the_wrappers_past_their_cpu_branches(self, mods):
        # converge_kernel.gather launches through _launch and is no root
        # itself: run_pieces walks (through _step_front) into
        # its card path, not its CPU branch.
        rel = f"{PKG}/ops/converge_kernel.py"
        card = '    _launch(1, "mesh_gather", pn, elapsed, rows, spn, sel)\n'
        cpu = "        gather_plain(pn, elapsed, rows, spn, sel)\n"
        srcs = {m.relpath: m.source for m in mods}
        src = srcs[rel]
        assert src.count(card) == 1 and src.count(cpu) == 1
        srcs[rel] = src.replace(card, "    rows.cpu()\n" + card).replace(
            cpu, "        rows.tolist()\n" + cpu)
        f = lint.lint_sources(srcs)
        assert [(x.path, x.line, x.message) for x in f] == [(
            rel, _line_of(srcs[rel], "    rows.cpu()\n"),
            "host-device sync .cpu() inside gather(), which is on a CUDA kernel's launch "
            "path (reachable from a launch root via _step_front)",
        )]


# ---------------------------------------------------------------------------
# PTL004 in torch's spelling.

MERGE = f"{PKG}/ops/merge.py"


class TestTorchDtypes:
    @pytest.mark.parametrize("expr,n", [
        ("torch.zeros(2, 3)", 1),
        ("torch.zeros(2, 3, dtype=torch.int64)", 0),
        ("torch.arange(k)", 1),
        ("torch.arange(k, dtype=torch.int64)", 0),
        ("torch.full((k,), 1)", 1),
        ("torch.tensor([1, 2])", 1),
        ("torch.empty(k, dtype=torch.int32)", 0),
        ("torch.ones(k, device=d)", 1),
        ("x.to(torch.float32)", 1),
        ("x.to(torch.half)", 1),
        ("x.double()", 1),
        ("np.zeros(k, np.int64)", 0),
        ("np.zeros(k)", 1),
    ])
    def test_constructor_and_dtype_spellings(self, expr, n):
        src = f"import numpy as np\nimport torch\n\ndef f(k, x, d):\n    return {expr}\n"
        f = lint.lint_sources({MERGE: src})
        assert [x.check for x in f] == ["PTL004"] * n

    def test_the_merge_arange_repair(self):
        # ops/merge.py's gather index had no dtype: the line as it was is
        # flagged, the shipped file is clean.
        shipped = (REPO / MERGE).read_text()
        fixed = "    ar = torch.arange(rows.numel(), dtype=torch.int64, device=rows.device)\n"
        assert shipped.count(fixed) == 1
        old = shipped.replace(fixed, "    ar = torch.arange(rows.numel(), device=rows.device)\n")
        f = lint.lint_sources({MERGE: old})
        assert [(x.check, x.line) for x in f] == [("PTL004", _line_of(shipped, fixed))]
        assert lint.lint_sources({MERGE: shipped}) == []


# ---------------------------------------------------------------------------
# PTL005: the repairs.


class TestCounterRepairs:
    def test_the_ring_table_names_every_j_as_the_f_string_did(self):
        from patrol_tpu_torch.runtime import engine as engine_mod

        table = engine_mod.COMMIT_RING_COUNTERS
        for i, name in enumerate(table):
            j = 1 << i
            assert table[min(j.bit_length(), len(table)) - 1] == f"commit_ring_j{j}"
        assert len(table) == 17 and set(table) <= lint.known_counter_names()

    def test_a_literal_table_is_checked_entry_by_entry(self):
        src = (
            "NAMES = ('commit_ring_j1', 'no_such_counter')\n\n"
            "def f(i):\n    COUNTERS.inc(NAMES[i])\n"
        )
        f = lint.lint_sources({f"{PKG}/x.py": src})
        assert [(x.check, x.line) for x in f] == [("PTL005", 4)]
        assert "'no_such_counter'" in f[0].message
        ok = src.replace("'no_such_counter'", "'commit_ring_j2'")
        assert lint.lint_sources({f"{PKG}/x.py": ok}) == []
        computed = "NAMES = [f'x{i}' for i in range(2)]\n\ndef f(i):\n    COUNTERS.inc(NAMES[i])\n"
        assert "non-literal" in lint.lint_sources({f"{PKG}/x.py": computed})[0].message

    def test_the_engine_s_counters_are_declared(self):
        known = lint.known_counter_names()
        assert {"ingest_raw_hosted_dispatches", "ingest_raw_hosted_absorbed",
                "take_device_tickets", "commit_ring_j1", "commit_ring_j65536",
                "commit_dispatches", "trace_anomaly_snapshots"} <= known
        engine = (REPO / PKG / "runtime" / "engine.py").read_text()
        assert 'COUNTERS.inc(f"' not in engine

    def test_a_ring_commit_counts_its_j_and_vars_are_zero_filled(self, monkeypatch):
        from patrol_tpu_torch.models.limiter import LimiterConfig
        from patrol_tpu_torch.runtime import engine as engine_mod
        from patrol_tpu_torch.utils import profiling

        monkeypatch.setattr(engine_mod, "MAX_MERGE_ROWS", 8)
        eng = engine_mod.DeviceEngine(LimiterConfig(buckets=64, nodes=2), node_slot=0, device="cpu")
        try:
            snap = profiling.COUNTERS.snapshot()
            assert all(f"commit_ring_j{1 << i}" in snap for i in range(17))
            before = profiling.COUNTERS.get("commit_ring_j4")
            n = 20
            deltas = engine_mod.DeltaArrays(
                np.arange(n, dtype=np.int64), np.zeros(n, np.int64),
                np.full(n, 5, np.int64), np.zeros(n, np.int64),
                np.zeros(n, np.int64), np.zeros(n, bool),
            )
            eng._commit_coalesced(deltas)  # 20 pairs in rings of 8: J = 4
            assert profiling.COUNTERS.get("commit_ring_j4") == before + 1
            pn, _ = eng.read_rows(np.arange(n, dtype=np.int64))
            assert (pn[:, 0, 0] == 5).all()
        finally:
            eng.stop()


# ---------------------------------------------------------------------------
# The tables, the markers and the tree.


class TestTablesAndTree:
    @pytest.fixture(scope="class")
    def index(self):
        srcs = lint.repo_sources(str(REPO))
        mods = [lint.Module(p, s) for p, s in sorted(srcs.items())]
        return lint._FuncIndex(mods)

    @pytest.mark.parametrize("table", ["CLOCK_SEAMS", "DTYPE_BOUNDARIES", "SYNC_BOUNDARIES",
                                       "LAUNCH_ROOTS"])
    def test_every_row_names_a_function_of_the_port(self, index, table):
        rows = getattr(lint, table)
        assert rows
        for rel, names in rows.items():
            assert rel.startswith(f"{PKG}/") and (REPO / rel).is_file(), rel
            for name in names:
                assert (rel, name) in index.funcs, (table, rel, name)

    def test_dtype_files_and_config_seam_exist(self):
        for rel in [*lint.DTYPE_FILES, lint._CONFIG_SEAM]:
            assert (REPO / rel).is_file(), rel

    def test_registries_load_from_the_port(self):
        assert "PATROL_MAX_MERGE_ROWS" in lint.known_knob_names()
        assert len(lint.known_knob_names()) >= 30
        assert "trace_captures" in lint.known_counter_names()  # port-only

    @pytest.mark.parametrize("rel", [
        f"{PKG}/net/api.py", f"{PKG}/utils/pprof.py", f"{PKG}/utils/logging.py",
    ])
    def test_each_clock_seam_marker_is_needed(self, rel):
        src = (REPO / rel).read_text()
        marked = [i for i, ln in enumerate(src.splitlines(), 1) if "patrol-lint: clock-seam" in ln]
        assert marked
        mod = lint.Module(rel, src)
        assert lint.check_wall_clock(mod) == []
        assert {(ln, "clock-seam") for ln in marked} <= mod.used
        bare = re.sub(r"  # patrol-lint: clock-seam[^\n]*", "", src)
        assert [x.line for x in lint.check_wall_clock(lint.Module(rel, bare))] == marked

    def test_the_engine_clock_offset_is_its_declared_seam(self):
        src = (REPO / PKG / "runtime" / "engine.py").read_text()
        assert "time.time_ns()" in src
        mod = lint.Module(f"{PKG}/runtime/engine.py", src)
        assert lint.check_wall_clock(mod) == []
        saved = lint.CLOCK_SEAMS.pop(f"{PKG}/runtime/engine.py")
        try:
            f = lint.check_wall_clock(mod)
        finally:
            lint.CLOCK_SEAMS[f"{PKG}/runtime/engine.py"] = saved
        assert [x.message.split("(in ")[1][:-1].split(")")[0] for x in f] == ["DeviceEngine.__init__"]

    def test_the_port_lints_clean(self):
        findings = lint.lint_repo(str(REPO))
        assert findings == [], "\n".join(map(str, findings))
