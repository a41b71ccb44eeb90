"""The port's race stage (``patrol_tpu_torch/analysis/race.py``) against
the JAX package's, and its own tables, on the CPU.

**Against the reference.** Every test of ``tests/test_race.py`` that runs
the static half on a fixture runs here with the reference's
``race_static`` recording its arguments and findings. Each recorded
call, its paths re-keyed from ``patrol_tpu`` to ``patrol_tpu_torch`` (the
shipped registries it was handed mapped to the port's, fixture
registries converted entry by entry, and the declared lock order the
reference's where the fixture left it to the default), goes through the
port's ``race_static`` and must give the same codes, paths, lines and
messages. The seam explorer gives the reference's state counts and
findings for every builtin scenario under the clean laws and under each
seeded mutation; a finding's line is each package's ``pt_http_poll``
definition in its own ``patrol_http.cpp``.

**The port's own.** The stage is clean on the port's tree; every table
row names a file, class, method or attribute of the port; each of the
seven ``*_locked`` holders the port added is what keeps its PTR003
findings away; the port-only guards (the scrape epoch, its refresh
hint, the mesh engine's epoch) and ``_resize_mu``'s place in the lock
order have teeth; and the scrape mirror's refresh hint is not lost to a
scrape that races the completer's refresh (ROADMAP C7). Exact
comparisons only: tolerance zero.
"""

import ast
import importlib.util
import inspect
import re
import threading
from pathlib import Path

import pytest

from patrol_tpu.analysis import race as ref_race
from patrol_tpu_torch.analysis import race
from patrol_tpu_torch.analysis.lint import Module

pytestmark = pytest.mark.race

REPO = Path(__file__).resolve().parent.parent
PKG = "patrol_tpu_torch"
_FIX = f"{PKG}/fixture.py"


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_ref_{name}", REPO / "tests" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_REF = _load("test_race")


def _fixture_cases():
    out = []
    for cname, cls in sorted(vars(_REF).items()):
        if not (cname.startswith("Test") and inspect.isclass(cls)):
            continue
        for mname, fn in sorted(vars(cls).items()):
            if not (mname.startswith("test_") and callable(fn)):
                continue
            src = inspect.getsource(fn)
            if ("_static(" in src or "race_static(" in src) and "REPO_ROOT" not in src:
                out.append((cname, mname))
    return out


CASES = _fixture_cases()


def rekey(text: str) -> str:
    return re.sub(r"\bpatrol_tpu\b", PKG, text)


def _rows(findings):
    return [(f.check, rekey(f.path), f.line, rekey(f.message)) for f in findings]


def _port_registry(reg, shipped_ref, shipped_port, convert=lambda v: v):
    """A recorded registry argument in the port's terms."""
    if reg is None or reg is shipped_ref:
        return shipped_port
    return {rekey(p): {k: convert(v) for k, v in per.items()} for p, per in reg.items()}


def _guards(attrs):
    return {a: race.Guard(g.lock, g.mode) for a, g in attrs.items()}


def _replay(args, kwargs):
    sig = inspect.signature(ref_race.race_static).bind(*args, **kwargs)
    a = sig.arguments
    return race.race_static(
        {rekey(p): rekey(s) for p, s in a["sources"].items()},
        guards=_port_registry(a.get("guards"), ref_race.GUARDS, race.GUARDS, _guards),
        holders=_port_registry(a.get("holders"), ref_race.HOLDERS, race.HOLDERS),
        aliases=_port_registry(a.get("aliases"), ref_race.LOCK_ALIASES, race.LOCK_ALIASES),
        retained=_port_registry(a.get("retained"), ref_race.RETAINED_BUFFERS,
                                race.RETAINED_BUFFERS),
        effects=a.get("effects"),
        declared_order=a.get("declared_order", ref_race.DECLARED_ORDER),
    )


@pytest.mark.parametrize("case", CASES, ids=["::".join(c) for c in CASES])
def test_reference_fixture_gives_the_reference_findings(case, monkeypatch):
    cname, mname = case
    calls = []
    real = ref_race.race_static

    def race_static(*args, **kwargs):
        found = real(*args, **kwargs)
        calls.append((args, kwargs, found))
        return found

    monkeypatch.setattr(ref_race, "race_static", race_static)
    getattr(getattr(_REF, cname)(), mname)()
    monkeypatch.undo()
    assert calls, f"{cname}.{mname} ran no fixture"
    for args, kwargs, found in calls:
        assert _rows(_replay(args, kwargs)) == _rows(found)


def test_the_recorded_fixtures_cover_every_static_check():
    names = {c for c, _ in CASES}
    assert {"TestGuardedState", "TestLockGraph", "TestCondvarLoops", "TestOwnership",
            "TestMeshGuardCoverage", "TestRxRingGuardCoverage", "TestGcGuardCoverage",
            "TestMembershipGuardCoverage", "TestEngineCondvarRegression"} <= names
    assert len(CASES) >= 35


# ---------------------------------------------------------------------------
# The seam explorer.


def _anchor(pkg):
    lines = (REPO / pkg / "native" / "patrol_http.cpp").read_text().splitlines()
    return next(i for i, ln in enumerate(lines, 1) if ln.lstrip().startswith("int pt_http_poll("))


SEMANTICS = [("clean", race.SEAM_CLEAN, ref_race.SEAM_CLEAN)] + [
    (name, race.SEAM_MUTATIONS[name][0], ref_race.SEAM_MUTATIONS[name][0])
    for name in ref_race.SEAM_MUTATIONS
]


@pytest.mark.parametrize("sem", SEMANTICS, ids=[s[0] for s in SEMANTICS])
@pytest.mark.parametrize("scenario", [s.name for s in ref_race.builtin_seam_scenarios()])
def test_explore_seam_matches_the_reference(scenario, sem):
    _, port_sem, ref_sem = sem
    port_sc = next(s for s in race.builtin_seam_scenarios() if s.name == scenario)
    ref_sc = next(s for s in ref_race.builtin_seam_scenarios() if s.name == scenario)
    assert port_sc == race.SeamScenario(ref_sc.name, ref_sc.conns, ref_sc.script, ref_sc.poll_cap)
    assert port_sem == race.SeamSemantics(**vars(ref_sem))
    n_port, f_port = race.explore_seam(port_sc, port_sem)
    n_ref, f_ref = ref_race.explore_seam(ref_sc, ref_sem)
    assert n_port == n_ref
    assert [(f.check, f.path, f.message) for f in f_port] == [
        (f.check, rekey(f.path), f.message) for f in f_ref]
    assert {f.line for f in f_port} <= {_anchor(PKG)}
    assert {f.line for f in f_ref} <= {_anchor("patrol_tpu")}


def test_the_seam_model_is_the_reference_s():
    assert race.SEAM_MUTATIONS.keys() == ref_race.SEAM_MUTATIONS.keys()
    assert {k: v[1] for k, v in race.SEAM_MUTATIONS.items()} == {
        "completion-before-park": "PTR001",
        "ring-slot-reuse-without-fence": "PTR002",
        "ack-without-holding-mutex": "PTR002",
    }
    total = sum(race.explore_seam(sc)[0] for sc in race.builtin_seam_scenarios())
    assert total == 157
    assert race.check_seam_repo() == []


def test_an_unregistered_mutation_would_be_reported(monkeypatch):
    monkeypatch.setitem(race.SEAM_MUTATIONS, "no-op-mutation", (race.SEAM_CLEAN, "PTR002"))
    findings = race.check_seam_repo()
    assert [(f.check, f.path) for f in findings] == [("PTR002", race._SELF)]
    assert "'no-op-mutation' was NOT rejected" in findings[0].message


def test_the_port_s_seam_entry_points_are_the_reference_s():
    """The model's two entry points are the reference's line for line in
    the port's front (it differs only by the C2 read-cap repair)."""
    def body(pkg, sig):
        text = (REPO / pkg / "native" / "patrol_http.cpp").read_text()
        i = text.index(sig)
        return text[i:text.index("\n}\n", i)]

    for sig in ("int pt_http_poll(", "int pt_http_complete_takes("):
        assert body(PKG, sig) == body("patrol_tpu", sig), sig
    comp = body(PKG, "int pt_http_complete_takes(")
    assert "std::lock_guard<std::mutex> lk(s->mu);" in comp
    assert "if (c.fd < 0 || c.gen != gen) continue;" in comp
    assert "c.gen++;" in (REPO / PKG / "native" / "patrol_http.cpp").read_text()


# ---------------------------------------------------------------------------
# The port's tree and tables.


@pytest.fixture(scope="module")
def sources():
    return race.race_sources(str(REPO))


def test_the_port_proves_clean():
    assert race.race_repo(str(REPO)) == []


def test_the_race_files_are_the_port_s(sources):
    assert set(race.GRAPH_FILES) == set(sources)
    assert all(p.startswith(f"{PKG}/") for p in race.GRAPH_FILES)
    assert (race._SELF, race._HTTP_CPP, race._NATIVE_INIT) == (
        f"{PKG}/analysis/race.py", f"{PKG}/native/patrol_http.cpp", f"{PKG}/native/__init__.py")
    for rel in (race._SELF, race._HTTP_CPP, race._NATIVE_INIT):
        assert (REPO / rel).is_file()


def _classes(src):
    return {n.name: n for n in ast.walk(ast.parse(src)) if isinstance(n, ast.ClassDef)}


def test_every_guard_names_a_real_attribute_and_lock(sources):
    for relpath, per_cls in race.GUARDS.items():
        classes = {k: ast.dump(v) for k, v in _classes(sources[relpath]).items()}
        for cls, attrs in per_cls.items():
            assert cls in classes, f"{relpath}: no class {cls}"
            for attr, guard in attrs.items():
                assert f"attr='{attr}'" in classes[cls], (relpath, cls, attr)
                assert f"attr='{guard.lock}'" in classes[cls], (relpath, cls, guard.lock)


@pytest.mark.parametrize("table", ["HOLDERS", "LOCK_ALIASES", "RETAINED_BUFFERS"])
def test_every_row_names_something_of_the_port(sources, table):
    for relpath, rows in getattr(race, table).items():
        classes = _classes(sources[relpath])
        for key, val in rows.items():
            if table == "HOLDERS":
                cls, meth = key.split(".")
                assert any(isinstance(n, ast.FunctionDef) and n.name == meth
                           for n in classes[cls].body), (relpath, key)
            else:
                dump = ast.dump(classes[key])
                for attr in val:
                    assert f"attr='{attr}'" in dump, (relpath, key, attr)


def test_the_lock_graph_sees_the_engines_edges(sources):
    mods = [Module(rp, s) for rp, s in sorted(sources.items())]
    edges = {}
    takes = race._native_takes_host_mu()

    def record(s, d, rp, ln):
        edges.setdefault((s, d), (rp, ln))

    for m in mods:
        for cls, methods in race._class_methods(m.tree).items():
            for mname, fn in methods.items():
                held = tuple(race.HOLDERS.get(m.relpath, {}).get(f"{cls}.{mname}", ()))
                race._walk_lock_edges(fn, m, cls, race.LOCK_ALIASES, takes, record, held)
    for edge in [("_evict_mu", "_host_mu"), ("_evict_mu", "_state_mu"),
                 ("_host_mu", "_state_mu"), ("_resize_mu", "_state_mu"),
                 ("_resize_mu", f"{PKG}/runtime/mesh_engine.py::MeshEngine._cond")]:
        assert edge in edges, edge
    assert race.DECLARED_ORDER == ("_resize_mu", "_evict_mu", "_host_mu", "_state_mu")


PORT_HOLDERS = [
    (f"{PKG}/native/__init__.py", "RxRing._release_if_done_locked", 2),
    (f"{PKG}/net/delta.py", "DeltaPlane._on_ack_locked", 1),
    (f"{PKG}/runtime/engine.py", "DeviceEngine._drop_hosted_rows_locked", 4),
]


@pytest.mark.parametrize("rel,method,n", PORT_HOLDERS, ids=[m for _, m, _ in PORT_HOLDERS])
def test_each_port_holder_is_what_keeps_its_findings_away(sources, rel, method, n):
    holders = {p: dict(rows) for p, rows in race.HOLDERS.items()}
    assert holders[rel].pop(method) == (race.HOLDERS[rel][method][0],)
    f = race.race_static(sources, holders=holders)
    assert [x.check for x in f] == ["PTR003"] * n
    assert all(f"in {method}()" in x.message for x in f)


def test_each_holder_s_callers_hold_its_lock(sources):
    """The contract the holder rows quote: every call of each port-added
    holder sits inside a `with self.<lock>` (or another holder of it)."""
    for rel, method, _ in PORT_HOLDERS:
        cls, meth = method.split(".")
        lock = race.HOLDERS[rel][method][0]
        mod = Module(rel, sources[rel])
        calls = 0
        for caller, fn in race._class_methods(mod.tree)[cls].items():
            held = race._held_at(fn, rel, cls, {})
            parents = {id(c): p for p in ast.walk(fn) for c in ast.iter_child_nodes(p)}
            for node in ast.walk(fn):
                if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                        and node.func.attr == meth):
                    calls += 1
                    cur = node
                    while id(cur) not in held:
                        cur = parents[id(cur)]
                    assert (race._canon_lock(rel, cls, lock, {}) in held[id(cur)]
                            or lock in race.HOLDERS[rel].get(f"{cls}.{caller}", ())), (method, caller)
        assert calls >= 2, method


# ---------------------------------------------------------------------------
# The port-only guards have teeth.


def _seeded(src, rel):
    return race.race_static({rel: src}, guards=race.GUARDS, holders={}, aliases={},
                            retained={}, effects={})


ENGINE = f"{PKG}/runtime/engine.py"
MESH = f"{PKG}/runtime/mesh_engine.py"


def test_an_unlocked_scrape_epoch_bump_is_flagged():
    src = (
        "import threading\n"
        "class DeviceEngine:\n"
        "    def __init__(self):\n"
        "        self._state_mu = threading.Lock()\n"
        "        self._state_gen = 0\n"
        "    def release(self):\n"
        "        with self._state_mu:\n"
        "            pass\n"
        "        self._state_gen += 1\n"
    )
    # An augmented store is two accesses (the store and the augment),
    # as in the reference.
    f = _seeded(src, ENGINE)
    assert [(x.check, x.line) for x in f] == [("PTR003", 9)] * 2
    assert "self._state_gen" in f[0].message and "_state_mu" in f[0].message
    fixed = src.replace("            pass\n        self._state_gen += 1\n",
                        "            self._state_gen += 1\n")
    assert _seeded(fixed, ENGINE) == []
    assert [x.line for x in _seeded(src.replace("DeviceEngine", "MeshEngine"), MESH)] == [9] * 2


def test_the_refresh_hint_rides_the_completion_condvar():
    src = (
        "import threading\n"
        "class DeviceEngine:\n"
        "    def __init__(self):\n"
        "        self._pcond = threading.Condition()\n"
        "        self._mirror_want = False\n"
        "    def _scrape_rows(self):\n"
        "        if not self._mirror_want:\n"
        "            self._mirror_want = True\n"
    )
    f = _seeded(src, ENGINE)
    assert [(x.check, x.line) for x in f] == [("PTR003", 8)]
    fixed = src.replace("            self._mirror_want = True\n",
                        "            with self._pcond:\n                self._mirror_want = True\n")
    assert _seeded(fixed, ENGINE) == []


def test_resize_mu_is_outermost():
    src = (
        "import threading\n"
        "class MeshEngine:\n"
        "    def __init__(self):\n"
        "        self._resize_mu = threading.Lock()\n"
        "        self._state_mu = threading.Lock()\n"
        "    def bad(self):\n"
        "        with self._state_mu:\n"
        "            with self._resize_mu:\n"
        "                pass\n"
    )
    f = race.race_static({MESH: src}, guards={}, holders={}, aliases={}, retained={}, effects={})
    assert [(x.check, x.line) for x in f] == [("PTR004", 8)]
    assert "declared order is _resize_mu -> _evict_mu -> _host_mu -> _state_mu" in f[0].message


def test_the_engine_condvars_are_seen(sources):
    mod = Module(ENGINE, sources[ENGINE])
    assert race._condvar_attrs(mod.tree).get("DeviceEngine") == {"_cond", "_pcond"}
    assert race.check_condvar_loops(mod) == []


# ---------------------------------------------------------------------------
# C7: the scrape mirror's refresh hint survives a racing scrape.


def test_a_scrape_racing_the_completer_refresh_keeps_its_hint(monkeypatch):
    """A scrape that finds the mirror stale while the completer refreshes
    it raises the hint; the completer must not clear it afterwards (it
    clears before its gather), so the next completion refreshes again."""
    from patrol_tpu_torch.models.limiter import NANO, LimiterConfig
    from patrol_tpu_torch.ops.rate import Rate
    from patrol_tpu_torch.runtime import engine as engine_mod

    monkeypatch.setattr(engine_mod, "HOST_FASTPATH", False)
    eng = engine_mod.DeviceEngine(LimiterConfig(buckets=16, nodes=2), node_slot=0,
                                  device="cpu", clock=lambda: 1000 * NANO)
    real = eng._refresh_scrape_mirror
    real_wanted = eng._refresh_wanted_mirror
    done = threading.Event()
    during, after = [], []

    def refresh_with_a_racing_scrape():
        real()
        if not during:
            # A scrape thread, mid-gather, finds the mirror stale again.
            during.append(eng._mirror_want)
            with eng._pcond:
                eng._mirror_want = True

    def wanted():
        real_wanted()
        if not done.is_set():
            after.append(eng._mirror_want)
            done.set()

    try:
        eng._refresh_scrape_mirror = refresh_with_a_racing_scrape
        eng._refresh_wanted_mirror = wanted
        with eng._pcond:
            eng._mirror_want = True
        _, ok, _ = eng.take("a", Rate(freq=5, per_ns=3600 * NANO), 1)
        assert ok and done.wait(30)
        assert during == [False]  # cleared before the gather
        assert after == [True]  # the racing scrape's hint survived it
    finally:
        eng.stop()
