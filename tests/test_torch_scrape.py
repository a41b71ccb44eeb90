"""The port's scrape mirror: stats and debug reads of device rows from an
epoch-stamped host copy.

The three cases of ``tests/test_dispatch.py``'s ``TestScrapeMirror`` on
the port's engine (steady-state scrapes cost no device gather and equal a
direct gather; a take invalidates the mirror; ``SCRAPE_MIRROR`` off
gathers every time). Then a differential: the port's engine and the JAX
engine (host lanes on, a low promotion threshold) run through every
mutating entry point — takes, rx deltas, raw dv2 ingest, promotion,
demotion, eviction, GC reclaim, ``release_bucket`` and the three
certified families — and after each one ``snapshot``,
``tokens_if_known`` and ``row_view`` of every name and row must equal the
JAX engine's, and on device rows a direct ``read_rows``. Each step starts
from a mirror armed at the current epoch, so a write that skips its
epoch bump serves a stale scrape and fails here. Checkpoint restore is
checked on the port alone: the JAX package's restore moves no epoch, so
its mirror serves the pre-restore state (shown below); the port's moves
it. Tolerance: exact equality.
"""

import dataclasses
import tempfile

import numpy as np
import pytest

from patrol_tpu.models.limiter import LimiterConfig as JConfig
from patrol_tpu.ops import wire as jwire
from patrol_tpu.ops.rate import Rate as JRate
from patrol_tpu.runtime import checkpoint as jckpt
from patrol_tpu.runtime import engine as jengine_mod
from patrol_tpu_torch.models.limiter import NANO, LimiterConfig
from patrol_tpu_torch.ops import wire as twire
from patrol_tpu_torch.ops.rate import Rate
from patrol_tpu_torch.runtime import checkpoint as tckpt
from patrol_tpu_torch.runtime import engine as engine_mod
from patrol_tpu_torch.runtime.engine import DeviceEngine
from patrol_tpu_torch.utils import profiling


class Clock:
    def __init__(self, now=1000 * NANO):
        self.now = now

    def __call__(self):
        return self.now


def _drive(eng, names, rate):
    for n in names:
        _, ok, _ = eng.take(n, rate, 1)
        assert ok
    assert eng.flush(timeout=30)


class TestScrapeMirror:
    def test_steady_state_scrape_is_gather_free_and_exact(self, monkeypatch):
        monkeypatch.setattr(engine_mod, "HOST_FASTPATH", False)
        eng = DeviceEngine(LimiterConfig(buckets=32, nodes=2), node_slot=0, device="cpu")
        rate = Rate(freq=1000, per_ns=0)
        names = [f"b{i}" for i in range(4)]
        try:
            _drive(eng, names, rate)
            g0 = profiling.COUNTERS.get("scrape_device_gathers")
            h0 = profiling.COUNTERS.get("scrape_mirror_hits")
            rows = [eng.directory.lookup(n) for n in names]
            ref_pn, ref_el = eng.read_rows(np.array(rows, np.int32))
            for _ in range(25):
                for i, row in enumerate(rows):
                    pn, el = eng.row_view(row)
                    assert np.array_equal(pn, ref_pn[i])
                    assert int(el) == int(ref_el[i])
            assert profiling.COUNTERS.get("scrape_device_gathers") == g0
            assert profiling.COUNTERS.get("scrape_mirror_hits") >= h0 + 100
        finally:
            eng.stop()

    def test_mutation_invalidates_the_mirror(self, monkeypatch):
        monkeypatch.setattr(engine_mod, "HOST_FASTPATH", False)
        eng = DeviceEngine(LimiterConfig(buckets=16, nodes=2), node_slot=0, device="cpu")
        rate = Rate(freq=1000, per_ns=0)
        try:
            _drive(eng, ["m0"], rate)
            before = eng.tokens("m0")
            _, ok, _ = eng.take("m0", rate, 1)
            assert ok
            assert eng.flush(timeout=30)
            assert eng.tokens("m0") == before - 1
        finally:
            eng.stop()

    def test_mirror_disabled_falls_back_to_gathers(self, monkeypatch):
        monkeypatch.setattr(engine_mod, "HOST_FASTPATH", False)
        monkeypatch.setattr(engine_mod, "SCRAPE_MIRROR", False)
        eng = DeviceEngine(LimiterConfig(buckets=16, nodes=2), node_slot=0, device="cpu")
        rate = Rate(freq=1000, per_ns=0)
        try:
            _drive(eng, ["d0"], rate)
            g0 = profiling.COUNTERS.get("scrape_device_gathers")
            row = eng.directory.lookup("d0")
            eng.row_view(row)
            eng.row_view(row)
            assert profiling.COUNTERS.get("scrape_device_gathers") == g0 + 2
        finally:
            eng.stop()


# -- every mutating entry point, against the JAX engine ----------------------

B, N = 64, 4
NAMES = [f"s{i}" for i in range(12)]


def views(eng, names):
    """Every scrape surface: per name the snapshot (as field tuples) and
    the balance, per row ``row_view``."""
    snaps = {n: [dataclasses.astuple(s) for s in eng.snapshot(n)] for n in names}
    many = {n: [dataclasses.astuple(s) for s in v] for n, v in eng.snapshot_many(names).items()}
    toks = {n: eng.tokens_if_known(n) for n in names}
    rows = [eng.row_view(r) for r in range(B)]
    return snaps, many, toks, [(pn.tolist(), int(el)) for pn, el in rows]


def check_views(jeng, teng, names, step):
    jv, tv = views(jeng, names), views(teng, names)
    assert tv[0] == jv[0], f"{step}: snapshot"
    assert tv[1] == jv[1], f"{step}: snapshot_many"
    assert tv[2] == jv[2], f"{step}: tokens_if_known"
    assert tv[3] == jv[3], f"{step}: row_view"
    dev = [r for r in range(B) if not teng._hosted_flag[r]]
    pn, el = teng.read_rows(np.array(dev, np.int64))
    for i, r in enumerate(dev):
        assert tv[3][r] == (pn[i].tolist(), int(el[i])), f"{step}: row_view({r}) != read_rows"
    # The next step starts from a mirror armed at this epoch, and only an
    # epoch move may invalidate it (no completer refresh pending).
    teng._mirror_want = False


def raw_planes(pkg, ents):
    data, _ = pkg.encode_delta_packet(1, 7, [], ents, max_size=2048)
    planes = np.zeros((1, 2048), np.uint8)
    planes[0, :len(data)] = np.frombuffer(data, np.uint8)
    return planes, np.array([len(data)], np.int32)


def scenario(eng, clock, pkg_wire, rate_cls):
    """→ a generator of (step name, names to scrape) after each mutation."""
    r10 = rate_cls(freq=10, per_ns=NANO)
    for n in NAMES[:6]:
        eng.take(n, r10, 2)  # host lanes (fresh buckets)
    yield "takes", NAMES
    hot = rate_cls(freq=1000, per_ns=NANO)
    for _ in range(engine_mod.HOST_PROMOTE_TAKES + 4):
        eng.take("hot", hot, 1)
    yield "promotion", NAMES + ["hot"]
    eng.take("hot", hot, 3)  # a device-path take (take-n)
    yield "device take", NAMES + ["hot"]
    for n, slot in (("s6", 1), ("s7", 2), ("s0", 3)):
        eng.ingest_delta(pkg_wire.from_nanotokens(
            n, 4 * NANO, 3 * NANO, 5, origin_slot=slot, cap_nt=10 * NANO,
            lane_added_nt=4 * NANO, lane_taken_nt=3 * NANO), slot=slot)
    yield "rx deltas", NAMES + ["hot"]
    ents = [pkg_wire.DeltaEntry(n, 2, 10 * NANO, NANO, 2 * NANO, 7) for n in ("s8", "s9", "s1")]
    planes, lengths = raw_planes(pkg_wire, ents)
    eng.ingest_raw_planes(planes, lengths)
    yield "raw ingest", NAMES + ["hot"]
    eng.gcra_take(np.arange(40, 48), clock.now, 100, 300, 4)
    eng.conc_acquire(np.arange(44, 52), 9, 2, 3, 1)
    eng.quota_take([60] * 4, [61, 61, 62, 62], [40, 41, 50, 63], 9, 5, 4, 1, 2)
    yield "families", NAMES + ["hot"]
    clock.now += engine_mod.HOST_DEMOTE_WINDOW_NS + 1
    eng.take("hot", hot, 1)  # ends the demote window: gather, zero, host lanes
    yield "demotion", NAMES + ["hot"]
    assert eng.release_bucket("s6")
    yield "release_bucket", NAMES + ["hot"]
    clock.now += 30 * NANO
    eng.gc_sweep(force=True)
    yield "gc reclaim", NAMES + ["hot"]
    eng.gcra_take([40, 41], clock.now, 100, 300, 2)
    eng.conc_acquire([44, 44], 9, 2, 1, 5)
    yield "families again", NAMES + ["hot"]
    fill = [f"e{i}" for i in range(B - len(eng.directory))]
    for n in fill:
        eng.ingest_delta(pkg_wire.from_nanotokens(
            n, 0, NANO, 0, origin_slot=1, cap_nt=10 * NANO,
            lane_added_nt=0, lane_taken_nt=NANO), slot=1)
    yield "full directory", NAMES + ["hot"] + fill
    # A take of a new name on a full pool evicts (zeroes) a swath of rows
    # and is served from host lanes: no tick follows the zeroing.
    eng.take("new", r10, 1)
    yield "eviction", NAMES + ["hot", "new"] + fill


def test_every_mutation_moves_the_scrape_epoch(monkeypatch):
    for mod in (engine_mod, jengine_mod):
        monkeypatch.setattr(mod, "HOST_PROMOTE_TAKES", 8)
    jclock, tclock = Clock(), Clock()
    jeng = jengine_mod.DeviceEngine(JConfig(B, N), node_slot=0, clock=jclock)
    teng = DeviceEngine(LimiterConfig(B, N), node_slot=0, clock=tclock, device="cpu")
    try:
        runs = zip(scenario(jeng, jclock, jwire, JRate), scenario(teng, tclock, twire, Rate))
        steps = []
        for (jstep, names), (tstep, _) in runs:
            assert jstep == tstep
            assert jeng.flush(30) and teng.flush(30)
            check_views(jeng, teng, names, tstep)
            steps.append(tstep)
        assert steps[-1] == "eviction"
        assert teng.promotions == 1 and teng.demotions == 1
        assert teng.lifecycle_stats()["engine_gc_reclaimed"] > 0 and teng.evictions > 0
        assert profiling.COUNTERS.get("scrape_mirror_hits") > 0
    finally:
        jeng.stop()
        teng.stop()


def test_restore_moves_the_scrape_epoch(monkeypatch):
    """A restore joins saved planes into a live engine outside any tick:
    the port's next scrape shows the restored spend. The JAX engine's
    restore moves no epoch, and its mirror serves the pre-restore
    balance (the reference's defect, kept there as it is)."""
    monkeypatch.setattr(engine_mod, "HOST_FASTPATH", False)
    monkeypatch.setattr(jengine_mod, "HOST_FASTPATH", False)
    out = {}
    for pkg, make, rate_cls, ckpt in (
        ("jax", lambda: jengine_mod.DeviceEngine(JConfig(16, 2), node_slot=0), JRate, jckpt),
        ("port", lambda: DeviceEngine(LimiterConfig(16, 2), node_slot=0, device="cpu"),
         Rate, tckpt),
    ):
        live, saved = make(), make()
        r = rate_cls(freq=10, per_ns=NANO)
        try:
            live.take("x", r, 1)
            saved.take("x", r, 5)
            assert live.flush(30) and saved.flush(30)
            d = tempfile.mkdtemp()
            ckpt.save(d, saved)
            before = live.tokens("x"), live.row_view(0)[0].tolist()
            ckpt.restore(d, live)
            direct = live.read_rows(np.array([0], np.int32))[0][0].tolist()
            out[pkg] = before, (live.tokens("x"), live.row_view(0)[0].tolist()), direct
        finally:
            live.stop()
            saved.stop()
    before, after, direct = out["port"]
    assert before[0] == 9 and after == (5, direct)
    jbefore, jafter, jdirect = out["jax"]
    assert jafter == jbefore and jdirect == direct  # stale scrape, right planes


@pytest.mark.parametrize("window", [0, 2])
def test_rows_past_the_window_gather(monkeypatch, window):
    """Rows at or past ``PATROL_SCRAPE_MIRROR_ROWS`` are gathered one call
    each; rows inside are mirrored."""
    monkeypatch.setattr(engine_mod, "HOST_FASTPATH", False)
    monkeypatch.setattr(engine_mod, "SCRAPE_MIRROR_ROWS", window)
    eng = DeviceEngine(LimiterConfig(buckets=16, nodes=2), node_slot=0, device="cpu")
    try:
        _drive(eng, ["w0", "w1", "w2", "w3"], Rate(freq=100, per_ns=0))
        g0 = profiling.COUNTERS.get("scrape_device_gathers")
        h0 = profiling.COUNTERS.get("scrape_mirror_hits")
        for row in range(4):
            pn, el = eng.row_view(row)
            ref_pn, ref_el = eng.read_rows([row])
            assert pn.tolist() == ref_pn[0].tolist() and el == int(ref_el[0])
        assert profiling.COUNTERS.get("scrape_mirror_hits") - h0 == min(window, 4)
        assert profiling.COUNTERS.get("scrape_device_gathers") - g0 == 4 - min(window, 4)
    finally:
        eng.stop()
