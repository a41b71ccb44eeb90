"""The port's bucket lifecycle layer against the JAX package, exactly.

* The op: ``patrol_tpu_torch.ops.lifecycle.lifecycle_probe`` on a CPU
  state (the kernel's plain version) against JAX ``lifecycle_probe``
  (jitted, x64, the CPU backend) on the same seeded inputs: every verdict
  case (full, spent, over capacity, zero rate, capacity-0 padding, ``now``
  before ``created + elapsed``, int64-wrapping sums, fp64 refill edges),
  lane counts N in {1, 4, 31, 33, 64}, ``node_slot`` at its edges, rows
  {-B-1, -1, 0, B-1, B}, K from 0 to 2^20; all four outputs equal. The
  numpy twins are held to the JAX package's; the output buffer's layout
  (the engine's one-copy readback) is pinned. The CUDA kernel is held to
  the plain version on the card by ``chip_smoke.py`` (phase 2).
* Engine twins of ``tests/test_lifecycle.py``'s ``TestGcSweep``,
  ``TestTombstoneConservation`` and ``TestMemoryBudget``: each scenario
  runs on a JAX engine and a port engine (Python lanes, and the C++ store
  of ``runtime/hoststore.py``); results, the bound set, tombstones and
  planes must be equal.
* A randomized law over takes, batch takes, lane deltas, raw dv2 planes,
  clock steps, sweeps and budget changes, through both packages.
* The native front: a take the C++ front serves while a sweep reclaims
  its bucket is never lost, and a shed through the front's pump answers as
  the JAX node's does.

The feeder's GC cadence is off under test (``PATROL_GC_WINDOW_MS=0`` in
tests/conftest.py), so sweeps run where a test calls them. Tolerance:
exact equality everywhere.
"""

import socket
import threading
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from patrol_tpu.models.limiter import LimiterConfig as JConfig
from patrol_tpu.models.limiter import LimiterState as JState
from patrol_tpu.ops import lifecycle as jlife
from patrol_tpu.ops import wire as jwire
from patrol_tpu.ops.rate import Rate as JRate
from patrol_tpu.runtime.directory import OverloadedError as JOverloaded
from patrol_tpu.runtime.engine import DeviceEngine as JEngine
from patrol_tpu.utils import profiling as jprofiling
from patrol_tpu.utils import slo as jslo
from patrol_tpu_torch import native
from patrol_tpu_torch.models.limiter import NANO, LimiterConfig, LimiterState
from patrol_tpu_torch.ops import lifecycle as tlife
from patrol_tpu_torch.ops import wire as twire
from patrol_tpu_torch.ops.rate import Rate
from patrol_tpu_torch.runtime.directory import OverloadedError as TOverloaded
from patrol_tpu_torch.runtime.engine import DeviceEngine
from patrol_tpu_torch.utils import profiling as tprofiling
from patrol_tpu_torch.utils import slo as tslo
from test_torch_native_hls import _probe

B = 64


# -- the op ------------------------------------------------------------------


def probe_inputs(rng, n, k=96, b=B):
    """State and K candidates, K/8 of each verdict case (see module doc)."""
    pn = rng.integers(0, NANO // 8, (b, n, 2), dtype=np.int64)
    el = rng.integers(0, 50 * NANO, b, dtype=np.int64)
    rows = rng.integers(0, b, k).astype(np.int32)
    now = 1000 * NANO + rng.integers(0, 100 * NANO, k)
    per = rng.choice([NANO, 3 * NANO + 1, 60 * NANO], k)
    cap = rng.choice([1, 10, 1000], k) * NANO
    created = rng.integers(0, 500 * NANO, k)
    case = np.arange(k) % 8
    for i in range(k):
        r = rows[i]
        if case[i] == 0:  # full: two periods since the last refill
            el[r] = 0
            created[i] = now[i] - 2 * per[i]
        elif case[i] == 1:  # spent: no time since the last refill
            created[i] = now[i] - el[r]
            pn[r, :, 1] += NANO // max(n, 1)
        elif case[i] == 2:  # over capacity: merged grants past it
            pn[r, :, 0] += NANO
        elif case[i] == 3:  # zero rate: per 0, or a capacity under a token
            if i % 16 < 8:
                per[i] = 0
            else:
                cap[i] = int(rng.integers(1, NANO))
        elif case[i] == 4:  # capacity-0 padding
            cap[i] = 0
        elif case[i] == 5:  # now before created + elapsed
            created[i] = now[i] + 1
        elif case[i] == 6:  # int64-wrapping sums
            pn[r] = rng.integers(1 << 61, 1 << 62, (n, 2))
        else:  # fp64 edge: grant within a nanotoken of the distance
            interval = int(rng.choice([1, 3, 7, 999_999_937, 10**12 + 39]))
            cap[i], per[i], created[i], el[r] = NANO, interval, 0, 0
            now[i] = interval * int(rng.choice([1, 3, 10**6 + 1])) + int(rng.integers(-1, 2))
            grant = int(np.floor(now[i] / np.float64(interval) * NANO))
            pn[r] = 0
            pn[r, 0, 1] = grant + int(rng.integers(-1, 2))
    cols = np.stack([rows.astype(np.int64), now, per, cap, created]).astype(np.int64)
    return pn, el, cols


def run_probe(pn, el, cols, slot):
    """→ (jax outputs, port outputs), each four numpy arrays."""
    jv = jlife.lifecycle_probe_jit(
        JState(jnp.asarray(pn), jnp.asarray(el)),
        jlife.LifecycleProbe(jnp.asarray(cols[0].astype(np.int32)),
                             *(jnp.asarray(c) for c in cols[1:])),
        slot,
    )
    tv = tlife.lifecycle_probe(
        LimiterState(torch.from_numpy(pn.copy()), torch.from_numpy(el.copy())),
        tlife.LifecycleProbe(torch.from_numpy(cols[0].astype(np.int32)),
                             *(torch.from_numpy(c.copy()) for c in cols[1:])),
        slot,
    )
    return [np.asarray(x) for x in jv], [x.numpy() for x in tv]


def assert_probe_equal(pn, el, cols, slot):
    jo, to = run_probe(pn, el, cols, slot)
    for name, a, b in zip(tlife.LifecycleView._fields, jo, to):
        assert b.dtype == a.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    return jo


@pytest.mark.parametrize("n", [1, 4, 31, 33, 64])
def test_probe_matches_reference_on_every_case(n):
    rng = np.random.default_rng(100 + n)
    pn, el, cols = probe_inputs(rng, n)
    verdicts = set()
    for slot in sorted({0, n - 1} | ({31, 32} & set(range(n)))):
        full = assert_probe_equal(pn, el, cols, slot)[0]
        verdicts |= set(full.tolist())
    assert verdicts == {False, True}  # the corpus is not one-sided


def test_probe_row_index_semantics_match_reference():
    """Rows in [-B, 0) wrap, the rest clamp into [0, B), as a JAX gather
    does; padding (capacity 0) still gathers its row's own lane."""
    rng = np.random.default_rng(7)
    pn, el, cols = probe_inputs(rng, 4, k=16)
    cols[0, :5] = [-B - 1, -1, 0, B - 1, B]
    assert_probe_equal(pn, el, cols, 3)
    cols[3, :] = 0  # all padding: never full, lanes still gathered
    jo = assert_probe_equal(pn, el, cols, 0)
    assert not jo[0].any()


@pytest.mark.parametrize("k", [0, 1, 8, 8192, 1 << 20])
def test_probe_matches_reference_at_every_launch_size(k):
    """K from none to the engine's ``_pad_size`` bound (2^20): the kernel
    launches one block per 32 candidates and none at K = 0; its plain
    version is held to the reference at each K (the corpus repeated)."""
    rng = np.random.default_rng(11)
    pn, el, cols = probe_inputs(rng, 33)
    cols = np.ascontiguousarray(np.tile(cols, (1, -(-k // cols.shape[1])))[:, :k])
    jo = assert_probe_equal(pn, el, cols, 32)
    assert all(x.shape == (k,) for x in jo)


def test_output_buffer_layout_is_unchanged():
    """One buffer of 25 bytes a candidate: own_added, own_taken and
    elapsed as int64[K] each, then full as one byte a candidate, as the
    engine's one-copy readback (``_probe_device_rows``) splits it."""
    from patrol_tpu_torch.ops import lifecycle_kernel as lk

    for k in (0, 1, 8, 8192, 1 << 20):
        assert lk.output_bytes(k) == 25 * k
    k = 24
    vals = np.arange(3 * k, dtype=np.int64) - 7
    full = np.arange(k) % 3 == 0
    raw = np.concatenate([vals.view(np.uint8), full.astype(np.uint8)])
    for buf in (raw.copy(), torch.from_numpy(raw.copy())):
        got = lk.split_outputs(buf, k)
        for part, want in zip(got, (full, vals[:k], vals[k:2 * k], vals[2 * k:])):
            np.testing.assert_array_equal(np.asarray(part), want)
    # The views alias the buffer (the readback is the only copy).
    buf = torch.from_numpy(raw.copy())
    lk.split_outputs(buf, k)[1][0] = 99
    assert buf[:8].view(torch.int64)[0] == 99


def test_kernel_wrapper_refuses_a_cpu_state():
    """The wrapper launches on CUDA tensors or raises; the op takes the
    plain version for a CPU state (the tests above), never the wrapper."""
    from patrol_tpu_torch.ops import lifecycle_kernel as lk

    pn = torch.zeros((4, 2, 2), dtype=torch.int64)
    cols = [torch.zeros(3, dtype=torch.int64) for _ in range(5)]
    with pytest.raises(ValueError, match="CUDA"):
        lk.probe(pn, torch.zeros(4, dtype=torch.int64), *cols, 0)


@settings(max_examples=40, deadline=None)
@given(
    st.integers(1, 40),
    st.data(),
)
def test_probe_matches_reference_hypothesis(n, data):
    seed = data.draw(st.integers(0, 2**32 - 1))
    rng = np.random.default_rng(seed)
    pn, el, cols = probe_inputs(rng, n, k=16)
    cols[1] = data.draw(st.lists(st.integers(0, 1 << 62), min_size=16, max_size=16))
    cols[2] = data.draw(st.lists(st.integers(0, 1 << 40), min_size=16, max_size=16))
    slot = data.draw(st.integers(0, n - 1))
    assert_probe_equal(pn, el, cols, slot)


@pytest.mark.parametrize("twin", ["host_lifecycle_full", "host_reconstructed_nt"])
def test_numpy_twins_match_reference(twin):
    rng = np.random.default_rng(3)
    pn, el, cols = probe_inputs(rng, 4, k=256)
    rows = cols[0]
    args = (pn[rows, :, 0].sum(-1), pn[rows, :, 1].sum(-1), el[rows], cols[3], cols[4])
    for now in (int(cols[1][0]), 0, 1 << 62):
        want = getattr(jlife, twin)(*args, now, cols[2])
        got = getattr(tlife, twin)(*args, now, cols[2])
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    # And the device verdict agrees with the twin on the same rows.
    full = run_probe(pn, el, cols, 0)[1][0]
    assert (tlife.host_lifecycle_full(*args, cols[1], cols[2]) == full).all()


# -- engine twins of tests/test_lifecycle.py -----------------------------------

CFG = (64, 4)
JAX = types.SimpleNamespace(
    name="jax", Rate=JRate, wire=jwire, Overloaded=JOverloaded,
    profiling=jprofiling, slo=jslo,
)
PORT = types.SimpleNamespace(
    name="port", Rate=Rate, wire=twire, Overloaded=TOverloaded,
    profiling=tprofiling, slo=tslo,
)


class Clock:
    def __init__(self, now=1000 * NANO):
        self.now = now

    def __call__(self):
        return self.now


def make_engine(pkg, lanes, clock, **cfg):
    if pkg is JAX:
        eng = JEngine(JConfig(*CFG), node_slot=0, clock=clock)
    else:
        if lanes == "native" and native.load() is None:
            pytest.skip("the native host library does not build here")
        eng = DeviceEngine(LimiterConfig(*CFG), node_slot=0, clock=clock, device="cpu",
                           native_host=lanes == "native")
        assert (eng._native_store is not None) == (lanes == "native")
    if cfg:
        eng.configure_lifecycle(**cfg)
    return eng


def state_of(eng):
    assert eng.flush(30)
    pn, el = eng.snapshot_planes()
    d = eng.directory
    return {
        "rows": dict(d._rows),
        "tombstones": {k: tuple(int(x) for x in v) for k, v in d.export_tombstones().items()},
        "pn": pn, "elapsed": el,
        "created": {r: int(d.created_ns[r]) for r in d._rows.values()},
    }


def assert_same_state(js, ts):
    assert ts["rows"] == js["rows"]
    assert ts["tombstones"] == js["tombstones"]
    assert ts["created"] == js["created"]
    np.testing.assert_array_equal(ts["pn"], js["pn"])
    np.testing.assert_array_equal(ts["elapsed"], js["elapsed"])


def twin(scenario, lanes, **cfg):
    """Run ``scenario(pkg, eng, clock)`` on a JAX engine and a port engine;
    results and end states must be equal. → the port's result."""
    out = []
    for pkg in (JAX, PORT):
        clock = Clock()
        eng = make_engine(pkg, lanes, clock, **cfg)
        try:
            res = scenario(pkg, eng, clock)
            out.append((res, state_of(eng)))
        finally:
            eng.stop()
    (jres, js), (tres, ts) = out
    assert tres == jres
    assert_same_state(js, ts)
    return tres


LANES = ["python", "native"]


def rate(pkg):
    return pkg.Rate(freq=10, per_ns=NANO)  # 10 tokens/s, capacity 10


def take(pkg, eng, name, count, r=None):
    try:
        return tuple(eng.take(name, r or rate(pkg), count))
    except pkg.Overloaded:
        return "overloaded"


@pytest.mark.parametrize("lanes", LANES)
class TestGcSweep:
    def test_spent_bucket_is_not_reclaimed(self, lanes):
        def sc(pkg, eng, clock):
            take(pkg, eng, "a", 3)
            eng.flush()
            return eng.gc_sweep(force=True), eng.directory.lookup("a")

        assert twin(sc, lanes) == (0, 0)

    def test_refilled_bucket_reclaims_from_device_and_directory(self, lanes):
        def sc(pkg, eng, clock):
            take(pkg, eng, "a", 3)
            take(pkg, eng, "b", 10)
            eng.flush()
            clock.now += 10 * NANO
            n = eng.gc_sweep(force=True)
            st_ = eng.lifecycle_stats()
            return (n, len(eng.directory), eng.directory.lookup("a"),
                    st_["engine_gc_reclaimed"], st_["engine_gc_tombstones"])

        assert twin(sc, lanes) == (2, 0, None, 2, 2)

    def test_idle_gate_holds_without_pressure(self, lanes):
        def sc(pkg, eng, clock):
            take(pkg, eng, "a", 1)
            eng.flush()
            clock.now += 10 * NANO
            take(pkg, eng, "warm", 1)
            eng.flush()
            return (eng.gc_sweep(), eng.directory.lookup("a"),
                    eng.directory.lookup("warm") is not None)

        assert twin(sc, lanes, idle_ms=1000) == (1, None, True)

    def test_reclaim_is_observation_equivalent(self, lanes):
        rng = np.random.default_rng(7)
        names = [f"u{i}" for i in range(12)]
        ops = []
        t = 1000 * NANO
        for _ in range(150):
            t += int(rng.integers(0, 3 * NANO))
            ops.append((names[int(rng.integers(0, len(names)))], t, int(rng.integers(1, 4))))

        def run(gc):
            def sc(pkg, eng, clock):
                out = []
                for i, (name, now, count) in enumerate(ops):
                    clock.now = now
                    out.append(take(pkg, eng, name, count)[:2])
                    if gc and i % 10 == 9:
                        eng.flush()
                        eng.gc_sweep(force=True)
                eng.flush()
                return out, eng.lifecycle_stats()["engine_gc_reclaimed"]
            return sc

        res_gc, reclaimed = twin(run(True), lanes)
        clock = Clock()
        eng = make_engine(PORT, lanes, clock)
        try:
            res_ref, _ = run(False)(PORT, eng, clock)
        finally:
            eng.stop()
        assert res_gc == res_ref
        assert reclaimed > 0, "schedule never exercised a reclaim"

    def test_hosted_bucket_reclaims_via_numpy_twin(self, lanes):
        def sc(pkg, eng, clock):
            take(pkg, eng, "h", 2)
            hosted = eng.hosted_buckets
            clock.now += 5 * NANO
            return hosted, eng.gc_sweep(force=True), eng.hosted_buckets, eng.directory.lookup("h")

        assert twin(sc, lanes) == (1, 1, 0, None)

    def test_free_list_compaction_reuses_lowest_rows(self, lanes):
        def sc(pkg, eng, clock):
            for i in range(8):
                take(pkg, eng, f"k{i}", 1)
            eng.flush()
            clock.now += 10 * NANO
            n = eng.gc_sweep(force=True)
            row, _ = eng.assign_row("fresh", clock.now)
            return n, row, eng.lifecycle_stats()["engine_gc_compactions"] >= 1

        assert twin(sc, lanes) == (8, 0, True)


@pytest.mark.parametrize("lanes", LANES)
class TestTombstoneConservation:
    def test_reseed_restores_own_lane_and_clock(self, lanes):
        def sc(pkg, eng, clock):
            take(pkg, eng, "a", 3)
            eng.flush()
            created0 = int(eng.directory.created_ns[eng.directory.lookup("a")])
            clock.now += 10 * NANO
            n = eng.gc_sweep(force=True)
            got = take(pkg, eng, "a", 1)
            eng.flush()
            row = eng.directory.lookup("a")
            pn, el = eng.row_view(row)
            return (n, got, int(eng.directory.created_ns[row]) == created0,
                    int(pn[0, 1]), int(pn[0, 0]))

        assert twin(sc, lanes) == (1, (9, True, True), True, 4 * NANO, 3 * NANO)

    def test_stale_echo_cannot_erase_post_reclaim_spend(self, lanes):
        def sc(pkg, eng, clock):
            take(pkg, eng, "a", 3)
            eng.flush()
            clock.now += 10 * NANO
            n = eng.gc_sweep(force=True)
            got = take(pkg, eng, "a", 2)[:2]
            eng.flush()
            eng.ingest_delta(
                pkg.wire.from_nanotokens(
                    "a", 10 * NANO, 3 * NANO, 0, origin_slot=0, cap_nt=10 * NANO,
                    lane_added_nt=0, lane_taken_nt=3 * NANO,
                ),
                slot=0,
            )
            eng.flush()
            return n, got, eng.tokens("a")

        assert twin(sc, lanes) == (1, (8, True), 8)

    def test_replication_recreation_reseeds(self, lanes):
        def sc(pkg, eng, clock):
            take(pkg, eng, "a", 3)
            eng.flush()
            clock.now += 10 * NANO
            n = eng.gc_sweep(force=True)
            eng.ingest_delta(
                pkg.wire.from_nanotokens(
                    "a", 12 * NANO, 2 * NANO, 0, origin_slot=2, cap_nt=10 * NANO,
                    lane_added_nt=2 * NANO, lane_taken_nt=2 * NANO,
                ),
                slot=2,
            )
            eng.flush()
            pn, _ = eng.row_view(eng.directory.lookup("a"))
            return n, int(pn[0, 1]), int(pn[2, 1])

        assert twin(sc, lanes) == (1, 3 * NANO, 2 * NANO)


@pytest.mark.parametrize("lanes", LANES)
class TestMemoryBudget:
    def test_hard_watermark_sheds_new_names_only(self, lanes):
        def sc(pkg, eng, clock):
            shed0 = pkg.profiling.COUNTERS.get("gc_pressure_shed")
            for i in range(4):
                take(pkg, eng, f"u{i}", 5)
            out = (take(pkg, eng, "new", 1), take(pkg, eng, "u0", 1))
            return (*out, pkg.profiling.COUNTERS.get("gc_pressure_shed") > shed0,
                    eng.lifecycle_stats()["engine_gc_shed"])

        assert twin(sc, lanes, max_buckets=4, window_ms=0) == ("overloaded", (4, True, False), True, 1)

    def test_pressure_sweep_frees_before_shedding(self, lanes):
        def sc(pkg, eng, clock):
            for i in range(4):
                take(pkg, eng, f"u{i}", 5)
            clock.now += 10 * NANO
            return take(pkg, eng, "new", 1)

        assert twin(sc, lanes, max_buckets=4, window_ms=0) == (9, True, True)

    def test_batch_path_sheds_per_request(self, lanes):
        def sc(pkg, eng, clock):
            for i in range(4):
                take(pkg, eng, f"u{i}", 5)
            res = eng.submit_takes_batch(["u0", "brand-new", "u1"], [rate(pkg)] * 3, [1, 1, 1])
            out = []
            for t, created in res:
                assert t.wait(5)
                out.append((t.ok, t.remaining, created, t.shed))
            return out

        assert twin(sc, lanes, max_buckets=4, window_ms=0) == [
            (True, 4, False, False), (False, 0, False, True), (True, 4, False, False),
        ]

    def test_byte_budget_accounting_and_sentinel_breach(self, lanes):
        def sc(pkg, eng, clock):
            take(pkg, eng, "a", 5)
            in_use = eng.state_bytes_in_use()
            shed = take(pkg, eng, "b", 1)
            breaches = pkg.slo.SENTINEL.check()
            return in_use, shed, "budget" in [b["kind"] for b in breaches]

        in_use, shed, breached = twin(sc, lanes, bytes_budget=500, window_ms=0)
        assert in_use >= 500 and shed == "overloaded" and breached

    def test_sentinel_unregisters_on_stop(self, lanes):
        for pkg in (JAX, PORT):
            eng = make_engine(pkg, lanes, Clock(), max_buckets=2)
            assert pkg.slo.SENTINEL._budget_src is not None
            eng.stop()
            assert pkg.slo.SENTINEL._budget_src is None


# -- the randomized law --------------------------------------------------------

NAMES = [f"n{i}" for i in range(12)]
RATES = {n: (int(f), int(p)) for n, f, p in zip(
    NAMES, [3, 10, 1, 5] * 3, [NANO, NANO, 2 * NANO, 3 * NANO] * 3)}


def law_ops(seed, steps=120):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(steps):
        kind = rng.choice(["take", "batch", "delta", "raw", "step", "sweep", "budget"],
                          p=[0.35, 0.1, 0.12, 0.08, 0.15, 0.12, 0.08])
        if kind == "take":
            ops.append(("take", NAMES[rng.integers(len(NAMES))], int(rng.integers(1, 4))))
        elif kind == "batch":
            k = int(rng.integers(1, 5))
            ops.append(("batch", [NAMES[i] for i in rng.integers(0, len(NAMES), k)],
                        [int(c) for c in rng.integers(1, 3, k)]))
        elif kind in ("delta", "raw"):
            k = int(rng.integers(1, 4))
            ents = [(NAMES[int(rng.integers(len(NAMES)))], int(rng.integers(1, 4)),
                     int(rng.integers(0, 2 * NANO)), int(rng.integers(0, 4 * NANO)),
                     int(rng.integers(0, 2 * NANO))) for _ in range(k)]
            ops.append((kind, ents))
        elif kind == "step":
            ops.append(("step", int(rng.integers(0, 3 * NANO))))
        elif kind == "sweep":
            ops.append(("sweep", bool(rng.random() < 0.5)))
        else:
            ops.append(("budget", int(rng.choice([0, 5, 8]))))
    return ops


def run_law(pkg, eng, clock, ops):
    out = []
    for op in ops:
        kind = op[0]
        if kind == "take":
            f, p = RATES[op[1]]
            out.append(take(pkg, eng, op[1], op[2], pkg.Rate(freq=f, per_ns=p)))
        elif kind == "batch":
            rates = [pkg.Rate(freq=RATES[n][0], per_ns=RATES[n][1]) for n in op[1]]
            res = eng.submit_takes_batch(op[1], rates, op[2])
            row = []
            for t, created in res:
                assert t.wait(5)
                row.append((t.remaining, t.ok, created, t.shed))
            out.append(row)
        elif kind == "delta":
            for name, slot, a, t, _e in op[1]:
                out.append(eng.ingest_delta(pkg.wire.from_nanotokens(
                    name, a, t, 0, origin_slot=slot, cap_nt=RATES[name][0] * NANO,
                    lane_added_nt=a, lane_taken_nt=t), slot=slot))
        elif kind == "raw":
            ents = [pkg.wire.DeltaEntry(name, slot, RATES[name][0] * NANO, a, t, e)
                    for name, slot, a, t, e in op[1]]
            data, n = pkg.wire.encode_delta_packet(1, 7, [], ents, max_size=2048)
            planes = np.zeros((1, 2048), np.uint8)
            planes[0, :len(data)] = np.frombuffer(data, np.uint8)
            out.append(eng.ingest_raw_planes(planes, np.array([len(data)], np.int32)))
        elif kind == "step":
            clock.now += op[1]
        elif kind == "sweep":
            out.append(eng.gc_sweep(force=op[1]))
        else:
            eng.configure_lifecycle(max_buckets=op[1])
        assert eng.flush(30)
    st_ = eng.lifecycle_stats()
    out.append({k: st_[k] for k in ("engine_gc_reclaimed", "engine_gc_shed",
                                     "engine_gc_sweeps", "engine_gc_tombstones",
                                     "engine_buckets_bound")})
    return out


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_randomized_law_matches_reference(lanes, seed):
    ops = law_ops(seed)
    res = twin(lambda pkg, eng, clock: run_law(pkg, eng, clock, ops), lanes, window_ms=0)
    stats = res[-1]
    assert stats["engine_gc_reclaimed"] > 0, "the schedule never reclaimed"


# -- the native front -----------------------------------------------------------


def probe_take(eng, name, r, count, now):
    """The C++ in-front take path at an explicit clock; → 1 admitted,
    0 limited, -1 not served in front."""
    got = _probe(eng, name, r, count, now)
    return -1 if got is None else int(got[1])


def own_taken(eng, name):
    """This node's own TAKEN lane of a bucket, live or tombstoned."""
    row = eng.directory.lookup(name)
    if row is not None:
        return int(eng.row_view(row)[0][0, 1])
    tomb = eng.directory.export_tombstones().get(name)
    return int(tomb[1]) if tomb else 0


def test_in_front_take_in_the_reclaim_window_is_never_lost():
    """A C++ in-front take that lands after the sweep probed its bucket and
    before the reclaim unbinds it (the window is entered deterministically:
    the take runs on a thread started from inside ``reclaim_rows``) either
    keeps the bucket or misses it; its spend is never dropped. A denied
    take at the same clock value stamped the row first, so the reclaim's
    ``last_used_ns`` check cannot see the second take."""
    clock = Clock()
    eng = make_engine(PORT, "native", clock)
    r = rate(PORT)
    try:
        eng.take("a", r, 3)
        clock.now += 10 * NANO
        assert probe_take(eng, "a", r, 100, clock.now) == 0  # denied, stamps
        d = eng.directory
        orig = d.reclaim_rows
        rcs, threads = [], []

        def reclaim_with_a_take_in_the_window(*args):
            t = threading.Thread(target=lambda: rcs.append(probe_take(eng, "a", r, 1, clock.now)))
            threads.append(t)
            t.start()
            t.join(0.3)  # the take runs now, unless the sweep holds the store's lock
            d.reclaim_rows = orig
            return orig(*args)

        d.reclaim_rows = reclaim_with_a_take_in_the_window
        eng.gc_sweep(force=True)
        threads[0].join(5)
        assert rcs and rcs[0] in (-1, 1)
        admitted = 3 + (1 if rcs[0] == 1 else 0)
        assert own_taken(eng, "a") == admitted * NANO
    finally:
        eng.stop()


def test_in_front_takes_racing_sweeps_conserve_spend():
    """Threads drive the C++ take path (admitted and denied takes, each at
    the current clock value) while sweeps reclaim and takes on the Python
    path bind reclaimed names again: every admitted take's spend ends in
    its bucket's live own lane or in its tombstone."""
    clock = Clock()
    eng = make_engine(PORT, "native", clock)
    r = rate(PORT)
    names = [f"r{i}" for i in range(16)]
    admitted = {n: 0 for n in names}
    mu = threading.Lock()
    stop = threading.Event()

    def front(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            n = names[int(rng.integers(8))]  # the rest only see Python takes
            # A denied take (count 100) stamps the row and commits nothing.
            if probe_take(eng, n, r, int(rng.choice([1, 100])), clock.now) == 1:
                with mu:
                    admitted[n] += 1

    try:
        for n in names:
            eng.take(n, r, 1)
            admitted[n] += 1
        threads = [threading.Thread(target=front, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 3.0
        reclaimed = 0
        while time.monotonic() < deadline:
            clock.now += 2 * NANO  # everything refills
            reclaimed += eng.gc_sweep(force=True)
            for n in names[1::3]:
                _rem, ok, _c = eng.take(n, r, 1)
                with mu:
                    admitted[n] += int(ok)
        stop.set()
        for t in threads:
            t.join(10)
            assert not t.is_alive()
        assert reclaimed > 0
        for n in names:
            assert own_taken(eng, n) == admitted[n] * NANO, n
    finally:
        stop.set()
        eng.stop()


def test_native_front_shed_answers_as_the_reference():
    """At the hard watermark a new name's take through the native front's
    pump (and a /take_batch line for one) answers as the JAX node's native
    front does for the same shed."""
    import http.client

    from patrol_tpu import native as jnative
    from patrol_tpu.command import Command as JCommand
    from patrol_tpu_torch.command import Command as TCommand
    from test_torch_api import Node, _free_port

    if native.load() is None or jnative.load() is None:
        pytest.skip("a native host library does not build here")
    script = [
        "/take/a?rate=5:1h", "/take/b?rate=5:1h", "/take/c?rate=5:1h", "/take/a?rate=5:1h",
        "/take_batch?t=a,5:1h,1&t=d,5:1h,1", "/take/b?rate=5:1h&count=2",
    ]

    def drive(cmd, port):
        cmd.engine.configure_lifecycle(max_buckets=2, window_ms=0)
        got = []
        for path in script:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
            conn.request("POST", path, headers={"Connection": "close"})
            resp = conn.getresponse()
            got.append((resp.status, resp.read()))
            conn.close()
        return got, cmd.engine.lifecycle_stats()["engine_gc_shed"]

    out = []
    for pkg in ("jax", "port"):
        udp = f"127.0.0.1:{_free_port(socket.SOCK_DGRAM)}"
        if pkg == "jax":
            port = _free_port()
            cmd = JCommand(api_addr=f"127.0.0.1:{port}", node_addr=udp, clock=Clock(),
                           config=JConfig(256, 8), handle_signals=False,
                           udp_backend="asyncio", http_front="native")
        else:
            cmd = TCommand(api_addr="127.0.0.1:0", node_addr=udp, clock=Clock(),
                           config=LimiterConfig(256, 8), handle_signals=False, device="cpu",
                           udp_backend="asyncio", http_front="native")
        node = Node(cmd)
        try:
            assert cmd.engine._native_store is not None
            out.append(drive(cmd, port if pkg == "jax" else cmd.api_port))
        finally:
            node.close()
    assert out[1] == out[0]
    (got, shed) = out[1]
    assert got[2][0] == 429 and shed >= 2
