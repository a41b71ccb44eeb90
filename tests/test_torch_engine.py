"""The port's DeviceEngine against the JAX package's, end to end.

One frozen-clock trace — peer deltas of every wire kind (lane trailers,
cap-only aggregates, v1 scalars, raw lanes, an out-of-range slot, a
hot-row storm that the tick fold commits as dense rows), single and
batched takes with a Zipf-like hot-key crowd, a clock step, more deltas
and takes — runs through the JAX ``DeviceEngine`` (host fast path off, so
every take rides the device queue) and the port's engine on the CPU.
Ticket outcomes, ``created`` flags, capacity bases and the final planes
(read back with ``state_to_numpy``) must be identical, with the rx-time
take fold on and off, the tick fold on and off, and a small merge block
that forces multi-block drains through the coalesced commit ring.
"""

import numpy as np
import pytest

from patrol_tpu.models.limiter import LimiterConfig as JConfig
from patrol_tpu.ops import wire as jwire
from patrol_tpu.ops.rate import Rate as JRate
from patrol_tpu.runtime import engine as jengine_mod
from patrol_tpu_torch.models.limiter import NANO
from patrol_tpu_torch.ops import commit as tcommit
from patrol_tpu_torch.ops import join_kernel as tjoin
from patrol_tpu_torch.models.limiter import LimiterConfig as TConfig
from patrol_tpu_torch.ops import wire as twire
from patrol_tpu_torch.ops.rate import Rate as TRate
from patrol_tpu_torch.runtime import engine as tengine_mod

BUCKETS, NODES = 256, 8


class Clock:
    def __init__(self, now=1000 * NANO):
        self.now = now

    def __call__(self):
        return self.now


def make_trace(seed, hold=False):
    """A list of phases; each phase is a list of ops, run then flushed.
    ``hold`` parks the feeder (by holding the state lock) while the big
    delta phase queues, so the next drain spans several merge blocks."""
    rng = np.random.default_rng(seed)
    names = [f"b{i}" for i in range(60)]
    rates = [(10, NANO), (3, NANO), (5, 60 * NANO), (0, NANO)]
    phases = []

    def deltas(n, kinds, hot=None, unique=False):
        ops = []
        pool = rng.permutation(40)
        for i in range(n):
            if unique:
                name = names[int(pool[i])]
            elif hot is None:
                name = names[int(rng.integers(0, 40))]
            else:
                name = hot[int(rng.integers(0, len(hot)))]
            slot = int(rng.integers(1, NODES))
            kind = kinds[int(rng.integers(0, len(kinds)))]
            la = int(rng.integers(0, 8 * NANO))
            lt = int(rng.integers(0, 12 * NANO))
            cap = int(rng.choice([10 * NANO, 3 * NANO]))
            el = int(rng.integers(0, 5 * NANO))
            ops.append(("delta", kind, name, slot, la, lt, cap, el))
        return ops

    def takes(n, hot_share):
        ops = []
        for _ in range(n):
            if rng.random() < hot_share:
                name, rate, count = "hot", (10, NANO), 1
            else:
                # One (rate, count) key per name: with the rx fold on, a
                # row's tickets under two keys are served in an order
                # that depends on tick timing, in the reference too.
                i = int(rng.integers(0, 60))
                name, rate, count = names[i], rates[i % len(rates)], 1 + i % 3
            ops.append(("take", name, rate, count))
        return ops

    # Scalar-semantics deltas (cap-only, v1) are attributed against the
    # other lanes at merge time, so which tick they share with lane
    # deltas of the same row changes the result in the reference too:
    # they ride phases of their own, one per row.
    phases.append(deltas(120, ["lane", "lane", "raw"]))
    phases.append(takes(150, 0.3))
    batch = takes(40, 0.5)
    phases.append([("batch", [op[1:] for op in batch])])
    storm = [f"b{i}" for i in (1, 2, 3)]
    phases.append(
        ([("hold",)] if hold else [])
        + deltas(90, ["lane", "raw"])
        + deltas(60, ["lane"], hot=storm)
        + [("delta", "lane", "b7", NODES + 3, NANO, NANO, 10 * NANO, 1)]
        + ([("release",)] if hold else [])
    )
    phases.append(deltas(30, ["cap", "v1"], unique=True))
    phases.append([("clock", NANO // 2)] + takes(120, 0.4))
    return phases


def run_engine(eng, clock, phases, mk_rate, wire_mod):
    out = []
    for phase in phases:
        tickets = []
        for op in phase:
            if op[0] == "clock":
                clock.now += op[1]
            elif op[0] == "hold":
                eng._state_mu.acquire()
            elif op[0] == "release":
                eng._state_mu.release()
            elif op[0] == "delta":
                _, kind, name, slot, la, lt, cap, el = op
                if kind == "lane":
                    st = wire_mod.from_nanotokens(
                        name, cap + la, lt, el, origin_slot=slot, cap_nt=cap,
                        lane_added_nt=la, lane_taken_nt=lt,
                    )
                elif kind == "cap":
                    st = wire_mod.from_nanotokens(
                        name, cap + 2 * la, lt, el, origin_slot=slot, cap_nt=cap
                    )
                else:
                    st = wire_mod.from_nanotokens(name, cap + la, lt, el)
                out.append(("created", eng.ingest_delta(st, slot, scalar=kind == "v1")))
            elif op[0] == "take":
                _, name, (f, p), count = op
                t, created = eng.submit_take(name, mk_rate(f, p), count)
                tickets.append(t)
                out.append(("created", created))
            else:
                res = eng.submit_takes_batch(
                    [e[0] for e in op[1]], [mk_rate(*e[1]) for e in op[1]],
                    [e[2] for e in op[1]],
                )
                for t, created in res:
                    tickets.append(t)
                    out.append(("created", created))
        assert eng.flush(30)
        for t in tickets:
            assert t.wait(10)
            out.append(("take", t.ok, t.remaining))
    return out


@pytest.mark.parametrize(
    "take_fold,tick_fold,block",
    [("1", "0", None), ("0", "0", None), ("1", "1", None), ("0", "1", 16)],
)
def test_engine_trace_matches_reference(monkeypatch, take_fold, tick_fold, block):
    monkeypatch.setenv("PATROL_TAKE_FOLD", take_fold)
    monkeypatch.setenv("PATROL_TICK_FOLD", tick_fold)
    monkeypatch.setattr(jengine_mod, "HOST_FASTPATH", False)
    monkeypatch.setattr(tengine_mod, "HOST_FASTPATH", False)
    if block is not None:
        monkeypatch.setattr(jengine_mod, "MAX_MERGE_ROWS", block)
        monkeypatch.setattr(tengine_mod, "MAX_MERGE_ROWS", block)
    phases = make_trace(seed=5, hold=block is not None)

    jclock = Clock()
    jeng = jengine_mod.DeviceEngine(JConfig(BUCKETS, NODES), node_slot=0, clock=jclock)
    try:
        want = run_engine(jeng, jclock, phases, lambda f, p: JRate(freq=f, per_ns=p), jwire)
        j_pn, j_el = jeng.snapshot_planes()
        j_cap = jeng.directory.cap_base_nt.copy()
        j_dropped = jeng.scalar_dropped
    finally:
        jeng.stop()

    # Spies on the port's join entry points, to show the trace reaches the
    # paths each parameter is meant to exercise.
    calls = {"dense": 0, "ring": 0}
    real_tick, real_commit = tjoin.tick_join, tcommit.commit_packed

    def tick_spy(pn, elapsed, dense, pairs, **kw):
        calls["dense"] += dense is not None
        return real_tick(pn, elapsed, dense, pairs, **kw)

    def commit_spy(state, packed, *args, **kw):
        calls["ring"] += packed.dim() == 3
        return real_commit(state, packed, *args, **kw)

    monkeypatch.setattr(tjoin, "tick_join", tick_spy)
    monkeypatch.setattr(tcommit, "commit_packed", commit_spy)

    tclock = Clock()
    teng = tengine_mod.DeviceEngine(
        TConfig(BUCKETS, NODES), node_slot=0, clock=tclock, device="cpu"
    )
    try:
        got = run_engine(teng, tclock, phases, lambda f, p: TRate(freq=f, per_ns=p), twire)
        t_pn, t_el = teng.snapshot_planes()
        t_cap = teng.directory.cap_base_nt.copy()
        t_dropped = teng.scalar_dropped
    finally:
        teng.stop()

    assert got == want
    assert sum(1 for o in got if o[0] == "take" and o[1]) > 50  # non-vacuous
    np.testing.assert_array_equal(t_pn, j_pn)
    np.testing.assert_array_equal(t_el, j_el)
    np.testing.assert_array_equal(t_cap, j_cap)
    assert t_dropped == j_dropped
    assert (t_pn[:, 1:, :] > 0).any() and (t_pn[:, 0, 1] > 0).any()
    if tick_fold == "1" and block is None:
        assert calls["dense"] > 0
    if block is not None:
        assert calls["ring"] > 0


def test_cpu_engine_never_touches_cuda():
    eng = tengine_mod.DeviceEngine(TConfig(16, 2), device="cpu")
    try:
        assert eng.state.pn.device.type == "cpu"
        remaining, ok, created = eng.take("x", TRate(freq=2, per_ns=NANO), 1)
        assert (remaining, ok, created) == (1, True, True)
        assert eng.tokens_if_known("x") == 1 and eng.tokens_if_known("y") is None
        snap = eng.snapshot("x")
        assert len(snap) == 1 and snap[0].lane_taken_nt == NANO
    finally:
        eng.stop()


@pytest.mark.parametrize("hold", [False, True])
@pytest.mark.parametrize("seed", [5, 8])
def test_hybrid_tick_is_one_lease_and_one_launch(monkeypatch, seed, hold):
    """With the tick fold on in both engines, a trace with hot rows ends in
    the same planes, and each folded merge tick of the port stages both
    halves in ONE lease and joins them with ONE tick_join call."""
    monkeypatch.setenv("PATROL_TICK_FOLD", "1")
    monkeypatch.setattr(jengine_mod, "HOST_FASTPATH", False)
    monkeypatch.setattr(tengine_mod, "HOST_FASTPATH", False)
    phases = make_trace(seed=seed, hold=hold)

    jclock = Clock()
    jeng = jengine_mod.DeviceEngine(JConfig(BUCKETS, NODES), node_slot=0, clock=jclock)
    try:
        want = run_engine(jeng, jclock, phases, lambda f, p: JRate(freq=f, per_ns=p), jwire)
        j_pn, j_el = jeng.snapshot_planes()
    finally:
        jeng.stop()

    tclock = Clock()
    teng = tengine_mod.DeviceEngine(
        TConfig(BUCKETS, NODES), node_slot=0, clock=tclock, device="cpu"
    )
    counts = {"lease": 0, "tick_join": 0}
    ticks = []  # (leases, tick_join calls, halves) per lane-merge tick
    pool, real_lease = teng._staging, tengine_mod.StagingPool.lease
    real_tick, real_apply = tjoin.tick_join, teng._apply_lane_merges

    def lease_spy(self, *a, **kw):
        counts["lease"] += self is pool
        return real_lease(self, *a, **kw)

    def tick_spy(pn, elapsed, dense, pairs, **kw):
        counts["tick_join"] += 1
        counts["halves"] = (dense is not None, pairs is not None)
        return real_tick(pn, elapsed, dense, pairs, **kw)

    def apply_spy(deltas):
        before = dict(counts)
        real_apply(deltas)
        ticks.append((counts["lease"] - before["lease"],
                      counts["tick_join"] - before["tick_join"], counts.get("halves")))

    try:
        monkeypatch.setattr(tengine_mod.StagingPool, "lease", lease_spy)
        monkeypatch.setattr(tjoin, "tick_join", tick_spy)
        monkeypatch.setattr(teng, "_apply_lane_merges", apply_spy)
        got = run_engine(teng, tclock, phases, lambda f, p: TRate(freq=f, per_ns=p), twire)
        t_pn, t_el = teng.snapshot_planes()
    finally:
        teng.stop()

    assert got == want
    np.testing.assert_array_equal(t_pn, j_pn)
    np.testing.assert_array_equal(t_el, j_el)
    assert ticks and all(n_lease == 1 and n_tick == 1 for n_lease, n_tick, _ in ticks)
    assert any(h == (True, True) for _, _, h in ticks)  # a tick with both halves
