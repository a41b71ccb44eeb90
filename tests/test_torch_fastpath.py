"""The port's host fast path against ``tests/test_fastpath.py``'s contract.

Cold and low-QPS buckets are served from in-process host lanes (no
launch), absorb rx deltas, and are promoted to the device path when hot
or hit by a scalar (v1) delta; a quiet promoted bucket moves back. The
invariant: a bucket answers the same whether it is served from its lanes
or on the device, and promotion and demotion are exact joins.

Every case runs on ``device="cpu"`` (the kernels' plain versions), once
with the lanes in Python and once in the C++ store of
``runtime/hoststore.py`` (skipped when the host library does not build).
The randomized law drives one op sequence through the JAX package at its
defaults and through the port with the fast path on (Python lanes and
native store) and off: per-take results and final states must be equal
bit for bit. The JAX package's two checkpoint cases have their twins in
``tests/test_torch_checkpoint.py``.
"""

import numpy as np
import pytest

from patrol_tpu.models.limiter import LimiterConfig as JConfig
from patrol_tpu.ops import wire as jwire
from patrol_tpu.ops.rate import Rate as JRate
from patrol_tpu.runtime import engine as jengine_mod
from patrol_tpu_torch import native
from patrol_tpu_torch.models.limiter import NANO, LimiterConfig
from patrol_tpu_torch.ops import wire
from patrol_tpu_torch.ops.rate import Rate
from patrol_tpu_torch.runtime import engine as engine_mod
from patrol_tpu_torch.runtime.engine import DeviceEngine

CFG = LimiterConfig(buckets=64, nodes=4)
RATE = Rate(freq=10, per_ns=NANO)


class FakeClock:
    def __init__(self, start_ns: int = 0):
        self.now = start_ns

    def __call__(self) -> int:
        return self.now

    def advance(self, ns: int) -> None:
        self.now += ns


def _make(lanes: str, clock=None, cfg=CFG):
    if lanes == "native" and native.load() is None:
        pytest.skip("the native host library does not build here")
    eng = DeviceEngine(cfg, node_slot=0, clock=clock or FakeClock(), device="cpu",
                       native_host=lanes == "native")
    assert (eng._native_store is not None) == (lanes == "native")
    return eng


@pytest.fixture(params=["python", "native"])
def engine(request):
    eng = _make(request.param)
    yield eng
    eng.stop()


class TestResidency:
    def test_cold_bucket_serves_from_host(self, engine):
        for i in range(10):
            remaining, ok, _ = engine.take("cold", RATE, 1)
            assert ok and remaining == 9 - i
        remaining, ok, _ = engine.take("cold", RATE, 1)
        assert not ok and remaining == 0
        assert engine.hosted_buckets == 1
        assert engine.host_takes == 11
        assert engine.promotions == 0
        # Refill behaves identically on the host lanes.
        engine.clock.advance(NANO)
        remaining, ok, _ = engine.take("cold", RATE, 10)
        assert ok and remaining == 0

    def test_qps_threshold_promotes_exactly_once(self, engine):
        n = engine_mod.HOST_PROMOTE_TAKES + 40
        admitted = sum(
            engine.take("hot", Rate(freq=n * 2, per_ns=NANO), 1)[1] for _ in range(n)
        )
        assert admitted == n  # capacity 2n: every take admits, either path
        assert engine.flush()  # the promotion joins on the feeder's next tick
        assert engine.promotions == 1
        assert engine.hosted_buckets == 0
        # The join moved the host-era lanes to the device intact.
        pn, _ = engine.read_rows([engine.directory.lookup("hot")])
        assert int(pn[0][:, 1].sum()) == n * NANO
        assert int(pn[0][:, 0].sum()) == 0  # no refill commits at t=0

    def test_rx_lane_delta_absorbs_into_host_lanes(self, engine):
        engine.take("b", RATE, 3)  # hosted: lane 0 takes 3
        assert engine.hosted_buckets == 1
        engine.ingest_delta(wire.from_nanotokens("b", 0, 5 * NANO, 0, origin_slot=2), slot=2)
        assert engine.hosted_buckets == 1 and engine.promotions == 0
        assert engine.tokens_if_known("b") == 2  # 10 - 3 - 5, host view
        states = {s.origin_slot: s for s in engine.snapshot("b")}
        assert states[0].lane_taken_nt == 3 * NANO
        assert states[2].lane_taken_nt == 5 * NANO
        remaining, ok, _ = engine.take("b", RATE, 2)
        assert ok and remaining == 0
        assert not engine.take("b", RATE, 1)[1]
        assert engine.hosted_buckets == 1

    def test_scalar_rx_delta_promotes(self, engine):
        engine.take("v", RATE, 3)
        assert engine.hosted_buckets == 1
        engine.ingest_delta(
            wire.from_nanotokens("v", 12 * NANO, 2 * NANO, 7), slot=1, scalar=True,
        )
        assert engine.flush()
        assert engine.hosted_buckets == 0 and engine.promotions == 1
        pn, _ = engine.read_rows([engine.directory.lookup("v")])
        assert int(pn[0][0, 1]) == 3 * NANO  # the host-era lane survived
        # Deficit attribution ran after the join (peer aggregate 2 <= our 3).
        assert int(pn[0][1, 1]) == 0

    def test_rx_pressure_promotes(self, engine):
        engine.take("p", RATE, 1)
        assert engine.hosted_buckets == 1
        n = engine_mod.HOST_PROMOTE_TAKES + 5
        engine.ingest_deltas_batch(
            ["p"] * n, [2] * n, list(range(NANO, NANO + n)), [0] * n, [0] * n,
        )
        assert engine.flush()
        assert engine.hosted_buckets == 0 and engine.promotions == 1
        assert int(engine.directory.pins.min()) >= 0

    def test_incast_snapshot_and_tokens_read_host_lanes(self, engine):
        engine.take("s", RATE, 4)
        assert engine.hosted_buckets == 1
        states = engine.snapshot("s")
        assert len(states) == 1 and states[0].origin_slot == 0
        assert states[0].lane_taken_nt == 4 * NANO
        assert states[0].cap_nt == 10 * NANO
        assert states[0].added_nt == 10 * NANO  # cap + sum of lane grants (0)
        assert states[0].taken_nt == 4 * NANO
        assert engine.tokens_if_known("s") == 6
        assert engine.tokens_if_known("nope") is None
        many = engine.snapshot_many(["s", "nope"])
        assert set(many) == {"s"}
        assert many["s"][0].lane_taken_nt == 4 * NANO
        pn, el = engine.row_view(engine.directory.lookup("s"))
        assert int(pn[0, 1]) == 4 * NANO and el == 0

    def test_release_drops_host_state(self, engine):
        engine.take("old", RATE, 7)
        assert engine.hosted_buckets == 1
        assert engine.release_bucket("old")
        assert engine.hosted_buckets == 0
        assert not engine.release_bucket("old")  # unknown now
        remaining, ok, _ = engine.take("old", RATE, 1)
        assert ok and remaining == 9  # a fresh bucket, no leaked lanes

    def test_interval_and_raw_rx_absorb_into_host_lanes(self, engine):
        """The dv2 paths: a decoded interval and raw planes both join
        into the lanes of a hosted row (the raw one through the kernel's
        hosted_mask) and fold the rest into the device planes."""
        engine.take("h", RATE, 1)
        assert engine.ingest_interval(["h", "d"], [1, 1], [10 * NANO] * 2,
                                      [0, 0], [2 * NANO, 3 * NANO], [5, 5]) == 2
        ents = [wire.DeltaEntry("h", 2, 10 * NANO, 0, 4 * NANO, 9),
                wire.DeltaEntry("d", 2, 10 * NANO, 0, 1 * NANO, 9)]
        data, _ = wire.encode_delta_packet(1, 1, (), ents, max_size=8192)
        planes = np.zeros((1, 8192), np.uint8)
        planes[0, :len(data)] = np.frombuffer(data, np.uint8)
        assert engine.ingest_raw_planes(planes, np.array([len(data)], np.int32)) == 2
        assert engine.flush()
        assert engine.hosted_buckets == 1 and engine.promotions == 0
        pn_h, el_h = engine.row_view(engine.directory.lookup("h"))
        assert pn_h[:, 1].tolist() == [NANO, 2 * NANO, 4 * NANO, 0] and el_h == 9
        pn_d, _ = engine.read_rows([engine.directory.lookup("d")])
        assert pn_d[0][:, 1].tolist() == [0, 3 * NANO, NANO, 0]
        # The hosted row's device plane took no part of it.
        pn_dev, _ = engine.read_rows([engine.directory.lookup("h")])
        assert int(np.abs(pn_dev).sum()) == 0
        assert int(engine.directory.pins.max()) == 0


def _law_ops(seed: int):
    rng = np.random.default_rng(seed)
    ops = []
    names = [f"k{j}" for j in range(6)]
    t = 0
    for _ in range(120):
        t += int(rng.integers(0, NANO // 3))
        kind = rng.integers(0, 10)
        name = names[int(rng.integers(0, len(names)))]
        if kind < 7:
            ops.append(("take", name, int(rng.integers(1, 20)), int(rng.integers(1, 4)), t))
        else:
            ops.append((
                "delta", name, int(rng.integers(0, 5)) * NANO,
                int(rng.integers(0, 5)) * NANO, t, int(rng.integers(1, 4)),
                bool(rng.integers(0, 3) == 0),  # scalar (v1) mix
            ))
    return names, ops


def _run_law(make_engine, wire_mod, rate_cls, names, ops):
    clock = FakeClock()
    eng = make_engine(clock)
    results = []
    try:
        for op in ops:
            if op[0] == "take":
                _, name, freq, count, now = op
                clock.now = now
                results.append(tuple(eng.take(name, rate_cls(freq=freq, per_ns=NANO), count)))
            else:
                _, name, a, tk, now, slot, scalar = op
                clock.now = now
                eng.ingest_delta(
                    wire_mod.from_nanotokens(name, a, tk, now // 2), slot=slot, scalar=scalar,
                )
                if scalar:
                    assert eng.flush()  # scalar order against takes must match
        eng.flush_hosted()
        assert eng.flush()
        known = [(n, eng.directory.lookup(n)) for n in names]
        known = [(n, r) for n, r in known if r is not None]
        pn, el = eng.read_rows([r for _, r in known])
        state = {n: (np.asarray(pn[i]).tolist(), int(el[i])) for i, (n, _) in enumerate(known)}
        return results, state
    finally:
        eng.stop()


_JAX_LAW = {}


def _jax_law(seed: int, monkeypatch, fastpath: bool = True):
    """The JAX package's run of a seed's ops (fast path on: its default),
    computed once per seed."""
    key = (seed, fastpath)
    if key not in _JAX_LAW:
        names, ops = _law_ops(seed)
        monkeypatch.setattr(jengine_mod, "HOST_FASTPATH", fastpath)
        _JAX_LAW[key] = _run_law(
            lambda c: jengine_mod.DeviceEngine(JConfig(buckets=64, nodes=4), node_slot=0, clock=c),
            jwire, JRate, names, ops,
        )
        monkeypatch.undo()
    return _JAX_LAW[key]


@pytest.mark.parametrize("variant", ["jax-device", "port-python", "port-off", "port-native"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_randomized_sequences_match(seed, variant, monkeypatch):
    """The law: per-take results and final states, bit for bit, of the JAX
    package at its defaults (host fast path on) against, per case, the JAX
    package with the fast path off, or the port with it on (Python lanes
    or the native store) or off. Rates, counts, clock steps, rx lane deltas
    and promoting scalar deltas are drawn from the seed."""
    want = _jax_law(seed, monkeypatch)
    names, ops = _law_ops(seed)
    if variant == "jax-device":
        got = _jax_law(seed, monkeypatch, fastpath=False)
    else:
        monkeypatch.setattr(engine_mod, "HOST_FASTPATH", variant != "port-off")
        lanes = "native" if variant == "port-native" else "python"
        got = _run_law(lambda c: _make(lanes, c), wire, Rate, names, ops)
    assert got[0] == want[0], f"seed {seed} {variant}: per-take results diverge"
    assert got[1] == want[1], f"seed {seed} {variant}: final states diverge"


class TestReviewRegressions:
    def test_capless_lane_delta_rows_never_host(self, engine):
        """A row made by a cap-less raw-lane delta holds device lanes with
        its cap still 0: the first batched take must not host it."""
        engine.ingest_deltas_batch(["shadow"], [2], [0], [6 * NANO], [0])
        assert engine.flush()
        assert engine.hosted_buckets == 0
        res = engine.submit_takes_batch(["shadow"], [RATE], [1])
        assert res[0][0].wait(10)
        assert engine.hosted_buckets == 0  # not bind-fresh: stayed on the device
        # 10 (lazy cap) - 6 (peer lane) - 1 = 3
        assert res[0][0].ok and res[0][0].remaining == 3

    def test_batch_hosts_fresh_rows_in_order(self, engine):
        """A batch binds a fresh name and takes it twice: both takes are
        served from the lanes its first occurrence made, in order."""
        res = engine.submit_takes_batch(["f", "f", "g"], [RATE] * 3, [4, 7, 1])
        out = [(t.wait(10), t.ok, t.remaining, c) for t, c in res]
        assert out == [(True, True, 6, True), (True, False, 6, False), (True, True, 9, True)]
        assert engine.hosted_buckets == 2 and engine.host_takes == 3

    def test_slow_takes_with_echoes_stay_hosted(self, engine):
        """win_rx rolls over with the window: a bucket taken once a window
        and echoed back by a peer each time stays hosted."""
        clock = engine.clock
        for _ in range(engine_mod.HOST_PROMOTE_TAKES + 30):
            engine.take("slow", Rate(freq=10**6, per_ns=NANO), 1)
            st = engine.snapshot("slow")[0]  # what a peer would echo
            engine.ingest_delta(st, slot=0)
            clock.advance(2 * engine_mod.HOST_PROMOTE_WINDOW_NS)
        assert engine.hosted_buckets == 1
        assert engine.promotions == 0

    def test_idle_promoted_bucket_demotes_and_next_take_is_host_served(self, engine):
        clock = engine.clock
        n = engine_mod.HOST_PROMOTE_TAKES + 40
        rate = Rate(freq=4 * n, per_ns=NANO)
        for _ in range(n):
            engine.take("burst", rate, 1)
        assert engine.flush()
        assert engine.promotions == 1 and engine.hosted_buckets == 0
        for _ in range(2):
            _, ok, _ = engine.take("burst", rate, 1)
            assert ok
        clock.advance(engine_mod.HOST_DEMOTE_WINDOW_NS + 1)
        host_takes_before = engine.host_takes
        remaining, ok, _ = engine.take("burst", rate, 1)
        assert ok
        assert engine.demotions == 1
        assert engine.hosted_buckets == 1
        assert engine.host_takes == host_takes_before + 1  # served from the lanes
        row = engine.directory.lookup("burst")
        with engine._host_mu:
            taken_total = int(engine._hosted[row].taken.sum())
        assert taken_total >= (n + 3) * NANO  # nothing lost (+ forfeits)
        pn_dev, el_dev = engine.read_rows([row])
        assert int(np.abs(pn_dev).sum()) == 0 and int(el_dev[0]) == 0  # zeroed
        for _ in range(engine_mod.HOST_PROMOTE_TAKES + 40):
            engine.take("burst", rate, 1)
        assert engine.flush()
        assert engine.promotions == 2

    def test_demotion_skips_rows_with_queued_work(self, engine):
        n = engine_mod.HOST_PROMOTE_TAKES + 5
        rate = Rate(freq=4 * n, per_ns=NANO)
        for _ in range(n):
            engine.take("pinned", rate, 1)
        assert engine.flush()
        row = engine.directory.lookup("pinned")
        assert engine.hosted_buckets == 0
        engine.clock.advance(engine_mod.HOST_DEMOTE_WINDOW_NS + 1)
        engine.directory.pins[row] += 1  # stands for a queued delta's pin
        try:
            engine.take("pinned", rate, 1)
            assert engine.demotions == 0  # skipped: a foreign pin is visible
        finally:
            engine.directory.pins[row] -= 1
        engine.clock.advance(engine_mod.HOST_DEMOTE_WINDOW_NS + 1)
        engine.take("pinned", rate, 1)
        assert engine.demotions == 1

    def test_snapshot_sees_lanes_mid_promotion(self, engine):
        """Between a promotion drain's pop and its join, the lanes live in
        ``_promoting``: every read of the row joins them."""
        engine.take("mid", RATE, 5)
        row = engine.directory.lookup("mid")
        with engine._host_mu:
            lanes = engine._hosted.pop(row)
            engine._hosted_flag[row] = False
            engine._promoting[row] = lanes
        try:
            pn, _ = engine.snapshot_planes()
            assert int(pn[row, :, 1].sum()) == 5 * NANO  # the spend stays visible
            assert engine.tokens_if_known("mid") == 5
            assert engine.snapshot("mid")[0].lane_taken_nt == 5 * NANO
            assert engine.snapshot_many(["mid"])["mid"][0].lane_taken_nt == 5 * NANO
        finally:
            with engine._host_mu:
                engine._hosted[row] = engine._promoting.pop(row)
                engine._hosted_flag[row] = True

    def test_flush_hosted_timeout_raises(self, engine):
        engine.take("stuck", RATE, 1)
        assert engine.hosted_buckets == 1
        engine._drain_promotions = lambda: None  # the feeder cannot drain
        with pytest.raises(TimeoutError):
            engine.flush_hosted(timeout=0.05)

    def test_promotion_deltas_hold_pins(self, engine):
        n = engine_mod.HOST_PROMOTE_TAKES + 5
        for _ in range(n):
            engine.take("pin", Rate(freq=2 * n, per_ns=NANO), 1)
        assert engine.flush()
        assert engine.promotions == 1
        row = engine.directory.lookup("pin")
        assert int(engine.directory.pins[row]) == 0  # balanced, not -k
        assert int(engine.directory.pins.min()) >= 0

    def test_eviction_drops_host_lanes(self):
        """A pool spent on hosted buckets evicts them: the victims' lanes
        go, and a recycled row starts from zero."""
        eng = _make("python", cfg=LimiterConfig(buckets=8, nodes=4))
        try:
            for i in range(8):
                eng.take(f"e{i}", RATE, 3)
            assert eng.hosted_buckets == 8
            remaining, ok, _ = eng.take("new", RATE, 1)
            assert ok and remaining == 9
            assert eng.evictions > 0
            assert eng.hosted_buckets == 9 - eng.evictions
        finally:
            eng.stop()


def test_fast_path_off_keeps_every_take_on_the_device(monkeypatch):
    monkeypatch.setattr(engine_mod, "HOST_FASTPATH", False)
    eng = DeviceEngine(CFG, node_slot=0, clock=FakeClock(), device="cpu", native_host=True)
    try:
        assert eng._native_store is None  # no store without the fast path
        assert eng.take("d", RATE, 2)[:2] == (8, True)
        assert eng.hosted_buckets == 0 and eng.host_takes == 0
        assert eng.ticks > 0
    finally:
        eng.stop()


def test_antientropy_repairs_hosted_rows():
    """Two port nodes (asyncio front and backend, full-state wire), every
    bucket hosted on both. Node 1 hears nothing while node 0 spends; after
    the partition heals, one anti-entropy round repairs node 1's host lanes
    (digests read them, the pushed lane states are absorbed into them)."""
    import time as _time

    from test_torch_replication import BUDGET_S, Node, converge, free_port, port_cmd, taken_tokens

    budget = _time.monotonic() + BUDGET_S
    addrs = [f"127.0.0.1:{free_port()}" for _ in range(2)]
    nodes = []
    try:
        for a in addrs:
            nodes.append(Node(port_cmd(a, addrs, wire_mode="full")))
        cmds = [n.cmd for n in nodes]
        rate = Rate(freq=100, per_ns=3600 * NANO)
        names = [f"ae{i}" for i in range(8)]
        for nm in names:
            for c in cmds:
                assert c.repo.take(nm, rate, 1)[1]
        converge(cmds, names, budget)
        hosted = [c.engine.hosted_buckets for c in cmds]
        cmds[1].replicator.drop_addr = lambda addr: True  # node 1 hears nothing
        for nm in names:
            for _ in range(2):
                assert cmds[0].repo.take(nm, rate, 1)[1]
        _time.sleep(0.2)
        cmds[1].replicator.drop_addr = None
        for c in cmds:
            for peer in c.replicator.peers:
                c.replicator.antientropy.trigger(peer, force=True)
        view = converge(cmds, names, budget)
        assert taken_tokens(view) == 4 * len(names)
        assert hosted[1] > 0 and cmds[1].engine.hosted_buckets == hosted[1]
    finally:
        for n in nodes:
            n.close()


@pytest.mark.parametrize("order", ["in-order", "out-of-order"])
def test_delta_plane_keeps_the_newest_lane_state(order):
    """Host-lane takes and the native front's drain each emit a bucket's
    state after releasing the lanes' lock, so two states of one lane can
    reach the delta plane out of order. The interval must carry the newer
    (larger) lane values either way: the plane keeps the join of what was
    offered since its last flush."""
    from test_torch_delta import data_seqs, make_plane, offered


    rep, plane = make_plane()
    states = [offered(wire, "b", 3 * NANO), offered(wire, "b", 7 * NANO)]
    for st in states if order == "in-order" else states[::-1]:
        plane.offer([st])
    plane.flush()
    pkts = [wire.decode_delta_packet(d) for d, _ in rep.sent]
    entries = [e for p in pkts if p is not None for e in p.entries if e.name == "b"]
    assert [e.taken_nt for e in entries] == [7 * NANO]
    assert len(data_seqs(rep)) == 1  # one interval
