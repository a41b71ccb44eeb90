"""The port's MeshEngine against the JAX package's, call for call.

Twins of tests/test_mesh_engine.py (and of tests/test_lifecycle.py's
``TestMeshLifecycle``): each scenario runs on a JAX ``MeshEngine`` over
the 8-device virtual CPU mesh that tests/conftest.py forces and on the
port's ``MeshEngine`` over ``cpu`` × 8 (every block on the one device,
the kernels' plain versions), at R = 1, 2 and 4 replicas where the
original runs a fixture. Take outcomes, ``tokens``, snapshots, stats and
the planes (``snapshot_planes``) must be equal; tolerance 0 (int64).

The host fast path is off in both packages unless a test says otherwise,
so every take rides the mesh's fused dispatch (with it on, a fresh bucket
is served from host lanes and never reaches the mesh). A ``Command``
cluster runs a meshed port node at 2 × 4 beside a plain one.
"""

import asyncio
import socket
import threading
import time

import jax
import numpy as np
import pytest
import torch

from patrol_tpu.models.limiter import LimiterConfig as JConfig
from patrol_tpu.ops import wire as jwire
from patrol_tpu.ops.rate import Rate as JRate
from patrol_tpu.runtime import checkpoint as jckpt
from patrol_tpu.runtime import engine as jengine_mod
from patrol_tpu.runtime.engine import DeltaArrays as JDeltas
from patrol_tpu.runtime.engine import TakeTicket as JTicket
from patrol_tpu.runtime.mesh_engine import MESH_WARM_MAX as J_WARM_MAX
from patrol_tpu.runtime.mesh_engine import MeshEngine as JMesh
from patrol_tpu_torch.models.limiter import NANO, LimiterConfig
from patrol_tpu_torch.ops import wire as twire
from patrol_tpu_torch.ops.rate import Rate
from patrol_tpu_torch.runtime import checkpoint as tckpt
from patrol_tpu_torch.runtime import engine as tengine_mod
from patrol_tpu_torch.runtime.engine import DeltaArrays, TakeTicket
from patrol_tpu_torch.runtime.mesh_engine import MESH_WARM_MAX, MeshEngine
from patrol_tpu_torch.utils import profiling as tprofiling

CFG = (64, 4)
CFG_WIDE = (65536, 4)
CPU8 = [torch.device("cpu")] * 8
# Several pieces on the CPU: eight distinct devices, two devices of four
# blocks each, and one device with a piece a block.
DISTINCT8 = [torch.device("cpu", i) for i in range(8)]
MIXED8 = [torch.device("cpu", 0)] * 4 + [torch.device("cpu", 1)] * 4

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device virtual CPU mesh"
)


class FakeClock:
    def __init__(self, now=0):
        self.now = now

    def __call__(self):
        return self.now

    def advance(self, ns):
        self.now += ns


class Pair:
    """A JAX and a port MeshEngine on the same config, replicas and
    clock; ``both(fn)`` runs ``fn(engine, rate_cls)`` on each."""

    def __init__(self, cfg=CFG, replicas=1, node_slot=0, jdevices=None, tdevices=CPU8,
                 on_broadcast=(None, None), piece_per_block=False):
        self.clock = FakeClock()
        self.j = JMesh(JConfig(*cfg), replicas=replicas, node_slot=node_slot, clock=self.clock,
                       on_broadcast=on_broadcast[0], devices=jdevices)
        self.t = MeshEngine(LimiterConfig(*cfg), replicas=replicas, node_slot=node_slot,
                            clock=self.clock, on_broadcast=on_broadcast[1], devices=tdevices,
                            piece_per_block=piece_per_block)

    def both(self, fn):
        return fn(self.j, JRate), fn(self.t, Rate)

    def same(self, fn):
        a, b = self.both(fn)
        assert a == b
        return b

    def assert_planes_equal(self):
        assert self.j.flush(30) and self.t.flush(30)
        jpn, jel = self.j.snapshot_planes()
        tpn, tel = self.t.snapshot_planes()
        assert np.array_equal(np.asarray(jpn), tpn)
        assert np.array_equal(np.asarray(jel), tel)

    def stop(self):
        self.j.stop()
        self.t.stop()


@pytest.fixture
def device_path(monkeypatch):
    monkeypatch.setattr(jengine_mod, "HOST_FASTPATH", False)
    monkeypatch.setattr(tengine_mod, "HOST_FASTPATH", False)


@pytest.fixture(params=[1, 2, 4])
def pair(request, device_path):
    p = Pair(replicas=request.param)
    yield p
    p.stop()


class TestMeshEngineBehavior:
    def test_take_table(self, pair):
        def run(eng, R):
            rate = R(freq=10, per_ns=NANO)
            out = [eng.take("k", rate, 1)[:2] for _ in range(11)]
            return out

        got = pair.same(run)
        assert [ok for _, ok in got] == [True] * 10 + [False]
        pair.clock.advance(NANO)
        got = pair.same(lambda eng, R: eng.take("k", R(freq=10, per_ns=NANO), 10)[:2])
        assert got == (0, True)
        pair.assert_planes_equal()

    def test_many_buckets_route_to_shards(self, pair):
        def run(eng, R):
            rate = R(freq=10, per_ns=NANO)
            out = [eng.take(f"bucket-{i}", rate, 3)[:2] for i in range(40)]
            return out, [eng.tokens(f"bucket-{i}") for i in range(40)]

        got, tokens = pair.same(run)
        assert all(g == (7, True) for g in got) and tokens == [7] * 40
        pair.assert_planes_equal()

    def test_concurrent_hot_bucket(self, pair):
        def run(eng, R):
            results = []
            lock = threading.Lock()

            def worker():
                _, ok, _ = eng.take("hot", R(freq=10, per_ns=NANO), 1)
                with lock:
                    results.append(ok)

            threads = [threading.Thread(target=worker) for _ in range(32)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            return sum(results)

        assert pair.same(run) == 10
        pair.assert_planes_equal()

    def test_merge_and_snapshot(self, pair):
        def run(eng, R):
            w = jwire if R is JRate else twire
            eng.take("m", R(freq=10, per_ns=NANO), 2)
            eng.ingest_delta(w.from_nanotokens("m", 0, 5 * NANO, 0, origin_slot=2), slot=2)
            eng.flush()
            states = {s.origin_slot: (s.taken_nt, s.lane_taken_nt) for s in eng.snapshot("m")}
            return eng.tokens("m"), states

        tokens, states = pair.same(run)
        assert tokens == 3 and states[0] == (7 * NANO, 2 * NANO) and states[2][1] == 5 * NANO
        pair.assert_planes_equal()

    @pytest.mark.parametrize("replicas", [1, 2, 4])
    def test_broadcast_hook(self, device_path, replicas):
        jgot, tgot = [], []
        p = Pair(replicas=replicas, node_slot=1, on_broadcast=(jgot.append, tgot.append))
        try:
            p.both(lambda eng, R: eng.take("b", R(freq=10, per_ns=NANO), 4))
            p.j.flush()
            p.t.flush()
            assert len(jgot) == len(tgot) == 1
            key = ("name", "origin_slot", "added_nt", "taken_nt", "elapsed_ns",
                   "lane_taken_nt", "lane_added_nt", "cap_nt")
            j, t = jgot[0][0], tgot[0][0]
            assert [getattr(t, k) for k in key] == [getattr(j, k) for k in key]
            assert t.origin_slot == 1 and t.lane_taken_nt == 4 * NANO and t.taken_nt == 4 * NANO
        finally:
            p.stop()

    def test_checkpoint_roundtrip(self, tmp_path, pair):
        pair.both(lambda eng, R: eng.take("c", R(freq=10, per_ns=NANO), 6))
        jckpt.save(str(tmp_path / "j"), pair.j)
        tckpt.save(str(tmp_path / "t"), pair.t)
        j2 = JMesh(JConfig(*CFG), replicas=2, node_slot=0, clock=FakeClock())
        t2 = MeshEngine(LimiterConfig(*CFG), replicas=2, node_slot=0, clock=FakeClock(),
                        devices=CPU8)
        try:
            assert jckpt.restore(str(tmp_path / "j"), j2) == tckpt.restore(str(tmp_path / "t"), t2)
            assert j2.tokens("c") == t2.tokens("c") == 4
            jpn, jel = j2.snapshot_planes()
            tpn, tel = t2.snapshot_planes()
            assert np.array_equal(np.asarray(jpn), tpn) and np.array_equal(np.asarray(jel), tel)
        finally:
            j2.stop()
            t2.stop()

    def test_host_lanes_serve_at_the_defaults(self):
        """With the host fast path on (both packages' default) a fresh
        bucket is served from host lanes on the mesh engine too."""
        p = Pair(replicas=2)
        try:
            got = p.same(lambda eng, R: [eng.take("h", R(freq=5, per_ns=NANO), 1)[:2]
                                         for _ in range(6)])
            assert [ok for _, ok in got] == [True] * 5 + [False]
            assert p.t.host_takes == 6
            p.assert_planes_equal()
        finally:
            p.stop()


def _free_port(kind=socket.SOCK_STREAM):
    with socket.socket(socket.AF_INET, kind) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class TestMeshCommandCluster:
    def test_meshed_node_in_cluster(self):
        """A 2-node port cluster where node 0 runs the MeshEngine on a
        2 × 4 mesh of ``cpu`` × 8: replication between the meshed node
        and a plain node converges, and /debug/vars carries the mesh."""
        import http.client
        import json

        from test_cluster import KeepAliveClient

        from patrol_tpu_torch.command import Command

        api_ports = [_free_port(), _free_port()]
        node_addrs = [f"127.0.0.1:{_free_port(socket.SOCK_DGRAM)}" for _ in range(2)]
        cmds = [
            Command(
                api_addr=f"127.0.0.1:{api_ports[i]}", node_addr=node_addrs[i],
                peer_addrs=node_addrs, shutdown_timeout_s=5.0, config=LimiterConfig(64, 4),
                handle_signals=False, device="cpu", udp_backend="asyncio",
                http_front="python", mesh_replicas=2 if i == 0 else 0,
                mesh_devices=CPU8 if i == 0 else None,
            )
            for i in range(2)
        ]
        loop = asyncio.new_event_loop()
        stops = []
        ready = threading.Event()

        def run():
            asyncio.set_event_loop(loop)

            async def main():
                tasks = []
                for cmd in cmds:
                    stop = asyncio.Event()
                    stops.append(stop)
                    tasks.append(asyncio.ensure_future(cmd.run(stop)))
                while not all(c.started.is_set() for c in cmds):
                    await asyncio.sleep(0.05)
                ready.set()
                await asyncio.gather(*tasks, return_exceptions=True)

            loop.run_until_complete(main())

        th = threading.Thread(target=run, daemon=True)
        th.start()
        assert ready.wait(60)
        try:
            assert isinstance(cmds[0].engine, MeshEngine)
            assert (cmds[0].engine.plan.replicas, cmds[0].engine.plan.shards) == (2, 4)
            cl0 = KeepAliveClient(api_ports[0])
            cl1 = KeepAliveClient(api_ports[1])
            for _ in range(4):
                assert cl0.take("mx", "4:1h")[0] == 200
            assert cl0.take("mx", "4:1h")[0] == 429
            deadline = time.time() + 10
            seen = False
            while time.time() < deadline and not seen:
                seen = cl1.take("mx", "4:1h")[0] == 429
                time.sleep(0.05)
            assert seen, "plain node did not converge with meshed node"
            cl0.close()
            cl1.close()
            conn = http.client.HTTPConnection("127.0.0.1", api_ports[0], timeout=30)
            conn.request("GET", "/debug/vars")
            vars_ = json.loads(conn.getresponse().read())
            conn.close()
            assert vars_["mesh_replicas"] == 2 and vars_["mesh_shards"] == 4
            assert vars_["mesh_demotion"] == "unsupported"
            assert vars_["mesh_fused_dispatches"] >= 0
        finally:
            loop.call_soon_threadsafe(lambda: [s.set() for s in stops])
            th.join(timeout=15)

    def test_distinct_devices_refuse_to_start(self):
        """Distinct devices of one platform serve now; a list that mixes
        platforms is refused before anything starts (a JAX mesh cannot
        mix them either)."""
        from patrol_tpu_torch.command import Command

        mixed = [torch.device("cpu"), torch.device("cuda", 0)]
        with pytest.raises(ValueError, match="one platform"):
            Command(device="cpu", mesh_replicas=1, mesh_devices=mixed).check_ported()
        with pytest.raises(ValueError, match="one platform"):
            MeshEngine(LimiterConfig(*CFG), replicas=1, devices=mixed)
        Command(device="cpu", mesh_replicas=2, mesh_devices=DISTINCT8).check_ported()


# -- ticks: the fold, the split, the commit drain -------------------------------


def lane_deltas(cls, rows, slots, added, taken, elapsed):
    n = len(rows)
    return cls(rows=np.asarray(rows, np.int64), slots=np.asarray(slots, np.int64),
               added_nt=np.asarray(added, np.int64), taken_nt=np.asarray(taken, np.int64),
               elapsed_ns=np.asarray(elapsed, np.int64), scalar=np.zeros(n, bool))


class TestTicks:
    def test_oversized_hot_key_tick_folds_into_one_dispatch(self, device_path):
        """A drain past MESH_WARM_MAX with every (row, slot) repeated
        folds on the host to 256 unique pairs and rides one dispatch."""
        assert MESH_WARM_MAX == J_WARM_MAX
        n = MESH_WARM_MAX * 2 + 777
        rows = np.arange(n, dtype=np.int64) % CFG[0]
        slots = np.arange(n, dtype=np.int64) % CFG[1]
        p = Pair(replicas=2)
        try:
            p.j._apply(lane_deltas(JDeltas, rows, slots, [NANO] * n, [0] * n, [NANO] * n), [])
            p.t._apply(lane_deltas(DeltaArrays, rows, slots, [NANO] * n, [0] * n, [NANO] * n), [])
            jst, tst = p.j.stats(), p.t.stats()
            assert tst == jst
            assert tst["mesh_split_ticks"] == 0 and tst["mesh_fused_dispatches"] == 1
            touched = np.zeros(CFG, bool)
            touched[rows, slots] = True
            assert tst["mesh_folded_dupes"] == n - int(touched.sum())
            p.assert_planes_equal()
        finally:
            p.stop()

    @pytest.mark.parametrize("replicas", [1, 2, 4])
    def test_straddling_tick_is_bit_exact_with_take_accounting(self, device_path, replicas):
        """TestSubTickSplitBoundary's tick: unique pairs confined to shard
        0 fill its blocks past MESH_WARM_MAX, so the drain splits; the
        tick's takes (one bucket hit 3× with one key) ride the boundary
        dispatch. Outcomes, stats and planes equal the reference's."""
        n = MESH_WARM_MAX * replicas + 999  # each shard-0 block past the cap
        p = Pair(cfg=CFG_WIDE, replicas=replicas)
        try:
            d_rows = 100 + np.arange(n, dtype=np.int64)
            assert int(d_rows.max()) < p.t.plan.rows_per_shard

            def run(eng, R):
                cls, tcls = (JDeltas, JTicket) if R is JRate else (DeltaArrays, TakeTicket)
                rate = R(freq=10, per_ns=NANO)
                tickets = []
                for i in range(8):
                    name = f"tk{i}"
                    row, _ = eng._assign_pinned(name, 0)
                    eng.directory.init_cap_base(row, rate.freq * NANO)
                    for _ in range(3 if i == 0 else 1):
                        assert eng._assign_pinned(name, 0)[0] == row
                        tickets.append(tcls(name, row, rate, 1, 0))
                    eng.directory.unpin_rows([row])
                eng._apply(lane_deltas(cls, d_rows, [0] * n, [7] * n, [3] * n, [11] * n), tickets)
                for t in tickets:
                    assert t.wait(30), "take lost across the sub-tick split"
                return [(t.name, t.remaining, t.ok) for t in tickets], eng.stats()

            (jout, jst), (tout, tst) = p.both(run)
            assert tout == jout and tst == jst
            assert [r for name, r, _ in tout if name == "tk0"] == [9, 8, 7]
            assert tst["mesh_split_ticks"] == 1 and tst["mesh_sub_dispatches"] == 2
            p.assert_planes_equal()
        finally:
            p.stop()

    @pytest.mark.parametrize("replicas", [1, 2, 4])
    def test_split_tick_takes_see_every_earlier_chunk(self, device_path, replicas):
        """A drain past MESH_WARM_MAX a block whose take rows sort last
        in their blocks (2,000 filler names bound first, so the take
        rows are the highest), so their merges ride the boundary
        dispatch with the takes, on home and non-home replicas: a take
        sees the earlier chunks' merges from every replica and the
        boundary chunk's only from its home. Bit for bit."""
        cfg = (65536, 16)
        rng = np.random.default_rng(replicas)
        p = Pair(cfg=cfg, replicas=replicas)
        try:
            fillers = [f"f{i}" for i in range(2000)]
            names = [f"s{i}" for i in range(24)]
            n = MESH_WARM_MAX * (replicas + 1) * 16 // 10
            on_take = rng.random(n) < 0.1
            pick = rng.integers(0, len(names), n)
            spread = rng.integers(0, len(fillers), n)
            slots = rng.integers(1, cfg[1], n)
            # Taken a little above added: the take rows' balances sit a few
            # tokens up, so what a take sees moves its remaining count.
            vals = rng.integers(0, 4 * NANO, (3, n))
            vals[1] += rng.integers(0, 6 * NANO // 10, n)

            def run(eng, R):
                cls, tcls = (JDeltas, JTicket) if R is JRate else (DeltaArrays, TakeTicket)
                rate = R(freq=10, per_ns=60 * NANO)
                bound = {}
                for name in fillers + names:
                    row, _ = eng._assign_pinned(name, 0)
                    eng.directory.init_cap_base(row, rate.freq * NANO)
                    bound[name] = row
                eng.directory.unpin_rows([bound[f] for f in fillers])
                rows = np.array([bound[nm] for nm in names])
                frows = np.array([bound[f] for f in fillers])
                assert rows.min() > frows.max() and rows.max() < eng.plan.rows_per_shard
                d_rows = np.where(on_take, rows[pick], frows[spread])
                tickets = [tcls(nm, int(r), rate, 1 + i % 3, 0)
                           for i, (nm, r) in enumerate(zip(names, rows))]
                eng._apply(lane_deltas(cls, d_rows, slots, *vals), tickets)
                for t in tickets:
                    assert t.wait(30)
                return [(t.remaining, t.ok) for t in tickets], eng.stats()

            (jout, jst), (tout, tst) = p.both(run)
            assert tout == jout and tst == jst
            assert tst["mesh_split_ticks"] == 1 and tst["mesh_sub_dispatches"] >= 2
            p.assert_planes_equal()
        finally:
            p.stop()


class TestCommitPipelineInheritance:
    def test_commit_blocks_inherited(self):
        p = Pair(replicas=2)
        try:
            assert p.t._commit_blocks == tengine_mod.COMMIT_BLOCKS == p.j._commit_blocks
            assert p.t.stats()["mesh_commit_blocks"] == p.j.stats()["mesh_commit_blocks"]
            assert p.t._commit_blocks_auto is False and p.t._demotion_capable is False
            assert p.t._raw_ingest_capable is False and p.t._interval_fold_capable is False
        finally:
            p.stop()

    @pytest.mark.parametrize("replicas", [1, 2])
    def test_multiblock_feeder_drain_bit_exact(self, device_path, replicas):
        rng = np.random.default_rng(2026)
        n = tengine_mod.MAX_MERGE_ROWS + 4096
        bidx = rng.integers(0, 512, n)
        names = [f"k{int(i)}" for i in bidx]
        slots = rng.integers(0, CFG_WIDE[1], n).astype(np.int64)
        added, taken, elapsed = (rng.integers(0, 1 << 50, n) for _ in range(3))
        p = Pair(cfg=CFG_WIDE, replicas=replicas)
        try:
            for eng in (p.j, p.t):
                eng.ingest_deltas_batch(names, slots, added, taken, elapsed)
                assert eng.flush(timeout=60)
            ref_pn = np.zeros((512, CFG_WIDE[1], 2), np.int64)
            ref_el = np.zeros(512, np.int64)
            np.maximum.at(ref_pn, (bidx, slots, 0), added)
            np.maximum.at(ref_pn, (bidx, slots, 1), taken)
            np.maximum.at(ref_el, bidx, elapsed)
            live = np.unique(bidx)
            rows = [p.t.directory.lookup(f"k{int(i)}") for i in live]
            pn, el = p.t.read_rows(rows)
            assert np.array_equal(pn, ref_pn[live]) and np.array_equal(el, ref_el[live])
            p.assert_planes_equal()
        finally:
            p.stop()


class TestMeshStatsContract:
    @pytest.mark.parametrize("replicas", [1, 2, 4])
    def test_stats_match_reference(self, device_path, replicas):
        p = Pair(replicas=replicas)
        try:
            p.both(lambda eng, R: [eng.take(f"s{i}", R(freq=10, per_ns=NANO), 1)
                                   for i in range(12)])
            p.j.flush()
            p.t.flush()
            jst, tst = p.j.stats(), p.t.stats()
            assert tst == jst
            assert tst["mesh_demotion"] == "unsupported" and tst["mesh_gc"] == "host-directory"
            assert tst["mesh_converge_kernel"] == ("flat" if replicas == 1 else "tree")
            assert tst["mesh_routed_takes"] == 12
        finally:
            p.stop()

    def test_non_power_of_two_replicas_report_flat(self):
        t = MeshEngine(LimiterConfig(*CFG), replicas=3, devices=CPU8[:6])
        try:
            st = t.stats()
            assert (st["mesh_replicas"], st["mesh_shards"]) == (3, 2)
            assert st["mesh_converge_kernel"] == "flat"
        finally:
            t.stop()


class TestMeshResize:
    def test_grow_is_bit_exact_and_keeps_serving(self, device_path):
        p = Pair(replicas=1, jdevices=jax.devices()[:4], tdevices=CPU8[:4])
        try:
            p.same(lambda eng, R: [eng.take(f"rz-{i}", R(freq=10, per_ns=NANO), 3)[:2]
                                   for i in range(16)])
            tpn0, tel0 = p.t.snapshot_planes()
            gen0 = p.t._state_gen
            resizes0 = tprofiling.COUNTERS.get("mesh_resizes")
            jr = p.j.resize(replicas=2, devices=jax.devices())
            tr = p.t.resize(replicas=2, devices=CPU8)
            assert tr == jr and tr["devices"] == 8
            assert (p.t.plan.replicas, p.t.plan.shards) == (2, 4)
            assert p.t._state_gen == gen0 + 1
            assert tprofiling.COUNTERS.get("mesh_resizes") == resizes0 + 1
            tpn1, tel1 = p.t.snapshot_planes()
            assert np.array_equal(tpn0, tpn1) and np.array_equal(tel0, tel1)
            got = p.same(lambda eng, R: [eng.take(f"rz-{i}", R(freq=10, per_ns=NANO), 1)[:2]
                                         for i in range(16)]
                         + [eng.take("rz-new", R(freq=10, per_ns=NANO), 2)[:2]])
            assert got[:16] == [(6, True)] * 16 and got[16][1]
            p.assert_planes_equal()
        finally:
            p.stop()

    def test_shrink_back_is_bit_exact(self, device_path):
        p = Pair(replicas=2)
        try:
            p.both(lambda eng, R: eng.take("sh", R(freq=10, per_ns=NANO), 5))
            tpn0, tel0 = p.t.snapshot_planes()
            p.j.resize(replicas=1, devices=jax.devices()[:2])
            p.t.resize(replicas=1, devices=CPU8[:2])
            tpn1, tel1 = p.t.snapshot_planes()
            assert np.array_equal(tpn0, tpn1) and np.array_equal(tel0, tel1)
            assert p.same(lambda eng, R: eng.take("sh", R(freq=10, per_ns=NANO), 5)[:2]) == (0, True)
            p.assert_planes_equal()
        finally:
            p.stop()

    def test_invalid_target_rejected_without_stall(self, device_path):
        t = MeshEngine(LimiterConfig(*CFG), replicas=1, clock=FakeClock(), devices=CPU8[:4])
        try:
            with pytest.raises(ValueError):
                t.resize(replicas=1, devices=CPU8[:7])
            with pytest.raises(ValueError, match="one platform"):
                t.resize(replicas=1, devices=[torch.device("cpu"), torch.device("cuda", 0)])
            assert t.take("ok", Rate(freq=10, per_ns=NANO), 1)[1]
            assert t.plan.shards == 4
        finally:
            t.stop()

    @pytest.mark.parametrize("grow", [True, False])
    def test_no_lost_takes_across_resize(self, device_path, grow):
        t = MeshEngine(LimiterConfig(*CFG), replicas=1 if grow else 2, clock=FakeClock(),
                       devices=CPU8[:4] if grow else CPU8)
        try:
            results = []
            lock = threading.Lock()

            def worker():
                _, ok, _ = t.take("hot-rz", Rate(freq=10, per_ns=NANO), 1)
                with lock:
                    results.append(ok)

            threads = [threading.Thread(target=worker) for _ in range(32)]
            for th in threads[:16]:
                th.start()
            t.resize(replicas=2 if grow else 1, devices=CPU8 if grow else CPU8[:4])
            for th in threads[16:]:
                th.start()
            for th in threads:
                th.join()
            assert len(results) == 32 and sum(results) == 10
        finally:
            t.stop()


class TestMeshLifecycle:
    @pytest.mark.parametrize("replicas", [1, 2])
    def test_mesh_engine_gc_reclaims_via_host_directory(self, device_path, replicas):
        p = Pair(replicas=replicas)
        try:
            st = p.t.stats()
            assert st["mesh_demotion"] == "unsupported" and st["mesh_gc"] == "host-directory"
            p.same(lambda eng, R: eng.take("m", R(freq=10, per_ns=NANO), 3)[:2])
            p.j.flush()
            p.t.flush()
            assert p.same(lambda eng, R: eng.gc_sweep(force=True)) == 0  # spent: kept
            p.clock.advance(10 * NANO)
            assert p.same(lambda eng, R: eng.gc_sweep(force=True)) == 1  # refilled: reclaimed
            got = p.same(lambda eng, R: eng.take("m", R(freq=10, per_ns=NANO), 1)[:2])
            assert got == (9, True)  # tombstone reconstruction
            p.assert_planes_equal()
        finally:
            p.stop()


# -- the mesh over several pieces ---------------------------------------------------

# name → (the port's devices, piece_per_block, the reference's device count).
PIECE_LAYOUTS = {
    "distinct": (DISTINCT8, False, 8),
    "mixed": (MIXED8, False, 8),
    "per_block": (CPU8, True, 8),
    "distinct6": ([torch.device("cpu", i) for i in range(6)], False, 6),
    "per_block6": (CPU8[:6], True, 6),
}
PIECE_CASES = [(r, name) for r in (1, 2, 4) for name in ("distinct", "mixed", "per_block")] + [
    (3, "distinct6"), (3, "per_block6")]


def piece_pair(replicas, name, cfg=CFG, **kw):
    devices, ppb, n = PIECE_LAYOUTS[name]
    p = Pair(cfg=cfg, replicas=replicas, jdevices=jax.devices()[:n], tdevices=devices,
             piece_per_block=ppb, **kw)
    assert p.t.state is None and len(p.t._placed.states) > 1
    return p


@pytest.fixture(params=PIECE_CASES, ids=[f"{r}-{n}" for r, n in PIECE_CASES])
def pieces(request, device_path):
    p = piece_pair(*request.param)
    yield p
    p.stop()


class TestMeshPieces:
    """The port's MeshEngine over several pieces (distinct CPU devices, a
    mixed list, a piece a block) against the reference's MeshEngine on
    the virtual CPU mesh, call for call; tolerance 0."""

    def test_takes_route_and_converge(self, pieces):
        def run(eng, R):
            rate = R(freq=10, per_ns=NANO)
            out = [eng.take(f"p{i}", rate, 1 + i % 3)[:2] for i in range(40)]
            out += [eng.take("p0", rate, 1)[:2] for _ in range(10)]
            return out, [eng.tokens(f"p{i}") for i in range(40)]

        got, tokens = pieces.same(run)
        assert got[40:] == [(8 - i, True) for i in range(9)] + [(0, False)]
        pieces.assert_planes_equal()

    def test_concurrent_hot_bucket(self, pieces):
        def run(eng, R):
            results = []
            lock = threading.Lock()

            def worker():
                _, ok, _ = eng.take("hot", R(freq=10, per_ns=NANO), 1)
                with lock:
                    results.append(ok)

            threads = [threading.Thread(target=worker) for _ in range(24)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            return sum(results)

        assert pieces.same(run) == 10
        pieces.assert_planes_equal()

    def test_lane_and_scalar_merges_and_snapshots(self, pieces):
        """Lane deltas (the fused tick), reference-peer scalar deltas (the
        inherited scalar merge after the step), snapshots and tokens."""
        names = [f"m{i}" for i in range(12)]

        def run(eng, R):
            w = jwire if R is JRate else twire
            for nm in names[:6]:
                eng.take(nm, R(freq=10, per_ns=NANO), 2)
            eng.ingest_delta(w.from_nanotokens("m0", 0, 5 * NANO, 0, origin_slot=2), slot=2)
            eng.ingest_deltas_batch(names, [1] * 12, [50 + i for i in range(12)],
                                    [5 + i for i in range(12)], [NANO] * 12,
                                    caps_nt=[1000] * 12)
            eng.ingest_deltas_batch(names, [3] * 12, [-1] * 12, [-1] * 12, [NANO] * 12,
                                    caps_nt=[-1] * 12,
                                    lane_added_nt=[100 + i for i in range(12)],
                                    lane_taken_nt=[10 + i for i in range(12)])
            assert eng.flush(30)
            snaps = {nm: sorted((s.origin_slot, s.added_nt, s.taken_nt, s.lane_taken_nt)
                                for s in eng.snapshot(nm)) for nm in names}
            return [eng.tokens(nm) for nm in names], snaps

        pieces.same(run)
        pieces.assert_planes_equal()

    def test_straddling_tick_splits_bit_exact(self, device_path):
        """A drain past MESH_WARM_MAX a block on shard 0 with takes riding
        the boundary dispatch, over every piece layout at R = 2."""
        for name in ("distinct", "mixed", "per_block"):
            n = MESH_WARM_MAX * 2 + 999
            p = piece_pair(2, name, cfg=CFG_WIDE)
            try:
                d_rows = 100 + np.arange(n, dtype=np.int64)

                def run(eng, R):
                    cls, tcls = (JDeltas, JTicket) if R is JRate else (DeltaArrays, TakeTicket)
                    rate = R(freq=10, per_ns=NANO)
                    tickets = []
                    for i in range(8):
                        row, _ = eng._assign_pinned(f"tk{i}", 0)
                        eng.directory.init_cap_base(row, rate.freq * NANO)
                        for _ in range(3 if i == 0 else 1):
                            assert eng._assign_pinned(f"tk{i}", 0)[0] == row
                            tickets.append(tcls(f"tk{i}", row, rate, 1, 0))
                        eng.directory.unpin_rows([row])
                    eng._apply(lane_deltas(cls, d_rows, [0] * n, [7] * n, [3] * n, [11] * n),
                               tickets)
                    for t in tickets:
                        assert t.wait(30)
                    return [(t.name, t.remaining, t.ok) for t in tickets], eng.stats()

                (jout, jst), (tout, tst) = p.both(run)
                assert tout == jout and tst == jst
                assert tst["mesh_split_ticks"] == 1 and tst["mesh_sub_dispatches"] == 2
                p.assert_planes_equal()
            finally:
                p.stop()

    @pytest.mark.parametrize("replicas,name", [(1, "distinct"), (2, "mixed"), (2, "per_block"),
                                               (4, "distinct"), (3, "distinct6")])
    def test_gc_reclaim_and_release_bucket(self, device_path, replicas, name):
        p = piece_pair(replicas, name)
        try:
            p.same(lambda eng, R: [eng.take(f"g{i}", R(freq=10, per_ns=NANO), 3)[:2]
                                   for i in range(6)])
            assert p.same(lambda eng, R: eng.gc_sweep(force=True)) == 0  # spent: kept
            p.clock.advance(10 * NANO)
            assert p.same(lambda eng, R: eng.gc_sweep(force=True)) == 6  # refilled
            got = p.same(lambda eng, R: eng.take("g0", R(freq=10, per_ns=NANO), 1)[:2])
            assert got == (9, True)
            p.same(lambda eng, R: eng.take("rel", R(freq=10, per_ns=NANO), 4)[:2])
            assert p.same(lambda eng, R: eng.release_bucket("rel", timeout=30)) is True
            assert p.same(lambda eng, R: eng.take("rel", R(freq=10, per_ns=NANO), 1)[:2]) == (9, True)
            p.assert_planes_equal()
        finally:
            p.stop()

    def test_checkpoint_restores_across_layouts(self, tmp_path, pieces):
        pieces.both(lambda eng, R: [eng.take(f"c{i}", R(freq=10, per_ns=NANO), 1 + i)
                                    for i in range(5)])
        jckpt.save(str(tmp_path / "j"), pieces.j)
        tckpt.save(str(tmp_path / "t"), pieces.t)
        jpn, jel = np.load(tmp_path / "j" / "state.npz").values()
        tpn, tel = np.load(tmp_path / "t" / "state.npz").values()
        assert np.array_equal(jpn, tpn) and np.array_equal(jel, tel)
        targets = [MeshEngine(LimiterConfig(*CFG), replicas=2, clock=FakeClock(),
                              devices=DISTINCT8),
                   MeshEngine(LimiterConfig(*CFG), replicas=1, clock=FakeClock(), devices=CPU8)]
        j2 = JMesh(JConfig(*CFG), replicas=2, node_slot=0, clock=FakeClock())
        try:
            want = jckpt.restore(str(tmp_path / "j"), j2)
            jp = j2.snapshot_planes()
            for t2 in targets:
                assert tckpt.restore(str(tmp_path / "t"), t2) == want
                assert [t2.tokens(f"c{i}") for i in range(5)] == [j2.tokens(f"c{i}")
                                                                  for i in range(5)]
                tp = t2.snapshot_planes()
                assert np.array_equal(np.asarray(jp[0]), tp[0])
                assert np.array_equal(np.asarray(jp[1]), tp[1])
        finally:
            j2.stop()
            for t2 in targets:
                t2.stop()

    def test_scrapes_and_read_rows(self, pieces):
        def run(eng, R):
            for i in range(10):
                eng.take(f"s{i}", R(freq=10, per_ns=NANO), 1 + i % 4)
            assert eng.flush(30)
            rows = np.array([eng.directory.lookup(f"s{i}") for i in range(10)] + [0, 63])
            pn, el = eng.read_rows(rows)
            many = eng.snapshot_many([f"s{i}" for i in range(10)])
            return (np.asarray(pn).tolist(), np.asarray(el).tolist(),
                    {k: sorted((s.origin_slot, s.taken_nt) for s in v) for k, v in many.items()},
                    [eng.tokens_if_known(f"s{i}") for i in range(10)])

        pieces.same(run)

    def test_family_calls(self, pieces):
        """GCRA, concurrency and the hierarchical quota, whose three rows
        a path lie in different shards; duplicate, negative and
        out-of-range rows; results and planes equal, every copy of a
        shard written."""
        rows = np.array([0, 9, 17, 33, 47, 63], np.int32)

        def run(eng, R):
            out = []
            for now in (1_000, 1_100):
                out.append(eng.gcra_take(rows, now, 100, 300, 5))
            out.append(eng.gcra_take([1, 2, 2, -1, 70, -200], 5_000, 100, 300, 3))
            out.append(eng.conc_acquire(rows + 1, 5, 1, 8, 0))
            out.append(eng.conc_acquire(rows + 1, 5, 1, 4, 2))
            out.append(eng.quota_take([6, 6], [30, 31], [50, 60], 10, 6, 4, 1, 5))
            out.append(eng.quota_take([6, 6], [30, 31], [50, 60], 10, 6, 4, 1, 5))
            out.append(eng.quota_take([40] * 3, [41, 42, 41], [42, 43, 41], 9, 5, 4, 1, -2))
            return [[np.asarray(f).tolist() for f in res] for res in out]

        got = pieces.same(run)
        assert sum(got[5][0]) == 8  # quota admitted 4 + 4 on its first call
        pieces.assert_planes_equal()
        t = pieces.t
        for s in range(t.plan.shards):
            copies = [st.pn[sp.shards.index(s) * t.plan.rows_per_shard:
                            (sp.shards.index(s) + 1) * t.plan.rows_per_shard]
                      for sp, st in zip(t._placed.specs, t._placed.states) if s in sp.shards]
            assert all(torch.equal(c, copies[0]) for c in copies[1:]), s

    def test_stats_keep_the_reference_keys(self, pieces):
        pieces.both(lambda eng, R: [eng.take(f"k{i}", R(freq=10, per_ns=NANO), 1)
                                    for i in range(8)])
        pieces.j.flush()
        pieces.t.flush()
        assert pieces.t.stats() == pieces.j.stats()


class TestMeshPiecesResize:
    @pytest.mark.parametrize("name", ["distinct", "per_block"])
    def test_grow_4_to_8_is_bit_exact(self, device_path, name):
        devices, ppb, _ = PIECE_LAYOUTS[name]
        p = Pair(replicas=1, jdevices=jax.devices()[:4], tdevices=devices[:4],
                 piece_per_block=ppb)
        try:
            p.same(lambda eng, R: [eng.take(f"rz-{i}", R(freq=10, per_ns=NANO), 3)[:2]
                                   for i in range(16)])
            tpn0, tel0 = p.t.snapshot_planes()
            jr = p.j.resize(replicas=2, devices=jax.devices())
            tr = p.t.resize(replicas=2, devices=devices, piece_per_block=ppb)
            assert tr == jr and len(p.t._placed.states) == 8
            tpn1, tel1 = p.t.snapshot_planes()
            assert np.array_equal(tpn0, tpn1) and np.array_equal(tel0, tel1)
            got = p.same(lambda eng, R: [eng.take(f"rz-{i}", R(freq=10, per_ns=NANO), 1)[:2]
                                         for i in range(16)])
            assert got == [(6, True)] * 16
            p.assert_planes_equal()
        finally:
            p.stop()

    @pytest.mark.parametrize("name", ["distinct", "mixed", "per_block"])
    def test_shrink_8_to_4_is_bit_exact(self, device_path, name):
        devices, ppb, _ = PIECE_LAYOUTS[name]
        p = piece_pair(2, name)
        try:
            p.both(lambda eng, R: eng.take("sh", R(freq=10, per_ns=NANO), 5))
            tpn0, tel0 = p.t.snapshot_planes()
            p.j.resize(replicas=1, devices=jax.devices()[:4])
            p.t.resize(replicas=1, devices=devices[:4], piece_per_block=ppb)
            tpn1, tel1 = p.t.snapshot_planes()
            assert np.array_equal(tpn0, tpn1) and np.array_equal(tel0, tel1)
            assert p.same(lambda eng, R: eng.take("sh", R(freq=10, per_ns=NANO), 5)[:2]) == (0, True)
            p.assert_planes_equal()
        finally:
            p.stop()

    @pytest.mark.parametrize("name", ["distinct", "per_block"])
    def test_one_piece_to_eight_and_back_under_load(self, device_path, name):
        """Takes straddle a resize from one piece (``cpu`` × 8) onto eight
        and back: every take answered, capacity held exactly."""
        devices, ppb, _ = PIECE_LAYOUTS[name]
        t = MeshEngine(LimiterConfig(*CFG), replicas=2, clock=FakeClock(), devices=CPU8)
        try:
            assert t.state is not None
            results = []
            lock = threading.Lock()

            def worker():
                _, ok, _ = t.take("hot-rz", Rate(freq=10, per_ns=NANO), 1)
                with lock:
                    results.append(ok)

            threads = [threading.Thread(target=worker) for _ in range(36)]
            for th in threads[:12]:
                th.start()
            t.resize(replicas=2, devices=devices, piece_per_block=ppb)
            assert t.state is None and len(t._placed.states) == 8
            for th in threads[12:24]:
                th.start()
            t.resize(replicas=2, devices=CPU8)
            assert t.state is not None
            for th in threads[24:]:
                th.start()
            for th in threads:
                th.join()
            assert len(results) == 36 and sum(results) == 10
        finally:
            t.stop()


class TestMeshPiecesCommand:
    def test_command_serves_over_distinct_devices(self):
        """``Command(mesh_replicas=2, mesh_devices=[cpu:0 .. cpu:7])``
        serves HTTP takes; its outcomes and planes equal the reference's
        MeshEngine fed the same takes on the same frozen clock."""
        import http.client

        from patrol_tpu_torch.command import Command

        clock = FakeClock(1_700_000_000 * NANO)
        cmd = Command(api_addr=f"127.0.0.1:{_free_port()}",
                      node_addr=f"127.0.0.1:{_free_port(socket.SOCK_DGRAM)}",
                      shutdown_timeout_s=5.0, config=LimiterConfig(*CFG), clock=clock,
                      handle_signals=False, device="cpu", udp_backend="asyncio",
                      http_front="python", mesh_replicas=2, mesh_devices=DISTINCT8)
        j = JMesh(JConfig(*CFG), replicas=2, node_slot=0, clock=clock)
        loop = asyncio.new_event_loop()
        stop = asyncio.Event()
        th = threading.Thread(target=lambda: loop.run_until_complete(cmd.run(stop)), daemon=True)
        th.start()
        try:
            deadline = time.time() + 60
            while not cmd.started.is_set() and time.time() < deadline:
                time.sleep(0.05)
            assert cmd.started.is_set()
            eng = cmd.engine
            assert isinstance(eng, MeshEngine) and len(eng._placed.states) == 8
            got, want = [], []
            for i in range(14):
                name, count = f"cmd{i % 5}", 1 + i % 3
                conn = http.client.HTTPConnection("127.0.0.1", cmd.api_port, timeout=30)
                conn.request("POST", f"/take/{name}?rate=5:1h&count={count}")
                resp = conn.getresponse()
                got.append((resp.status, resp.read()))
                conn.close()
                rem, ok, _ = j.take(name, JRate(freq=5, per_ns=3600 * NANO), count)
                want.append((200 if ok else 429, str(rem).encode()))
            assert got == want
            assert eng.flush(30) and j.flush(30)
            tpn, tel = eng.snapshot_planes()
            jpn, jel = j.snapshot_planes()
            assert np.array_equal(np.asarray(jpn), tpn) and np.array_equal(np.asarray(jel), tel)
        finally:
            loop.call_soon_threadsafe(stop.set)
            th.join(timeout=15)
            j.stop()
