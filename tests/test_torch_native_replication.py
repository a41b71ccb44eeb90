"""The port's native UDP backend (``net/native_replication.py``) over
loopback, against itself and against the JAX package's, and the native
tick fold against the numpy fold.

Nodes run in this process on the CPU (``device="cpu"``, the kernels'
plain versions) with FROZEN clocks, as in ``tests/test_torch_replication.py``
(whose helpers this file reuses): the converged lane planes are exact,
and every admitted take is one token in its node's lane.

* two port nodes on the native backend converge, clean and under a
  seeded faultnet drop/dup/reorder schedule (which runs the per-packet
  path), and their delta traffic went through the rx ring and raw
  ``decode_fold`` launches: once the nodes have stopped, ring leases and
  commits are equal and above zero;
* a port node on the native backend against a ``patrol_tpu`` node on its
  native backend, clean and under faultnet;
* a reference-semantics v1 peer against a port node on the native
  backend, both ways: ``tests/test_interop.py``'s cases;
* the ring path on its own: one delta interval from a bare
  ``NativeReplicator`` lands bit-exactly through ``ingest_raw_planes``
  (``tests/test_ingest.py``'s twin), and a 160-bucket interval packs into
  a few 8 KiB datagrams the rx ring receives whole
  (``tests/test_delta.py``'s twin);
* a replicator with an unresolvable peer starts and broadcasts
  (``tests/test_faultnet.py``'s twin; the resolver is stubbed, so no name
  is looked up);
* ``--udp-backend native`` serves and replicates from the CLI;
* the native fold (``pt_fold_hybrid``) equals the numpy fold and the JAX
  package's fold bit for bit on clustered batches (threaded shards too),
  falls back on uniform ones, and is counted in ``fold_native_ticks``.

The traffic is small: a shared CPU runs these within the tier-1 limit.
"""

import json
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from patrol_tpu.command import Command as JCommand
from patrol_tpu.models.limiter import LimiterConfig as JConfig
from patrol_tpu.ops.rate import Rate as JRate
from patrol_tpu.runtime import engine as jengine_mod
from patrol_tpu_torch import native
from patrol_tpu_torch.models.limiter import NANO
from patrol_tpu_torch.models.limiter import LimiterConfig as TConfig
from patrol_tpu_torch.net import native_replication
from patrol_tpu_torch.net.faultnet import FaultNet
from patrol_tpu_torch.net.native_replication import NativeReplicator
from patrol_tpu_torch.net.replication import SlotTable
from patrol_tpu_torch.net.v1node import V1Node
from patrol_tpu_torch.ops import wire
from patrol_tpu_torch.ops.rate import Rate as TRate
from patrol_tpu_torch.runtime import engine as tengine_mod
from patrol_tpu_torch.runtime.engine import DeltaArrays, DeviceEngine
from patrol_tpu_torch.runtime.repo import TPURepo
from patrol_tpu_torch.utils import histogram as hist_mod
from patrol_tpu_torch.utils import profiling
from test_torch_replication import (  # noqa: F401  (budget is a fixture)
    BUCKETS,
    CHAOS,
    FROZEN,
    NODES,
    Node,
    budget,
    converge,
    drive_takes,
    free_port,
    port_cmd,
    taken_tokens,
    wait_capable,
)

PORT_RATE = TRate(freq=100, per_ns=3600 * NANO)
REPO = Path(native.__file__).resolve().parents[2]


def native_port_cmd(addr, addrs, **kw):
    return port_cmd(addr, addrs, udp_backend="native", **kw)


def native_jax_cmd(addr, addrs):
    return JCommand(
        api_addr=f"127.0.0.1:{free_port(socket.SOCK_STREAM)}", node_addr=addr,
        peer_addrs=addrs, clock=lambda: FROZEN, config=JConfig(BUCKETS, NODES),
        handle_signals=False, shutdown_timeout_s=5.0, http_front="python",
        udp_backend="native",
    )


def ring_counts(rep):
    """(leases, commits) of a replicator's rx ring. Read once the node
    has stopped, the two must be equal: every plane leased, by the rx
    loop or by a batch in flight to the engine, came back."""
    st = rep._rx_ring.stats()
    return st["rx_ring_leases"], st["rx_ring_commits"]


def run_faults(cmds, faults, seed):
    nets = []
    if faults:
        for i, c in enumerate(cmds):
            fn = FaultNet(seed=seed + i, self_addr=c.node_addr)
            fn.link(**CHAOS)
            c.replicator.faultnet = fn
            nets.append(fn)
    return nets


def heal(nets, budget):
    # Keep the faults on until they have acted on some traffic: takes
    # served from host lanes return at once, and the delta plane ships
    # their state on its next interval.
    while nets and not sum(fn.dropped + fn.duplicated + fn.reordered for fn in nets):
        assert time.monotonic() < budget, "no datagram crossed the faulty links"
        time.sleep(0.01)
    for fn in nets:
        fn.heal()
        fn.link()  # clean links; held packets still release


@pytest.mark.parametrize("faults", [False, True], ids=["clean", "faultnet"])
def test_two_native_port_nodes_converge(faults, budget):
    addrs = [f"127.0.0.1:{free_port()}" for _ in range(2)]
    nodes = []
    try:
        for a in addrs:
            nodes.append(Node(native_port_cmd(a, addrs)))
        cmds = [n.cmd for n in nodes]
        assert all(isinstance(c.replicator, NativeReplicator) for c in cmds)
        wait_capable(cmds, budget)
        names = [f"n{i}" for i in range(16)]
        planes0 = hist_mod.RAW_PLANES.to_lattice()["counts"][0]
        # Prime every bucket on both nodes before any fault: this traffic
        # rides the ring.
        for c in cmds:
            for nm in names:
                assert c.repo.take(nm, PORT_RATE, 1)[1]
        converge(cmds, names, budget)
        nets = run_faults(cmds, faults, seed=91)
        admitted = 2 * len(names) + drive_takes(
            cmds, names, 60, lambda c: PORT_RATE, seed=3
        )
        heal(nets, budget)
        view = converge(cmds, names, budget, retrigger=faults)
        assert admitted == 2 * len(names) + 60
        assert taken_tokens(view) == admitted
        stats = [c.replicator.stats() for c in cmds]
        assert all(s["wire_delta_rx_packets"] > 0 for s in stats)
        assert all(s["replication_backend"] == 1 for s in stats)
        planes = hist_mod.RAW_PLANES.to_lattice()["counts"][0]
        assert sum(planes) > sum(planes0)  # raw decode_fold launches
        if faults:
            assert sum(fn.dropped + fn.duplicated + fn.reordered for fn in nets) > 0
    finally:
        for c in [n.cmd for n in nodes]:
            c.replicator.faultnet = None
        for n in nodes:
            n.close()
    for c in cmds:
        leases, commits = ring_counts(c.replicator)
        assert leases == commits and commits > 0


@pytest.mark.parametrize("faults", [False, True], ids=["clean", "faultnet"])
def test_native_port_node_against_native_jax_node(monkeypatch, faults, budget):
    # Host fast path off on the JAX node: every take rides its device
    # queue, as on the port.
    monkeypatch.setattr(jengine_mod, "HOST_FASTPATH", False)
    monkeypatch.setattr(tengine_mod, "HOST_FASTPATH", False)
    addrs = [f"127.0.0.1:{free_port()}" for _ in range(2)]
    nodes = []
    try:
        nodes.append(Node(native_jax_cmd(addrs[0], addrs)))
        nodes.append(Node(native_port_cmd(addrs[1], addrs)))
        cmds = [n.cmd for n in nodes]
        assert type(cmds[0].replicator).__module__ == "patrol_tpu.net.native_replication"
        assert isinstance(cmds[1].replicator, NativeReplicator)
        wait_capable(cmds, budget)
        rates = {id(cmds[0]): JRate(freq=100, per_ns=3600 * NANO),
                 id(cmds[1]): PORT_RATE}
        names = [f"x{i}" for i in range(16)]
        for c in cmds:
            for nm in names:
                assert c.repo.take(nm, rates[id(c)], 1)[1]
        converge(cmds, names, budget)
        nets = run_faults(cmds, faults, seed=77)
        admitted = 2 * len(names) + drive_takes(
            cmds, names, 64, lambda c: rates[id(c)], seed=2
        )
        heal(nets, budget)
        view = converge(cmds, names, budget, retrigger=faults)
        assert admitted == 2 * len(names) + 64
        assert taken_tokens(view) == admitted
        assert all(c.replicator.stats()["wire_delta_rx_packets"] > 0 for c in cmds)
        if faults:
            assert sum(fn.dropped + fn.duplicated + fn.reordered for fn in nets) > 0
    finally:
        for c in [n.cmd for n in nodes]:
            c.replicator.faultnet = None
        for n in nodes:
            n.close()
    leases, commits = ring_counts(cmds[1].replicator)
    assert leases == commits and commits > 0


class FakeClock:
    def __init__(self, start: int = 1_000 * NANO):
        self.now = start

    def __call__(self) -> int:
        return self.now

    def advance(self, seconds: float) -> None:
        self.now += int(seconds * NANO)


RATE = TRate(freq=10, per_ns=NANO)  # 10 tokens / second


class MixedCluster:
    """``tests/test_interop.py``'s cluster on the port: one port node on
    the native backend and one v1 (reference-semantics) node, one shared
    injected clock."""

    def __init__(self):
        self.clock = FakeClock()
        tpu_port, v1_port = free_port(), free_port()
        tpu_addr, v1_addr = f"127.0.0.1:{tpu_port}", f"127.0.0.1:{v1_port}"
        slots = SlotTable(tpu_addr, [v1_addr], max_slots=4)
        self.engine = DeviceEngine(
            TConfig(buckets=64, nodes=4), node_slot=slots.self_slot,
            clock=self.clock, device="cpu",
        )
        self.replicator = NativeReplicator(tpu_addr, [v1_addr], slots)
        self.repo = TPURepo(self.engine, send_incast=self.replicator.send_incast_request)
        self.replicator.repo = self.repo
        self.engine.on_broadcast = self.replicator.broadcast_states
        self.v1 = V1Node(v1_addr, [tpu_addr], clock=self.clock)

    def settle(self, timeout: float = 3.0) -> None:
        """Let in-flight UDP drain and the engine apply it."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            time.sleep(0.05)
            before = self.replicator.rx_packets
            self.engine.flush()
            time.sleep(0.05)
            if self.replicator.rx_packets == before:
                return

    def close(self):
        self.v1.close()
        self.replicator.close()
        self.engine.stop()


@pytest.fixture
def cluster():
    c = MixedCluster()
    yield c
    c.close()


class TestV1PeerAgainstANativePortNode:
    def test_reference_peer_sees_capacity_included_state(self, cluster):
        remaining, ok = cluster.repo.take("shared", RATE, 3)
        assert ok and remaining == 7
        cluster.settle()
        bucket, existed = cluster.v1.repo.get_bucket("shared")
        assert existed and bucket.tokens() == 7

    def test_reference_peer_enforces_jointly(self, cluster):
        cluster.repo.take("joint", RATE, 4)
        cluster.settle()
        remaining, ok = cluster.v1.take("joint", RATE, 6)
        assert ok and remaining == 0
        assert not cluster.v1.take("joint", RATE, 1)[1]  # 4 + 6 = capacity

    def test_failed_take_still_announces_capacity(self, cluster):
        assert not cluster.repo.take("tight", RATE, 11)[1]  # over capacity
        cluster.settle()
        bucket, existed = cluster.v1.repo.get_bucket("tight")
        assert existed and bucket.tokens() == 10  # cap announced, nothing taken

    def test_v1_state_converges_via_incast(self, cluster):
        remaining, ok = cluster.v1.take("vk", RATE, 4)
        assert ok and remaining == 6
        cluster.settle()  # arrives before the bucket exists here: dropped
        assert cluster.repo.take("vk", RATE, 1)[1]
        cluster.settle()  # incast round trip + deficit ingest
        v1_bucket, _ = cluster.v1.repo.get_bucket("vk")
        assert v1_bucket.tokens() == cluster.engine.tokens("vk")

    def test_echo_does_not_double_count(self, cluster):
        cluster.repo.take("echo", RATE, 2)
        cluster.settle()
        for _ in range(3):
            cluster.v1.take("echo", RATE, 1)
            cluster.settle()
        v1_bucket, _ = cluster.v1.repo.get_bucket("echo")
        assert v1_bucket.tokens() == 5 and cluster.engine.tokens("echo") == 5

    def test_cluster_wide_limit_with_mixed_admissions(self, cluster):
        admitted = 0
        for i in range(14):
            node = cluster.repo if i % 2 == 0 else cluster.v1
            admitted += int(node.take("mix", RATE, 1)[1])
            cluster.settle()
        assert admitted == 10  # exactly capacity, no refill (clock frozen)
        v1_bucket, _ = cluster.v1.repo.get_bucket("mix")
        assert cluster.engine.tokens("mix") == 0 and v1_bucket.tokens() == 0

    def test_refill_agreement_across_time(self, cluster):
        cluster.repo.take("rf", RATE, 10)
        cluster.settle()
        assert not cluster.v1.take("rf", RATE, 1)[1]  # drained
        cluster.clock.advance(0.5)  # 5 tokens refill at 10/s
        remaining, ok = cluster.v1.take("rf", RATE, 5)
        assert ok and remaining == 0
        cluster.settle()
        assert cluster.engine.tokens("rf") == 0


def _bare_pair(clock=lambda: NANO, buckets=64):
    """Two bare NativeReplicators in delta mode, each with a CPU engine and
    repo, the delta planes paced by hand."""
    addrs = sorted(f"127.0.0.1:{free_port()}" for _ in range(2))
    nodes = []
    for a in addrs:
        slots = SlotTable(a, addrs, max_slots=4)
        rep = NativeReplicator(a, addrs, slots, wire_mode="delta")
        rep.delta.close()  # manual pacing
        eng = DeviceEngine(TConfig(buckets=buckets, nodes=4), node_slot=slots.self_slot,
                           clock=clock, device="cpu")
        repo = TPURepo(eng, send_incast=None)
        rep.repo = repo
        eng.on_broadcast = rep.broadcast_states
        nodes.append((rep, eng, repo))
    return addrs, nodes


def _close_pair(nodes):
    for rep, eng, _ in nodes:
        rep.close()
        eng.stop()


def test_native_backend_uses_ring_for_delta_rx(budget):
    addrs, nodes = _bare_pair()
    try:
        (r0, _, _), (r1, e1, _) = nodes
        assert r1._rx_ring is not None
        r0.delta.mark_capable(("127.0.0.1", int(addrs[1].rpartition(":")[2])), 8192)
        before = profiling.COUNTERS.get("ingest_raw_device_dispatches")
        states = [
            wire.from_nanotokens(
                f"rb{i}", 2 * NANO, NANO, 100 + i, origin_slot=r0.slots.self_slot,
                cap_nt=NANO, lane_added_nt=NANO, lane_taken_nt=NANO // 2,
            )
            for i in range(50)
        ]
        r0.delta.offer(states)
        r0.delta.flush()
        while e1.directory.lookup("rb49") is None:
            assert time.monotonic() < budget, "the interval never arrived"
            time.sleep(0.02)
        assert e1.flush(timeout=30)
        pn, el = e1.row_view(e1.directory.lookup("rb49"))
        lane = r0.slots.self_slot
        assert int(pn[lane, 0]) == NANO and int(pn[lane, 1]) == NANO // 2
        assert el == 149
        assert profiling.COUNTERS.get("ingest_raw_device_dispatches") > before
    finally:
        _close_pair(nodes)
    leases, commits = ring_counts(r1)
    assert leases == commits and commits > 0


def test_native_backend_full_interval_convergence(budget):
    """The ring rows are 8 KiB, so the backend advertises the full delta
    bound and receives whole multi-KB intervals; the pair converges."""
    from patrol_tpu_torch.net.antientropy import state_digest

    _, nodes = _bare_pair(buckets=512)
    try:
        while True:
            for rep, _, _ in nodes:
                rep.delta.flush()
            if all(len(r.delta.capable_peers()) == 1 for r, _, _ in nodes):
                break
            assert time.monotonic() < budget, "the dv2 handshake did not complete"
            time.sleep(0.02)
        for rep, _, _ in nodes:
            with rep.delta._mu:
                assert all(st.max_rx == wire.DELTA_PACKET_SIZE
                           for st in rep.delta._peers.values() if st.capable)
        names = [f"n{i:03d}" for i in range(160)]
        for t in range(160):
            assert nodes[0][2].take(names[t], TRate(freq=10, per_ns=NANO), 1)[1]
        nodes[0][1].flush()
        nodes[0][0].delta.flush()
        digs = [{}, {}]
        while True:
            nodes[0][0].delta.flush()  # retransmit safety net
            nodes[1][0].delta.flush()  # acks
            for k, (_, eng, _) in enumerate(nodes):
                eng.flush()
                digs[k] = {n: state_digest(s) for n, s in eng.snapshot_many(names).items()}
            if len(digs[0]) == 160 and digs[0] == digs[1]:
                break
            assert time.monotonic() < budget, "the pair did not converge"
            time.sleep(0.05)
        st = nodes[0][0].delta.stats()
        assert st["wire_deltas_batched"] >= 160
        assert 0 < st["wire_delta_packets_tx"] <= 4  # a few 8 KiB datagrams
        assert nodes[1][0].delta.stats()["wire_delta_rx_errors"] == 0
    finally:
        _close_pair(nodes)
    leases, commits = ring_counts(nodes[1][0])
    assert leases == commits and commits > 0


def test_native_replicator_survives_unresolvable_peer(monkeypatch):
    bogus = "patrol-native-test.invalid:9"
    monkeypatch.setattr(
        native_replication, "_resolve",
        lambda addr: ("patrol-native-test.invalid", 9) if addr == bogus else addr,
    )
    port = free_port()
    slots = SlotTable(f"127.0.0.1:{port}", [bogus], max_slots=4)
    rep = NativeReplicator(f"127.0.0.1:{port}", [bogus], slots)
    try:
        assert rep.peers == []
        assert rep.stats()["peer_unresolved"] == 1
        rep.broadcast_states([wire.from_nanotokens("x", 1, 1, 1, origin_slot=0, cap_nt=1)])
    finally:
        rep.close()


def test_cli_serves_and_replicates_on_the_native_backend():
    import http.client
    import signal

    def start(api, me, peers):
        args = [sys.executable, "-m", "patrol_tpu_torch", "--api-addr", f"127.0.0.1:{api}",
                "--node-addr", me, "--udp-backend", "native", "--buckets", "64",
                "--node-lanes", "4", "--device", "cpu", "--no-warmup"]
        for p in peers:
            args += ["--peer-addr", p]
        return subprocess.Popen(args, cwd=REPO, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    def get(api, method, target):
        conn = http.client.HTTPConnection("127.0.0.1", api, timeout=10)
        conn.request(method, target)
        resp = conn.getresponse()
        body = resp.read()
        conn.close()
        return resp.status, body

    apis = [free_port(socket.SOCK_STREAM) for _ in range(2)]
    addrs = [f"127.0.0.1:{free_port()}" for _ in range(2)]
    procs = [start(apis[i], addrs[i], addrs) for i in range(2)]
    try:
        deadline = time.monotonic() + 120
        for p, api in zip(procs, apis):
            while True:
                assert p.poll() is None, p.communicate()[1]
                try:
                    get(api, "GET", "/debug/vars")
                    break
                except OSError:
                    assert time.monotonic() < deadline, "a node did not start serving"
                    time.sleep(0.1)
        assert get(apis[0], "POST", "/take/demo?rate=8:1m&count=3") == (200, b"5")
        while True:
            status, body = get(apis[1], "GET", "/tokens/demo")
            if status == 200 and body == b"5":
                break
            assert time.monotonic() < deadline, f"not replicated: {status} {body!r}"
            time.sleep(0.1)
        stats = json.loads(get(apis[1], "GET", "/debug/vars")[1])
        assert stats["replication_backend"] == 1 and stats["device"] == "cpu"
        assert stats["replication_rx_packets"] > 0
        for p in procs:
            p.send_signal(signal.SIGINT)
        assert [p.wait(timeout=60) for p in procs] == [0, 0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
            p.stdout.close()
            p.stderr.close()


# -- the native tick fold ------------------------------------------------------


def _batch(rng, n, rows, nodes):
    return DeltaArrays(
        rng.choice(rows, n).astype(np.int64),
        rng.integers(0, nodes, n).astype(np.int64),
        rng.integers(0, 1 << 50, n).astype(np.int64),
        rng.integers(0, 1 << 50, n).astype(np.int64),
        rng.integers(0, 1 << 50, n).astype(np.int64),
        np.zeros(n, bool),
    )


def _same(a, b):
    packed_a, dense_a = a
    packed_b, dense_b = b
    np.testing.assert_array_equal(packed_a, packed_b)
    assert (dense_a is None) == (dense_b is None)
    if dense_a is not None:
        for x, y in zip(dense_a, dense_b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("shape,threads", [
    ("hot", None), ("clustered", None), ("clustered", "4"), ("dense_cap", "3"),
])
def test_native_fold_equals_numpy_and_the_jax_fold(shape, threads, monkeypatch):
    if threads:
        monkeypatch.setenv("PATROL_FOLD_THREADS", threads)
    rng = np.random.default_rng({"hot": 1, "clustered": 2, "dense_cap": 3}[shape])
    nodes, dense_min = 16, 6
    n, rows = {
        "hot": (4096, rng.integers(0, 1 << 20, 4)),  # a few hot rows: all dense
        "clustered": (3000, rng.integers(0, 1 << 20, 300)),  # dense and sparse rows
        "dense_cap": (20000, np.arange(700)),  # past MAX_ROW_DENSE dense rows
    }[shape]
    deltas = _batch(rng, n, rows, nodes)
    before = profiling.COUNTERS.get("fold_native_ticks")
    native_res = tengine_mod._fold_hybrid_native(deltas, nodes, dense_min)
    assert native_res is not None
    want = tengine_mod.fold_hybrid_numpy(deltas, nodes, dense_min)
    _same(native_res, want)
    _same(tengine_mod.fold_hybrid(deltas, nodes, dense_min), want)
    assert profiling.COUNTERS.get("fold_native_ticks") == before + 1
    _same(jengine_mod.fold_hybrid(jengine_mod.DeltaArrays(*deltas), nodes, dense_min), want)
    assert want[1] is not None  # a dense half was formed
    if shape == "clustered":
        assert tengine_mod._live(want[0][0]) > 0  # and a sparse one


@pytest.mark.parametrize("shape", ["uniform", "small"])
def test_native_fold_falls_back_to_numpy(shape):
    rng = np.random.default_rng(9)
    n, rows = {"uniform": (4096, np.arange(1 << 20)), "small": (512, np.arange(4))}[shape]
    deltas = _batch(rng, n, rows, 8)
    assert tengine_mod._fold_hybrid_native(deltas, 8, 4) is None
    before = profiling.COUNTERS.get("fold_native_ticks")
    _same(tengine_mod.fold_hybrid(deltas, 8, 4), tengine_mod.fold_hybrid_numpy(deltas, 8, 4))
    assert profiling.COUNTERS.get("fold_native_ticks") == before


def test_engine_tick_folds_natively_and_matches_the_jax_engine(monkeypatch):
    # One queued chunk of 2,048 deltas on 8 rows: the feeder's fold runs
    # in C++ and the planes equal the JAX engine's.
    monkeypatch.setenv("PATROL_TICK_FOLD", "1")
    rng = np.random.default_rng(12)
    deltas = _batch(rng, 2048, np.arange(8), 4)
    names = [f"h{r}" for r in deltas.rows.tolist()]
    planes = []
    for Eng, Cfg, kw in ((DeviceEngine, TConfig, {"device": "cpu"}),
                         (jengine_mod.DeviceEngine, JConfig, {})):
        eng = Eng(Cfg(buckets=64, nodes=4), node_slot=0, clock=lambda: NANO, **kw)
        try:
            before = profiling.COUNTERS.get("fold_native_ticks")
            # One chunk: the feeder drains it whole into one tick.
            eng.ingest_deltas_batch(
                names, deltas.slots, deltas.added_nt, deltas.taken_nt, deltas.elapsed_ns,
            )
            assert eng.flush(60)
            if Eng is DeviceEngine:
                assert profiling.COUNTERS.get("fold_native_ticks") > before
            pn, el = eng.snapshot_planes()
            planes.append((np.asarray(pn), np.asarray(el)))
        finally:
            eng.stop()
    np.testing.assert_array_equal(planes[0][0], planes[1][0])
    np.testing.assert_array_equal(planes[0][1], planes[1][1])


def test_native_load_is_required_by_the_native_backend(monkeypatch):
    def fail(required=False):
        if required:
            raise native.NativeBuildError("g++ failed (rc 1):\nno compiler")
        return None

    monkeypatch.setattr(native, "load", fail)
    assert not native_replication.available()
    with pytest.raises(native.NativeBuildError, match="no compiler"):
        NativeReplicator(f"127.0.0.1:{free_port()}", [], SlotTable(
            f"127.0.0.1:{free_port()}", [], max_slots=4))
