"""The 64-member, 1M-bucket fan-in (``patrol-64node-1m-uniform`` under
``deltas-fanin-uniform-paced``) on the CPU, and the histograms that its
per-layer metrics read.

* The deltas benchmark's kind at the deployment's shape, 64 members (63
  simulated peers, each flushing one interval a tick) and 64 lanes, with
  the key space cut to 4,096 keys and rows: the node's state agrees with
  the plain reference, and the reference's control (float64) and both of
  its planted faults do not.
* On a lone native-backend node, ``delta_flush_ns`` gains one record a
  ``DeltaPlane.flush``, ``delta_mu_wait_ns`` one a receive batch (with its
  ``rx.mu_wait`` ring event), and ``ingest_directory_ns`` one a raw
  ``decode_fold`` launch.
* ``pt_send_pairs`` sends each row to its own peer, in order; a row the
  kernel refuses (port 0) costs only itself, on the socket and in a native
  node's counters; and a native node's flush tick sends every peer's
  datagrams in that one call.
* ``antientropy.digests_of`` (the anti-entropy trigger's and the audit
  tick's digests, from one batched row read) gives each bucket the
  digest that ``state_digest`` gives its snapshot.
* Closing anti-entropy or the audit drops their queued jobs and waits
  for the one in hand, which reads engine state the node frees next.
* The readers of ``replication.flush_ms``, ``replication.mu_wait_ms`` and
  ``ingest.directory_ms`` give each histogram's mean in ms, and nothing
  where the program keeps no such histogram or it holds no record.
"""

import importlib.util
import os
import socket
import sys
import threading

import numpy as np
import pytest

from patrol_tpu_torch import native
from patrol_tpu_torch.models.limiter import NANO
from patrol_tpu_torch.models.limiter import LimiterConfig as TConfig
from patrol_tpu_torch.net.native_replication import NativeReplicator
from patrol_tpu_torch.net.replication import SlotTable
from patrol_tpu_torch.ops import wire
from patrol_tpu_torch.runtime.engine import DeviceEngine
from patrol_tpu_torch.runtime.repo import TPURepo
from patrol_tpu_torch.utils import histogram as hist_mod
from patrol_tpu_torch.utils import trace as trace_mod
from portbench import run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "deltas-64node-1m-uniform"
READERS = {
    "replication.flush_ms": "delta_flush_ns",
    "replication.mu_wait_ms": "delta_mu_wait_ns",
    "ingest.directory_ms": "ingest_directory_ns",
}


def test_the_64_member_cell_is_correct_and_its_control_and_faults_are_not():
    cell = run.Cell(CELL, 2**31 + 25, 1.0, False, device="cpu", control=True,
                    overrides={"config": {"keys": 4096, "buckets": 4096},
                               "traffic": {"warm_s": 0.3}})
    assert cell.config["members"] == 64 and cell.config["node_lanes"] == 64
    assert cell.traffic["intervals_per_tick"] == 1 and cell.traffic["keys"] == "uniform"
    res = run.run_cell(cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 63
    assert res["metrics"]["ack_p95_ms"]["value"] > 0
    assert res["control"]["lane_mismatches"] > 0
    for kind in ("state_unchanged", "half_the_batch"):
        assert any(v > 0 for v in res["faults"][kind].values()), (kind, res["faults"])


def _free_udp_port():
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def lone_node():
    """A native-backend replicator in delta mode with a CPU engine behind
    it, its flusher paced by hand; a plain socket is its one peer."""
    if native.load() is None:
        pytest.skip("the native host library does not build here")
    peer = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    peer.bind(("127.0.0.1", 0))
    peer.settimeout(10)
    addr = f"127.0.0.1:{_free_udp_port()}"
    addrs = [addr, "127.0.0.1:%d" % peer.getsockname()[1]]
    slots = SlotTable(addr, addrs, max_slots=4)
    rep = NativeReplicator(addr, addrs, slots, wire_mode="delta")
    rep.delta.close()
    eng = DeviceEngine(TConfig(buckets=64, nodes=4), node_slot=slots.self_slot,
                       clock=lambda: NANO, device="cpu")
    rep.repo = TPURepo(eng, send_incast=None)
    try:
        yield rep, eng, peer
    finally:
        peer.close()
        rep.close()
        eng.stop()


def _batch(k, first_seq=1):
    """``k`` dv2 intervals of 8 entries each as an rx ring batch."""
    row = native.RX_RING_ROW
    planes = np.zeros((k, row), np.uint8)
    lengths = np.zeros(k, np.int32)
    for i in range(k):
        ents = [wire.DeltaEntry(f"fi{j:03d}", 1, NANO, NANO, NANO // 2, 100 + j)
                for j in range(8 * i, 8 * i + 8)]
        data, packed = wire.encode_delta_packet(1, first_seq + i, (), ents, max_size=row)
        assert packed == 8
        planes[i, : len(data)] = np.frombuffer(data, np.uint8)
        lengths[i] = len(data)
    return planes, lengths


class _Spy:
    """Stands in for one of the program's histograms: keeps what this
    thread records into it (other nodes' threads in this process may
    record too) and passes every record on."""

    def __init__(self, real):
        self.real, self.mine = real, []
        self.tid = threading.get_ident()

    def record(self, value):
        if threading.get_ident() == self.tid:
            self.mine.append(value)
        self.real.record(value)


def _spy(monkeypatch, name):
    spy = _Spy(getattr(hist_mod, name))
    monkeypatch.setattr(hist_mod, name, spy)
    return spy


def test_each_flush_records_its_whole_tick(lone_node, monkeypatch):
    rep, eng, peer = lone_node
    planes, lengths = _batch(3)
    assert rep.delta.on_raw_planes(planes, lengths, [peer.getsockname()] * 3)
    spy = _spy(monkeypatch, "DELTA_FLUSH")
    for _ in range(2):
        rep.delta.flush()
    assert len(spy.mine) == 2 and all(v > 0 for v in spy.mine)
    assert sorted(wire.decode_delta_packet(peer.recvfrom(65536)[0]).acks) == [1, 2, 3]
    assert eng.flush(timeout=30)


def test_each_rx_batch_records_its_wait_for_the_plane_lock(lone_node, monkeypatch):
    rep, eng, peer = lone_node
    spy = _spy(monkeypatch, "DELTA_MU_WAIT")
    for b in range(2):
        planes, lengths = _batch(2, first_seq=1 + 2 * b)
        assert rep.delta.on_raw_planes(planes, lengths, [peer.getsockname()] * 2)
    assert len(spy.mine) == 2
    if trace_mod.TRACE.enabled:
        evs = [e for e in trace_mod.TRACE.dump() if e["tid"] == spy.tid]
        last = max(i for i, e in enumerate(evs) if e["type"] == "rx.acks")
        wait = evs[last - 1]
        assert wait["type"] == "rx.mu_wait" and wait["dur_ns"] == spy.mine[-1]
        assert wait["t_ns"] + wait["dur_ns"] <= evs[last]["t_ns"]
    assert eng.flush(timeout=30)


def test_each_raw_launch_records_its_directory_pass(lone_node, monkeypatch):
    rep, eng, peer = lone_node
    directory = _spy(monkeypatch, "INGEST_DIRECTORY")
    planes_hist = _spy(monkeypatch, "RAW_PLANES")
    planes, lengths = _batch(4)
    assert rep.delta.on_raw_planes(planes, lengths, [peer.getsockname()] * 4)
    assert planes_hist.mine == [4] and len(directory.mine) == 1
    assert eng.flush(timeout=30)
    assert eng.directory.lookup("fi031") is not None


def test_send_pairs_sends_each_row_to_its_own_peer_in_order():
    if native.load() is None:
        pytest.skip("the native host library does not build here")
    tx = native.NativeSocket("127.0.0.1", 0)
    rx = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM) for _ in range(3)]
    try:
        for r in rx:
            r.bind(("127.0.0.1", 0))
            r.settimeout(10)
        rows = [b"a" * 40, b"bb" * 300, b"c" * 7, b"d" * 900]
        dest = [0, 1, 0, 2]
        pkts = np.zeros((len(rows), 1024), np.uint8)
        for k, data in enumerate(rows):
            pkts[k, : len(data)] = np.frombuffer(data, np.uint8)
        sizes = np.array([len(d) for d in rows], np.int32)
        ips = np.full(len(rows), 0x7F000001, np.uint32)
        ports = np.array([rx[d].getsockname()[1] for d in dest], np.uint16)
        assert tx.send_pairs(pkts, sizes, ips, ports).tolist() == [True] * 4
        got = {j: [] for j in range(3)}
        for d in dest:
            got[d].append(rx[d].recv(65536))
        assert got == {0: [rows[0], rows[2]], 1: [rows[1]], 2: [rows[3]]}
        assert len(tx.send_pairs(pkts[:0], sizes[:0], ips[:0], ports[:0])) == 0
    finally:
        tx.close()
        for r in rx:
            r.close()


@pytest.mark.parametrize("n_rows, bad", [(5, [2]), (5, [0, 4]), (1500, [1, 1100, 1499])])
def test_a_refused_row_costs_only_its_own_datagram(n_rows, bad):
    """A row to 127.0.0.1:0 (UDP's sendto refuses port 0 with EINVAL) is
    skipped alone: every row after it, in its sendmmsg chunk and in later
    chunks (1,024 a call), still reaches its peer, in order. The rows go
    round the peers so that no socket buffer overflows."""
    if native.load() is None:
        pytest.skip("the native host library does not build here")
    tx = native.NativeSocket("127.0.0.1", 0)
    rx = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM) for _ in range(8)]
    try:
        for r in rx:
            r.bind(("127.0.0.1", 0))
            r.settimeout(10)
        dest = np.arange(n_rows) % len(rx)
        pkts = np.zeros((n_rows, 8), np.uint8)
        pkts[:, :4] = np.arange(n_rows, dtype=">u4").view(np.uint8).reshape(-1, 4)
        sizes = np.full(n_rows, 4, np.int32)
        ips = np.full(n_rows, 0x7F000001, np.uint32)
        ports = np.array([rx[d].getsockname()[1] for d in dest], np.uint16)
        ports[bad] = 0
        ok = tx.send_pairs(pkts, sizes, ips, ports)
        assert np.flatnonzero(~ok).tolist() == bad
        for j, r in enumerate(rx):
            want = [i for i in range(n_rows) if dest[i] == j and i not in bad]
            assert [int.from_bytes(r.recv(64), "big") for _ in want] == want
    finally:
        tx.close()
        for r in rx:
            r.close()


def test_a_native_unicast_many_counts_a_refused_datagram_as_unicast_does():
    if native.load() is None:
        pytest.skip("the native host library does not build here")
    peer = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    peer.bind(("127.0.0.1", 0))
    peer.settimeout(10)
    addr = f"127.0.0.1:{_free_udp_port()}"
    slots = SlotTable(addr, [addr, "127.0.0.1:%d" % peer.getsockname()[1]], max_slots=8)
    rep = NativeReplicator(addr, [addr], slots, wire_mode="delta")
    rep.delta.close()
    try:
        good = peer.getsockname()
        sends = [(b"one", good), (b"refused", ("127.0.0.1", 0)), (b"three!", good)]
        tx0, bytes0, err0 = rep.tx_packets, rep.tx_bytes, rep.send_errors
        assert rep.unicast_many(sends) == 2
        assert (rep.tx_packets - tx0, rep.tx_bytes - bytes0) == (2, 9)
        assert rep.send_errors - err0 == 1
        assert [peer.recv(64), peer.recv(64)] == [b"one", b"three!"]
        rep.unicast(b"refused", ("127.0.0.1", 0))
        assert rep.send_errors - err0 == 2 and rep.tx_packets - tx0 == 2
    finally:
        rep.close()
        peer.close()


def test_a_native_flush_tick_sends_every_peers_acks_in_one_call(monkeypatch):
    if native.load() is None:
        pytest.skip("the native host library does not build here")
    peers = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM) for _ in range(3)]
    for p in peers:
        p.bind(("127.0.0.1", 0))
        p.settimeout(10)
    addr = f"127.0.0.1:{_free_udp_port()}"
    addrs = [addr] + ["127.0.0.1:%d" % p.getsockname()[1] for p in peers]
    slots = SlotTable(addr, addrs, max_slots=8)
    rep = NativeReplicator(addr, addrs, slots, wire_mode="delta")
    rep.delta.close()
    calls = []
    real = rep.sock.send_pairs
    monkeypatch.setattr(rep.sock, "send_pairs", lambda *a: calls.append(len(a[0])) or real(*a))
    try:
        with rep.delta._mu:
            for q, p in enumerate(peers):
                st = rep.delta._peer(p.getsockname())
                st.capable = True
                st.pending_acks.append((q + 1, 0))
        tx0 = rep.tx_packets
        rep.delta.flush()
        assert calls == [3] and rep.tx_packets == tx0 + 3
        for q, p in enumerate(peers):
            assert list(wire.decode_delta_packet(p.recv(65536)).acks) == [q + 1]
    finally:
        rep.close()
        for p in peers:
            p.close()


def test_batched_digests_equal_state_digest_of_each_snapshot():
    from patrol_tpu_torch.net import antientropy as ae
    from patrol_tpu_torch.ops.rate import parse_rate

    eng = DeviceEngine(TConfig(buckets=128, nodes=8), node_slot=2,
                       clock=lambda: NANO, device="cpu")
    try:
        rng = np.random.default_rng(25)
        names, slots, added, taken, elapsed, caps = [], [], [], [], [], []
        for k in range(40):
            for slot in rng.choice(8, size=int(rng.integers(1, 5)), replace=False):
                names.append(f"dg{k:03d}")
                slots.append(int(slot))
                added.append(int(rng.integers(0, 1 << 62)))
                taken.append(int(rng.integers(0, 1 << 62)) if k % 3 else 0)
                elapsed.append(int(rng.integers(0, 1 << 62)))
                caps.append(int(rng.integers(1, 1 << 40)))
        eng.ingest_deltas_batch(names, slots, [0] * len(names), [0] * len(names), elapsed,
                                caps, added, taken)
        # A host-resident bucket with the node's own lane, and one with
        # only its capacity known.
        eng.submit_take("dg-host", parse_rate("5:1h"), 2)[0].wait(30)
        eng.ingest_deltas_batch(["dg-cap"], [3], [0], [0], [0], [7 * NANO], [0], [0])
        assert eng.flush(timeout=30)
        want_names = sorted(set(names)) + ["dg-host", "dg-cap", "dg-unbound"]
        snaps = eng.snapshot_many(want_names)
        got = ae.digests_of(eng, want_names)
        assert [n for n, _ in got] == [n for n in want_names if n in snaps]
        assert {n for n, _ in got} >= {"dg000", "dg-host"}
        for n, d in got:
            assert d == ae.state_digest(snaps[n]), n
    finally:
        eng.stop()


def _reader(metric):
    path = os.path.join(ROOT, "portbench", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location("fanin_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _NoSuchHistograms:
    """A histogram module whose registry holds none of the readers' names."""

    def __init__(self):
        self.HISTOGRAMS = hist_mod.HistogramRegistry()
        self.HISTOGRAMS.get("rx_batch_ns").record(5)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_a_reader_gives_its_histograms_mean_in_ms(metric, monkeypatch):
    reg = hist_mod.HistogramRegistry()
    for v in (2_000_000, 4_000_000):
        reg.get(READERS[metric]).record(v)
    stub = type(sys)("stub_histogram")
    stub.HISTOGRAMS = reg
    monkeypatch.setitem(sys.modules, "patrol_tpu_torch.utils.histogram", stub)
    assert _reader(metric).read({}) == pytest.approx(3.0)


@pytest.mark.parametrize("metric", sorted(READERS))
@pytest.mark.parametrize("program", ["no_histogram_module", "no_such_histogram", "no_record"])
def test_a_reader_gives_nothing_without_its_histogram(metric, program, monkeypatch):
    key = "patrol_tpu_torch.utils.histogram"
    if program == "no_histogram_module":
        monkeypatch.delitem(sys.modules, key)
    elif program == "no_such_histogram":
        monkeypatch.setitem(sys.modules, key, _NoSuchHistograms())
    else:
        stub = type(sys)("stub_histogram")
        stub.HISTOGRAMS = hist_mod.HistogramRegistry()
        stub.HISTOGRAMS.get(READERS[metric])
        monkeypatch.setitem(sys.modules, key, stub)
    assert _reader(metric).read({}) is None


def _plane(kind):
    """A worker plane with no engine: its jobs are the calls to
    ``job_attr``, which the test replaces."""
    from types import SimpleNamespace

    from patrol_tpu_torch.net.antientropy import AntiEntropy
    from patrol_tpu_torch.net.audit import AuditPlane

    rep = SimpleNamespace(repo=None, log=None, slots=SimpleNamespace(self_slot=0))
    if kind == "antientropy":
        return AntiEntropy(rep), "_job_trigger", ("trigger", ("127.0.0.1", 1))
    return AuditPlane(rep, interval_s=0), "_compare", ("digest", [(1, 2)])


@pytest.mark.parametrize("kind", ["antientropy", "audit"])
def test_close_drops_queued_jobs_and_waits_for_the_one_in_hand(kind, monkeypatch):
    """A node stops its planes and then frees the engine that their jobs
    read. So ``close`` returns only once the worker has exited, and runs
    none of the jobs still queued (63 peers healing at once queue 63
    digests, more than a bounded join outlasts)."""
    plane, job_attr, job = _plane(kind)
    in_hand, release, ran = threading.Event(), threading.Event(), []

    def slow_job(*args):
        ran.append(args)
        in_hand.set()
        release.wait(10)

    monkeypatch.setattr(plane, job_attr, slow_job)
    for _ in range(8):
        plane._enqueue(job)
    assert in_hand.wait(10)
    closed = threading.Thread(target=plane.close)
    closed.start()
    closed.join(0.2)
    assert closed.is_alive(), "close returned while a job still read the engine"
    release.set()
    closed.join(10)
    assert not closed.is_alive()
    assert not plane._worker.is_alive()
    assert len(ran) == 1
