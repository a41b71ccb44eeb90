"""The port's spans and queue times (``utils/trace.py``'s :class:`Span`,
``utils/histogram.py``'s ``rx_batch_ns``, ``delta_rx_queue_ns`` and
``delta_ack_hold_ns``) on the CPU.

* A span opened on a worker thread, one started before the capture
  included, is a ``cpu_op`` of a ``profile_all_threads`` capture on that
  thread, inside the capture's window, around an aten op it ran.
* With no profiler running a span writes its ring event and histogram
  only; the ring and its Chrome trace place every event at its start.
* A native-backend rx batch of dv2 datagrams adds one observation each to
  ``ingest_rx_decode_ns``, ``rx_batch_ns`` and ``rx_wait_ns``, one
  ``delta_rx_queue_ns`` sample per datagram, and under a capture its stages are ``cpu_op``s of
  the rx thread.
* Over ``on_raw_planes`` and then ``flush()``, ``delta_ack_hold_ns`` takes
  one sample per ack sent, each between 0 and the time the test saw
  between the receive and the flush's end; ``delta.flush`` is a ring event
  whose argument is the datagrams sent.
* ``pt_recv_batch`` stamps each datagram with the kernel's receive time
  (``SO_TIMESTAMP``), between its send and its pickup.
"""

import json
import socket
import threading
import time

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig

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

ROW = native.RX_RING_ROW


def _capture(tmp_path, body):
    """Run ``body()`` under a capture of every thread's CPU ops → (its
    Chrome trace events, the capture's start and end on its clock, µs)."""
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU],
        experimental_config=_ExperimentalConfig(profile_all_threads=True),
    )
    with prof:
        body()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    whole = next(e for e in events if e.get("cat") == "Trace")
    return events, float(whole["ts"]), float(whole["ts"]) + float(whole["dur"])


def _ops(events, name):
    return [e for e in events if e.get("cat") == "cpu_op" and e["name"] == name]


def _inside(inner, outer):
    return outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def _thread_events(tid):
    return [e for e in trace_mod.TRACE.dump() if e["tid"] == tid]


def test_a_worker_span_is_a_cpu_op_of_the_capture_around_its_aten_op(tmp_path):
    go, done = threading.Event(), threading.Event()
    tids = []

    def worker():
        tids.append(threading.get_native_id())
        go.wait(30)
        with trace_mod.Span(trace_mod.EV_RX_BATCH, arg=3):
            torch.ones(64).add_(1)
        done.set()

    t = threading.Thread(target=worker, name="span-worker")
    t.start()  # before the capture opens

    def body():
        go.set()
        assert done.wait(30)

    events, t0, t1 = _capture(tmp_path, body)
    t.join(30)
    spans = _ops(events, "rx.batch")
    assert len(spans) == 1
    span = spans[0]
    assert span["tid"] == tids[0]
    assert t0 <= span["ts"] and span["ts"] + span["dur"] <= t1
    adds = [e for e in _ops(events, "aten::add_") if e["tid"] == tids[0]]
    assert adds and all(_inside(a, span) for a in adds)


def test_without_a_profiler_a_span_writes_its_ring_and_histogram_only(monkeypatch):
    assert not trace_mod._profiler_on()
    opened = []
    monkeypatch.setattr(trace_mod, "_RecordFunctionFast", lambda name: opened.append(name))
    h = hist_mod.LatticeHistogram("span_test_ns")
    tid = threading.get_ident()
    before = len(_thread_events(tid))
    with trace_mod.Span(trace_mod.EV_RX_WALK, h, 7) as sp:
        assert sp._rf is None
    assert opened == [] and h.count == 1
    evs = _thread_events(tid)
    assert len(evs) == min(before + 1, trace_mod.TRACE.size)
    assert evs[-1]["type"] == "rx.walk" and evs[-1]["arg"] == 7
    assert evs[-1]["t_ns"] == sp.t0_ns and evs[-1]["dur_ns"] == h.total


def test_the_ring_and_its_chrome_trace_place_each_event_at_its_start():
    tid = threading.get_ident()
    with trace_mod.Span(trace_mod.EV_DELTA_FLUSH) as sp:
        time.sleep(0.002)
    end = time.perf_counter_ns()
    # An event recorded after the fact, with its length only.
    t_call = time.perf_counter_ns()
    trace_mod.TRACE.record(trace_mod.EV_H2D_PUT, 5_000_000, 1)
    t_back = time.perf_counter_ns()
    span_ev, late_ev = _thread_events(tid)[-2:]
    assert span_ev["t_ns"] == sp.t0_ns
    assert sp.t0_ns + span_ev["dur_ns"] <= end
    assert t_call <= late_ev["t_ns"] + late_ev["dur_ns"] <= t_back
    # The offset between the clocks (wall - perf) is at least w0 - p1 and
    # at most w1 - p2. The export reads the wall clock and then
    # perf_counter_ns, both between p1 and p2, which can only lower its
    # offset, by at most p2 - p1. So its offset lies between w0 - p2 and
    # w1 - p2: a preemption between any two reads widens the bracket and
    # never breaks it.
    w0, p1 = time.time_ns(), time.perf_counter_ns()
    chrome = json.loads(trace_mod.TRACE.chrome_trace(events=[span_ev, late_ev]))
    p2, w1 = time.perf_counter_ns(), time.time_ns()
    lo, hi = w0 - p2, w1 - p2
    for ev, ce in zip((span_ev, late_ev), chrome["traceEvents"]):
        assert ce["dur"] * 1000 == pytest.approx(ev["dur_ns"], abs=1)
        # Start and end on the wall clock: the ring's stamps moved by
        # the offset between the two clocks at the export.
        ends = ((ce["ts"], ev["t_ns"]), (ce["ts"] + ce["dur"], ev["t_ns"] + ev["dur_ns"]))
        for ce_us, t_ns in ends:
            assert t_ns + lo - 1000 <= ce_us * 1000 <= t_ns + hi + 1000


def _free_udp_port():
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def lone_node():
    """A native-backend replicator in delta mode, a CPU engine behind it,
    its flusher paced by hand; and a plain socket as its one peer, which
    sends only what a test sends."""
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


def _datagram(seq, first, n=8):
    ents = [wire.DeltaEntry(f"sp{i:03d}", 1, NANO, NANO, NANO // 2, 100 + i)
            for i in range(first, first + n)]
    data, packed = wire.encode_delta_packet(1, seq, (), ents, max_size=ROW)
    assert packed == n
    return data


def _counts():
    names = ("STAGE_RX_DECODE", "RX_BATCH", "RX_WAIT", "DELTA_RX_QUEUE")
    return {h: getattr(hist_mod, h).count for h in names}


def _wait_for(pred, what, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


def test_a_native_rx_batch_observes_each_stage_once(lone_node, tmp_path):
    rep, eng, peer = lone_node
    node = ("127.0.0.1", rep.sock.port)
    c0 = _counts()
    raw0 = hist_mod.RAW_PLANES.count

    def body():
        peer.sendto(_datagram(1, 0), node)
        _wait_for(lambda: hist_mod.RAW_PLANES.count > raw0, "the datagram was never folded")
        _wait_for(lambda: hist_mod.RX_BATCH.count > c0["RX_BATCH"], "the batch never closed")
        time.sleep(0.2)  # the span's profiler half closes just after its histogram

    events, _, _ = _capture(tmp_path, body)
    assert eng.flush(timeout=30)
    c1 = _counts()
    assert {k: c1[k] - c0[k] for k in c0} == {
        "STAGE_RX_DECODE": 1, "RX_BATCH": 1, "RX_WAIT": 1, "DELTA_RX_QUEUE": 1}
    batch = _ops(events, "rx.batch")
    assert len(batch) == 1
    for stage in ("rx.decode", "rx.walk", "rx.acks", "ingest.directory", "ingest.ship",
                  "ingest.launch"):
        got = _ops(events, stage)
        assert len(got) == 1 and got[0]["tid"] == batch[0]["tid"], stage
        assert _inside(got[0], batch[0]), stage
    assert eng.directory.lookup("sp007") is not None


def test_ack_hold_is_one_sample_per_ack_within_what_the_test_saw(lone_node, monkeypatch):
    rep, eng, peer = lone_node
    held = []
    real = hist_mod.DELTA_ACK_HOLD

    class Spy:
        def record_many(self, values):
            held.extend(int(v) for v in values)
            real.record_many(values)

    monkeypatch.setattr(hist_mod, "DELTA_ACK_HOLD", Spy())
    k = 5
    planes = np.zeros((k, ROW), np.uint8)
    lengths = np.zeros(k, np.int32)
    for i in range(k):
        d = _datagram(i + 1, 8 * i)
        planes[i, : len(d)] = np.frombuffer(d, np.uint8)
        lengths[i] = len(d)
    addr = peer.getsockname()
    t_rx = time.perf_counter_ns()
    assert rep.delta.on_raw_planes(planes, lengths, [addr] * k, picked_ns=t_rx)
    count0 = real.count
    tid = threading.get_ident()
    rep.delta.flush()
    t_end = time.perf_counter_ns()
    acked = []
    while len(acked) < k:
        data, _ = peer.recvfrom(65536)
        pkt = wire.decode_delta_packet(data)
        if pkt is not None:
            acked.extend(pkt.acks)
    assert sorted(acked) == list(range(1, k + 1))
    assert len(held) == k and real.count - count0 == k
    assert all(0 <= v <= t_end - t_rx for v in held)
    flush_ev = [e for e in _thread_events(tid) if e["type"] == "delta.flush"][-1]
    assert flush_ev["arg"] >= 1 and flush_ev["t_ns"] <= t_end
    assert eng.flush(timeout=30)


def test_recv_batch_stamps_each_datagram_with_the_kernel_receive_time():
    if native.load() is None:
        pytest.skip("the native host library does not build here")
    rx = native.NativeSocket("127.0.0.1", 0)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        sent = time.time_ns()
        for i in range(3):
            tx.sendto(b"x" * (40 + i), ("127.0.0.1", rx.port))
        got = []
        deadline = time.monotonic() + 10
        while len(got) < 3:
            assert time.monotonic() < deadline, "the datagrams never arrived"
            _, sizes, _, _, stamps = rx.recv_batch(timeout_ms=500)
            picked = time.time_ns()
            got.extend((int(s), int(t), picked) for s, t in zip(sizes, stamps))
        assert sorted(s for s, _, _ in got) == [40, 41, 42]
        # The stamp is to the microsecond, cut down.
        assert all(sent - 1000 < t <= picked for _, t, picked in got)
    finally:
        tx.close()
        rx.close()
