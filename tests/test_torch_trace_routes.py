"""The port's device-trace routes: ``/debug/cuda/trace`` and
``/debug/pprof/trace`` (the counterparts of the JAX package's
``/debug/jax/trace`` and ``/debug/pprof/trace``) over
``utils/profiling.py::cuda_trace``.

On a CPU node, through the asyncio front and the native C++ front (which
hands every non-take route to Python): each route answers 200 with one
line naming a Chrome-trace JSON that parses and holds the capture's host
events, and 409 while another capture runs (the lock a running capture
holds, as ``tests/test_api.py`` does for the reference). Without HTTP,
``cuda_trace`` raises ``ProfilerBusyError`` on an overlap and counts
captures and refusals in the declared counters; ``prepare_cuda_trace``
(the set-up a node on a card runs before it serves) runs once a process,
and a CPU node skips it. The index lists both
routes; ``/debug/jax/trace`` stays 404. Exact comparisons only (statuses,
bodies, counts): tolerance zero.
"""

import http.client
import json
import os
import re
import socket
import threading

import pytest

from patrol_tpu_torch.command import Command
from patrol_tpu_torch.models.limiter import NANO, LimiterConfig
from patrol_tpu_torch.utils import profiling

from test_torch_api import Node


class Clock:
    def __init__(self, now=1000 * NANO):
        self.now = now

    def __call__(self):
        return self.now


def _free_udp_port():
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(port, target):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", target, headers={"Connection": "close"})
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def _trace_path(body):
    m = re.fullmatch(r"trace written to (\S+)\n", body)
    assert m, body
    return m.group(1)


@pytest.fixture(params=["python", "native"])
def node(request):
    from patrol_tpu_torch import native

    if request.param == "native" and native.load() is None:
        pytest.skip("the native host library does not build here")
    cmd = Command(
        api_addr="127.0.0.1:0", node_addr=f"127.0.0.1:{_free_udp_port()}",
        clock=Clock(), config=LimiterConfig(64, 4), handle_signals=False, device="cpu",
        http_front=request.param, udp_backend="asyncio",
    )
    n = Node(cmd)
    try:
        assert (cmd.native_front is not None) == (request.param == "native")
        yield cmd
    finally:
        n.close()


@pytest.mark.parametrize("route", ["/debug/cuda/trace", "/debug/pprof/trace"])
def test_route_writes_a_chrome_trace(node, route, tmp_path):
    before = profiling.COUNTERS.get("trace_captures")
    # Takes served on another thread during the window put torch ops of
    # the engine's threads into the capture.
    stop = threading.Event()

    def takes():
        while not stop.is_set():
            _get(node.api_port, "/tokens/nobody")

    t = threading.Thread(target=takes)
    t.start()
    try:
        status, body = _get(node.api_port, f"{route}?seconds=0.2")
    finally:
        stop.set()
        t.join(30)
    assert status == 200, body
    path = _trace_path(body)
    assert os.path.basename(os.path.dirname(path)).startswith("patrol-cuda-trace-")
    with open(path) as f:
        trace = json.load(f)
    assert isinstance(trace["traceEvents"], list) and trace["traceEvents"]
    assert profiling.COUNTERS.get("trace_captures") == before + 1


@pytest.mark.parametrize("route", ["/debug/cuda/trace", "/debug/pprof/trace"])
def test_route_answers_409_while_a_capture_runs(node, route):
    busy = profiling.COUNTERS.get("trace_captures_busy")
    assert profiling._cuda_trace_mu.acquire(timeout=10)
    try:
        status, body = _get(node.api_port, f"{route}?seconds=0.1")
    finally:
        profiling._cuda_trace_mu.release()
    assert (status, body) == (409, "a trace capture is already running; retry later\n")
    assert profiling.COUNTERS.get("trace_captures_busy") == busy + 1


@pytest.mark.parametrize("seconds", ["x", "-1", "nan"])
def test_route_refuses_a_bad_duration(node, seconds):
    assert _get(node.api_port, f"/debug/cuda/trace?seconds={seconds}") == (400, "bad seconds\n")


def test_index_lists_both_routes_and_jax_trace_stays_404(node):
    status, body = _get(node.api_port, "/debug/pprof/")
    assert status == 200
    assert "/debug/cuda/trace?seconds=N" in body and "/debug/pprof/trace?seconds=N" in body
    assert _get(node.api_port, "/debug/jax/trace")[0] == 404


def test_busy_error_without_http():
    assert profiling._cuda_trace_mu.acquire(timeout=10)
    try:
        with pytest.raises(profiling.ProfilerBusyError):
            profiling.cuda_trace(duration_s=0.01)
    finally:
        profiling._cuda_trace_mu.release()


def test_overlapping_direct_captures_one_wins(tmp_path):
    # Two callers at once: exactly one writes its trace, the other is
    # refused, and the lock is free again afterwards.
    results = []
    gate = threading.Barrier(2)

    def capture(i):
        gate.wait(10)
        try:
            results.append(("ok", profiling.cuda_trace(0.3, out_dir=str(tmp_path / str(i)))))
        except profiling.ProfilerBusyError:
            results.append(("busy", None))

    (tmp_path / "0").mkdir()
    (tmp_path / "1").mkdir()
    threads = [threading.Thread(target=capture, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert sorted(kind for kind, _ in results) == ["busy", "ok"]
    path = next(p for kind, p in results if kind == "ok")
    assert os.path.dirname(path) in (str(tmp_path / "0"), str(tmp_path / "1"))
    with open(path) as f:
        json.load(f)
    assert profiling._cuda_trace_mu.acquire(blocking=False)
    profiling._cuda_trace_mu.release()


def test_capture_records_every_thread_s_ops(tmp_path):
    # The engine's threads, not the capturing one, launch the work: their
    # torch ops must be in the trace.
    import torch

    stop = threading.Event()
    tids = []

    def work():
        tids.append(threading.get_native_id())
        while not stop.is_set():
            torch.arange(64).sum()

    t = threading.Thread(target=work)
    t.start()
    try:
        path = profiling.cuda_trace(0.2, out_dir=str(tmp_path))
    finally:
        stop.set()
        t.join(30)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ops = [e for e in events if e.get("cat") == "cpu_op" and e.get("tid") == tids[0]]
    assert any(e["name"] == "aten::arange" for e in ops)


def test_cpu_capture_has_no_device_activity(monkeypatch, tmp_path):
    # Without a card the capture is the CPU activity alone; with one it
    # must carry the CUDA activity or raise (never drop it quietly).
    import torch

    seen = {}
    real = torch.profiler.profile

    def spy(*a, **kw):
        seen["activities"] = list(kw["activities"])
        return real(*a, **kw)

    monkeypatch.setattr(torch.profiler, "profile", spy)
    profiling.cuda_trace(0.01, out_dir=str(tmp_path))
    assert seen["activities"] == [torch.profiler.ProfilerActivity.CPU]

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.profiler, "supported_activities",
                        lambda: {torch.profiler.ProfilerActivity.CPU})
    with pytest.raises(RuntimeError, match="cannot trace it"):
        profiling.cuda_trace(0.01, out_dir=str(tmp_path))
    assert profiling._cuda_trace_mu.acquire(blocking=False)
    profiling._cuda_trace_mu.release()


def test_prepare_runs_the_set_up_once(monkeypatch, tmp_path):
    # A node on a card runs the profiler's set-up before it serves: one
    # empty capture the first time, nothing after; captures still follow.
    monkeypatch.setattr(profiling, "_cuda_trace_prepared", False)
    starts = []
    real = profiling._trace_profile

    def spy():
        starts.append(threading.get_ident())
        return real()

    monkeypatch.setattr(profiling, "_trace_profile", spy)
    assert profiling.prepare_cuda_trace() > 0.0
    assert profiling.prepare_cuda_trace() == 0.0
    assert starts == [threading.get_ident()]
    with open(profiling.cuda_trace(0.01, out_dir=str(tmp_path))) as f:
        json.load(f)
    assert len(starts) == 2
    assert profiling._cuda_trace_mu.acquire(blocking=False)
    profiling._cuda_trace_mu.release()


def test_a_capture_does_the_set_up_when_nothing_prepared_it(monkeypatch, tmp_path):
    monkeypatch.setattr(profiling, "_cuda_trace_prepared", False)
    profiling.cuda_trace(0.01, out_dir=str(tmp_path))
    assert profiling.prepare_cuda_trace() == 0.0


def test_prepare_on_a_card_it_cannot_trace_raises(monkeypatch):
    import torch

    monkeypatch.setattr(profiling, "_cuda_trace_prepared", False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.profiler, "supported_activities",
                        lambda: {torch.profiler.ProfilerActivity.CPU})
    with pytest.raises(RuntimeError, match="cannot trace it"):
        profiling.prepare_cuda_trace()
    assert not profiling._cuda_trace_prepared
    assert profiling._cuda_trace_mu.acquire(blocking=False)
    profiling._cuda_trace_mu.release()


def test_a_cpu_node_does_not_prepare_the_profiler(monkeypatch):
    calls = []
    monkeypatch.setattr(profiling, "prepare_cuda_trace", lambda: calls.append(1) or 1.0)
    cmd = Command(
        api_addr="127.0.0.1:0", node_addr=f"127.0.0.1:{_free_udp_port()}",
        clock=Clock(), config=LimiterConfig(64, 4), handle_signals=False, device="cpu",
        http_front="python", udp_backend="asyncio",
    )
    n = Node(cmd)
    try:
        assert calls == [] and cmd.trace_prepare_s == 0.0
    finally:
        n.close()
