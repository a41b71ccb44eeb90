"""One HTTP script against a JAX node and a port node: same answers.

Both nodes are started in-process on the asyncio front with a frozen
injected clock and no peers — the JAX ``Command`` with
``http_front="python"`` and ``udp_backend="asyncio"`` (host fast path off,
so takes ride its device queue), the port's ``Command`` with
``device="cpu"``. The script drives ``/take`` to a 429, ``/take_batch``
with a hot-key crowd and per-entry errors, ``/tokens``, and the 400/404/405
answers of the reference's routes; statuses and bodies must be identical.
The debug routes are compared by status only (their bodies hold timings).
The same script then runs against the port's native C++ front (host lanes
in its native store) and the JAX node at its defaults (its own native
front): again identical. A meshed node serves; a mesh over more than one
distinct device, not ported yet, refuses to start.
"""

import asyncio
import http.client
import socket
import threading
import time

import pytest
import torch

from patrol_tpu.command import Command as JCommand
from patrol_tpu.models.limiter import LimiterConfig as JConfig
from patrol_tpu.runtime import engine as jengine_mod
from patrol_tpu_torch.command import Command as TCommand
from patrol_tpu_torch.models.limiter import NANO
from patrol_tpu_torch.models.limiter import LimiterConfig as TConfig
from patrol_tpu_torch.runtime import engine as tengine_mod

LONG = "a" * 232
HOT = "&".join(["t=hot,3:1m,1"] * 6)
SCRIPT = [
    *[("POST", "/take/demo?rate=5:1m&count=1")] * 6,
    ("GET", "/tokens/demo"),
    ("GET", "/tokens/nobody"),
    ("POST", "/take/demo2?rate=garbage"),
    ("POST", "/take/demo3?rate=10:1s&count=3"),
    ("POST", "/take/demo3?rate=10:1s&count=0"),
    ("POST", "/take/demo3?rate=10:1s&count=-4"),
    ("POST", f"/take/{LONG}?rate=1:1s"),
    ("GET", "/take/demo"),
    ("POST", f"/take_batch?{HOT}&t=b%2Cx,2:1s,2&t={LONG},1:1s,1&t=cold,bad,1"),
    ("POST", f"/take_batch?{HOT}"),
    ("POST", "/take_batch"),
    ("GET", "/take_batch?t=x,1:1s,1"),
    ("POST", "/take/%FFraw?rate=2:1s"),
    ("GET", "/tokens/%FFraw"),
    ("POST", "/take/%00ctl?rate=2:1s"),
    ("POST", "/tokens/demo"),
    ("GET", "/nope"),
    ("GET", "/tokens/demo3"),
]
STATUS_ONLY = [("GET", "/metrics"), ("GET", "/debug/vars"), ("GET", "/debug/pprof/")]


class Clock:
    def __init__(self, now=1000 * NANO):
        self.now = now

    def __call__(self):
        return self.now


def _free_port(kind=socket.SOCK_STREAM):
    with socket.socket(socket.AF_INET, kind) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Node:
    """Runs a Command's asyncio loop on a thread until stopped."""

    def __init__(self, cmd):
        self.cmd = cmd
        self.loop = asyncio.new_event_loop()
        self.stop_ev = None
        self.error = None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()
        deadline = time.monotonic() + 60
        while not cmd.started.is_set():
            assert self.error is None, self.error
            assert time.monotonic() < deadline, "node did not start"
            time.sleep(0.01)

    def _run(self):
        asyncio.set_event_loop(self.loop)

        async def main():
            self.stop_ev = asyncio.Event()
            await self.cmd.run(self.stop_ev)

        try:
            self.loop.run_until_complete(main())
        except BaseException as exc:  # surfaced by the starter
            self.error = exc

    def close(self):
        self.loop.call_soon_threadsafe(self.stop_ev.set)
        self.thread.join(30)


# The script for the native fronts: their C++ takes read the wall clock
# (plus the injected clock's offset at start), not the frozen one, so every
# rate period becomes an hour, over which a run refills no whole token.
NATIVE_SCRIPT = [(m, t.replace(":1m", ":1h").replace(":1s", ":1h")) for m, t in SCRIPT]


def drive(port, script=SCRIPT):
    out = []
    for method, target in script + STATUS_ONLY:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request(method, target, headers={"Connection": "close"})
        resp = conn.getresponse()
        body = resp.read()
        conn.close()
        out.append((resp.status, body if (method, target) not in STATUS_ONLY else b""))
    return out


def test_http_script_matches_reference(monkeypatch):
    monkeypatch.setattr(jengine_mod, "HOST_FASTPATH", False)
    monkeypatch.setattr(tengine_mod, "HOST_FASTPATH", False)
    jport = _free_port()
    jnode = Node(
        JCommand(
            api_addr=f"127.0.0.1:{jport}",
            node_addr=f"127.0.0.1:{_free_port(socket.SOCK_DGRAM)}",
            clock=Clock(),
            config=JConfig(256, 8),
            handle_signals=False,
            http_front="python",
            udp_backend="asyncio",
        )
    )
    try:
        want = drive(jport)
    finally:
        jnode.close()

    tcmd = TCommand(
        api_addr="127.0.0.1:0",
        node_addr=f"127.0.0.1:{_free_port(socket.SOCK_DGRAM)}",
        clock=Clock(),
        config=TConfig(256, 8),
        handle_signals=False,
        device="cpu",
        http_front="python",
    )
    tnode = Node(tcmd)
    try:
        got = drive(tcmd.api_port)
    finally:
        tnode.close()

    assert got == want
    statuses = [s for s, _ in got]
    assert {200, 400, 404, 405, 429} <= set(statuses)
    assert got[5] == (429, b"0")  # drained


@pytest.mark.parametrize(
    "kwargs",
    [
        {"udp_backend": "native", "http_front": "native", "mesh_replicas": 2},
        {"http_front": "native", "mesh_replicas": 2},
        {"mesh_replicas": 2},
    ],
)
def test_unported_options_refuse_to_start(kwargs):
    """The mesh is ported: each option set passes ``check_ported()`` and
    a node started with it on a 2 × 4 mesh of ``cpu`` × 8 answers a take.
    A mesh over devices of two platforms refuses the whole configuration
    (``ValueError``), as a JAX mesh cannot mix them."""
    cpu8 = [torch.device("cpu")] * 8
    TCommand(device="cpu", **kwargs).check_ported()
    with pytest.raises(ValueError, match="one platform"):
        TCommand(device="cpu", mesh_devices=[torch.device("cpu"), torch.device("cuda", 0)] * 4,
                 **kwargs).check_ported()
    cmd = TCommand(
        api_addr="127.0.0.1:0", node_addr=f"127.0.0.1:{_free_port(socket.SOCK_DGRAM)}",
        clock=Clock(), config=TConfig(64, 4), handle_signals=False, device="cpu",
        mesh_devices=cpu8, **kwargs,
    )
    node = Node(cmd)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", cmd.api_port, timeout=30)
        conn.request("POST", "/take/mesh?rate=5:1h&count=2")
        resp = conn.getresponse()
        assert (resp.status, resp.read()) == (200, b"3")
        conn.close()
        assert cmd.engine.stats()["mesh_replicas"] == 2
        assert cmd.engine.plan.shards == 4
    finally:
        node.close()


@pytest.mark.parametrize("front", ["native", "auto"])
def test_native_front_serves_the_script(monkeypatch, front):
    """``--http-front native`` (and ``auto``, which takes it when the host
    library loads) serves: the same script, on the C++ front over the
    engine's native host-lane store, answers as the JAX node at its
    defaults does (its native front, host lanes on)."""
    from patrol_tpu import native as jnative
    from patrol_tpu_torch import native
    from patrol_tpu_torch.net.native_http import NativeHTTPFront

    if native.load() is None or jnative.load() is None:
        pytest.skip("a native host library does not build here")
    jport = _free_port()
    jcmd = JCommand(
        api_addr=f"127.0.0.1:{jport}",
        node_addr=f"127.0.0.1:{_free_port(socket.SOCK_DGRAM)}",
        clock=Clock(), config=JConfig(256, 8), handle_signals=False,
        udp_backend="asyncio",
    )
    jnode = Node(jcmd)
    try:
        assert jcmd.engine._native_store is not None  # its defaults
        want = drive(jport, NATIVE_SCRIPT)
    finally:
        jnode.close()
    tcmd = TCommand(
        api_addr="127.0.0.1:0", node_addr=f"127.0.0.1:{_free_port(socket.SOCK_DGRAM)}",
        clock=Clock(), config=TConfig(256, 8), handle_signals=False, device="cpu",
        http_front=front, udp_backend="asyncio",
    )
    tnode = Node(tcmd)
    try:
        assert isinstance(tcmd.native_front, NativeHTTPFront)
        assert tcmd.engine._native_store is not None
        got = drive(tcmd.api_port, NATIVE_SCRIPT)
        in_front = tcmd.engine._native_store.native_takes
    finally:
        tnode.close()
    assert got == want
    assert in_front > 0  # takes of hosted buckets answered in C++


def test_port_only_answers_404_for_planes_not_ported():
    # The replicator's planes answer; the JAX profiler's route has no
    # counterpart in the port (its device trace is /debug/cuda/trace).
    tcmd = TCommand(
        api_addr="127.0.0.1:0", node_addr=f"127.0.0.1:{_free_port(socket.SOCK_DGRAM)}",
        clock=Clock(), config=TConfig(16, 2), handle_signals=False, device="cpu",
    )
    node = Node(tcmd)
    try:
        for target, status in (
            ("/cluster/vars", 200), ("/cluster/metrics", 200), ("/admin/peers", 200),
            ("/debug/audit", 200),
            ("/debug/jax/trace", 404),
            ("/debug/cuda/trace?seconds=0.05", 200), ("/debug/pprof/trace?seconds=0.05", 200),
        ):
            conn = http.client.HTTPConnection("127.0.0.1", tcmd.api_port, timeout=30)
            conn.request("GET", target)
            assert conn.getresponse().status == status, target
            conn.close()
    finally:
        node.close()
