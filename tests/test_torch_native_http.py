"""The port's native HTTP front (``native/patrol_http.cpp`` +
``net/native_http.py``), twin of ``tests/test_native_http.py`` and of the
native-front classes of ``tests/test_h2.py``.

* the C++ Go-semantics rate parser against the port's and the JAX
  package's ``parse_rate``;
* connection handling: pipelining, the reserved control-channel name,
  ``Connection: close``, body draining, an oversized Content-Length, the
  h2c preface, connection churn, both C++ load clients, and a
  take-pressure promotion that bypasses the pump's drain cadence;
* h2 on the front itself: RST_STREAM before a ring completion, an upload
  larger than the stream window, a whole stream window of DATA in the
  front's first read of a connection, and curl
  ``--http2-prior-knowledge`` against a node started by
  ``Command(http_front="native")``;
* a mixed cluster: a port node on the native front with host lanes and a
  JAX node at its defaults converge to equal state.

Engines run on ``device="cpu"``. Every front, engine and node is stopped
in its fixture; every wait has a deadline.
"""

import ctypes
import http.client
import random
import shutil
import socket
import subprocess
import time

import numpy as np
import pytest

from patrol_tpu.ops.rate import parse_rate as jparse_rate
from patrol_tpu_torch import native
from patrol_tpu_torch.models.limiter import LimiterConfig
from patrol_tpu_torch.net import h2
from patrol_tpu_torch.net.api import API
from patrol_tpu_torch.ops.rate import parse_rate
from patrol_tpu_torch.runtime import hoststore
from patrol_tpu_torch.runtime.engine import DeviceEngine
from patrol_tpu_torch.runtime.repo import TPURepo

CURL = shutil.which("curl")


@pytest.fixture(autouse=True)
def _needs_native():
    if native.load() is None:
        pytest.skip("the native host library does not build here")


def _native_h2():
    from patrol_tpu_torch.net.native_http import native_h2

    if not (h2.available() and native_h2()):
        pytest.skip("libnghttp2 unavailable")


class TestRateParserParity:
    """pt_parse_rate must equal parse_rate: the C++ front parses rates
    without Python, so a divergence would admit differently per front."""

    CORPUS = [
        "5:1s", "50:1m", "1:s", "3", "0:1h", "100:1.5h", "2:300ms",
        "7:2h45m", "5:µs", "5:1µs", "5:1μs", "-3:1s", "+4:1s", "garbage",
        "5:", "5:xyz", ":1s", "5:0", "1:1ns", "9223372036854775807:1s",
        "9223372036854775808:1s", "5:1h30m10.5s", "2:.5s", "2:1.s",
        "5:μs", "1:0.000000001s", "1:-1s", "1:+2s", "1:0", "",
    ]

    @staticmethod
    def _cpp(s: str):
        f, p = ctypes.c_int64(), ctypes.c_int64()
        rc = native.load().pt_parse_rate(s.encode(), ctypes.byref(f), ctypes.byref(p))
        return (f.value, p.value) if rc == 0 else None

    @staticmethod
    def _py(parse, s: str):
        try:
            r = parse(s)
            return (r.freq, r.per_ns)
        except ValueError:
            return None

    @pytest.mark.parametrize("parse", [parse_rate, jparse_rate], ids=["port", "jax"])
    def test_corpus(self, parse):
        for s in self.CORPUS:
            assert self._cpp(s) == self._py(parse, s), s

    def test_fuzz(self):
        rng = random.Random(11)
        alphabet = "0123456789.:smhnuµμ+-x"
        for _ in range(5000):
            s = "".join(rng.choice(alphabet) for _ in range(rng.randint(1, 12)))
            assert self._cpp(s) == self._py(parse_rate, s) == self._py(jparse_rate, s), s


@pytest.fixture(scope="module")
def front():
    if native.load() is None:
        pytest.skip("the native host library does not build here")
    from patrol_tpu_torch.net.native_http import NativeHTTPFront

    engine = DeviceEngine(LimiterConfig(buckets=256, nodes=4), node_slot=0, device="cpu")
    f = None
    try:
        f = NativeHTTPFront(
            API(TPURepo(engine), stats=lambda: {"engine_ticks": engine.ticks}),
            "127.0.0.1", 0,
        )
        yield f
    finally:
        if f is not None:
            f.close()
        engine.stop()


def _roundtrip(sock, payload: bytes, responses: int):
    sock.sendall(payload)
    buf = b""
    got = []
    while len(got) < responses:
        chunk = sock.recv(65536)
        assert chunk, f"connection closed after {len(got)} responses"
        buf += chunk
        while True:
            he = buf.find(b"\r\n\r\n")
            if he < 0:
                break
            head = buf[:he]
            clen = 0
            for line in head.split(b"\r\n"):
                if line.lower().startswith(b"content-length:"):
                    clen = int(line.split(b":")[1])
            if len(buf) < he + 4 + clen:
                break
            got.append((int(head.split(b" ", 2)[1]), buf[he + 4 : he + 4 + clen]))
            buf = buf[he + 4 + clen :]
    return got


def _read_to_close(s) -> bytes:
    data = b""
    while True:
        chunk = s.recv(65536)
        if not chunk:
            return data
        data += chunk


class TestConnectionHandling:
    def test_pipelined_requests_answered_in_order(self, front):
        with socket.create_connection(("127.0.0.1", front.port), timeout=10) as s:
            req = b"POST /take/pipe?rate=2:1h&count=1 HTTP/1.1\r\nHost: x\r\n\r\n"
            got = _roundtrip(s, req * 3, 3)
        assert [g[0] for g in got] == [200, 200, 429]
        assert [g[1] for g in got] == [b"1", b"0", b"0"]

    def test_reserved_control_channel_name_is_400(self, front):
        """NUL-led names are the replication control channel: no front
        creates a bucket there. Mixed with a normal take, so the batch is
        partitioned (reject some, submit the rest)."""
        with socket.create_connection(("127.0.0.1", front.port), timeout=10) as s:
            req = (
                b"POST /take/%00pt!probe?rate=5:1s HTTP/1.1\r\nHost: x\r\n\r\n"
                b"POST /take/legit-name?rate=5:1h HTTP/1.1\r\nHost: x\r\n\r\n"
            )
            got = _roundtrip(s, req, 2)
        assert got[0][0] == 400
        assert got[1][0] == 200
        assert front.api.repo.engine.directory.lookup("\x00pt!probe") is None

    def test_connection_close_honored(self, front):
        with socket.create_connection(("127.0.0.1", front.port), timeout=10) as s:
            s.sendall(
                b"POST /take/cc?rate=5:1s HTTP/1.1\r\nHost: x\r\n"
                b"Connection: close\r\n\r\n"
            )
            data = _read_to_close(s)
        assert b"Connection: close" in data
        assert data.split(b" ", 2)[1] == b"200"

    def test_request_body_drained(self, front):
        """A body on /take is drained, not parsed as the next request."""
        with socket.create_connection(("127.0.0.1", front.port), timeout=10) as s:
            body = b"GET /nope HTTP/1.1\r\n\r\n"  # looks like a request
            req = (
                b"POST /take/bd?rate=5:1h HTTP/1.1\r\nHost: x\r\n"
                b"Content-Length: %d\r\n\r\n%s" % (len(body), body)
            )
            got = _roundtrip(s, req * 2, 2)
        assert [g[0] for g in got] == [200, 200]

    def test_oversized_content_length_rejected(self, front):
        """A 20+-digit Content-Length saturates: 400 and close, and the
        bytes after it are never answered as a request."""
        with socket.create_connection(("127.0.0.1", front.port), timeout=10) as s:
            smuggled = b"GET /smuggled HTTP/1.1\r\nHost: x\r\n\r\n"
            s.sendall(
                b"POST /take/ovcl?rate=5:1s HTTP/1.1\r\nHost: x\r\n"
                b"Content-Length: 99999999999999999999999\r\n\r\n" + smuggled
            )
            data = _read_to_close(s)
        assert data.split(b" ", 2)[1] == b"400"
        assert data.count(b"HTTP/1.1 ") == 1

    def test_large_but_sane_content_length_unaffected(self, front):
        body = b"z" * 70000
        with socket.create_connection(("127.0.0.1", front.port), timeout=10) as s:
            req = (
                b"POST /take/bigbody?rate=5:1h HTTP/1.1\r\nHost: x\r\n"
                b"Content-Length: %d\r\n\r\n%s" % (len(body), body)
            )
            got = _roundtrip(s, req * 2, 2)
        assert [g[0] for g in got] == [200, 200]

    def test_h2c_preface_answered_natively(self, front):
        """A prior-knowledge preface gets the front's own h2 handshake:
        its SETTINGS, then an ACK of ours (no h2 backend is set here)."""
        _native_h2()
        assert front.h2_mode == "native"
        with socket.create_connection(("127.0.0.1", front.port), timeout=10) as s:
            s.sendall(h2.PREFACE)
            s.sendall(h2.frame(h2.SETTINGS, 0, 0, b""))
            data = b""
            deadline = time.monotonic() + 10
            while len(data) < 18 and time.monotonic() < deadline:
                chunk = s.recv(65536)
                if not chunk:
                    break
                data += chunk
        assert data[3] == h2.SETTINGS and data[4] & 1 == 0
        ln = (data[0] << 16) | (data[1] << 8) | data[2]
        nxt = data[9 + ln:]
        assert nxt[3] == h2.SETTINGS and nxt[4] & 1 == 1  # ACK

    def test_connection_churn_and_aborts(self, front):
        """120 one-shot connections, a third aborted mid-header: slot
        recycling never answers the wrong connection or wedges the front."""
        for i in range(120):
            s = socket.create_connection(("127.0.0.1", front.port), timeout=10)
            try:
                if i % 3 == 0:
                    s.sendall(b"POST /take/churn?rate=5:")
                    continue
                s.sendall(
                    b"POST /take/churn-%d?rate=5:1h HTTP/1.1\r\nHost: x\r\n\r\n" % (i % 7)
                )
                data = b""
                while b"\r\n\r\n" not in data:
                    chunk = s.recv(65536)
                    if not chunk:
                        break
                    data += chunk
                assert data.split(b" ", 2)[1] in (b"200", b"429"), data[:60]
            finally:
                s.close()
        c = http.client.HTTPConnection("127.0.0.1", front.port, timeout=10)
        try:
            c.request("POST", "/take/churn-final?rate=2:1h")
            r = c.getresponse()
            assert r.status == 200 and r.read() == b"1"
        finally:
            c.close()

    @pytest.mark.parametrize("proto", ["h1", "h2"])
    def test_blast_client_end_to_end(self, front, proto):
        """The C++ load clients (h1 keep-alive and h2 prior knowledge)
        against the real front: every answer a 200 or a 429, p50 <= p99."""
        if proto == "h2":
            _native_h2()
        lib = native.load()
        blast = lib.pt_http_blast if proto == "h1" else lib.pt_http_blast_h2
        target = b"/take/blast-%s?rate=1000:1s" % proto.encode()
        warm = np.zeros(5, np.uint64)
        blast(b"127.0.0.1", front.port, target, 2, 1, 300, warm)
        out = np.zeros(5, np.uint64)
        assert blast(b"127.0.0.1", front.port, target, 4, 2, 500, out) == 0
        assert int(out[0]) > 100
        assert 0 < int(out[1]) <= int(out[2])
        assert int(out[3]) + int(out[4]) == int(out[0])
        assert int(out[3]) > 0

    def test_promotion_bypasses_drain_cadence(self, monkeypatch):
        """A take-pressure promote event that wakes the pump's poll runs a
        promotions-only drain instead of waiting out the broadcast cadence."""
        from patrol_tpu_torch.net.native_http import NativeHTTPFront

        monkeypatch.setattr(hoststore, "NATIVE_PROMOTE_TAKES", 8)
        engine = DeviceEngine(LimiterConfig(buckets=64, nodes=4), node_slot=0,
                              device="cpu", native_host=True)
        f = None
        try:
            assert engine._native_store is not None
            f = NativeHTTPFront(API(TPURepo(engine), stats=lambda: {}), "127.0.0.1", 0)
            conn = http.client.HTTPConnection("127.0.0.1", f.port, timeout=10)
            try:
                # The first take binds and hosts the bucket through the
                # pump; the rest are answered in front and cross the
                # promote threshold.
                for _ in range(16):
                    conn.request("POST", "/take/promote-me?rate=1000000:1s")
                    conn.getresponse().read()
            finally:
                conn.close()
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and engine.promotions == 0:
                time.sleep(0.01)
            assert engine.promotions >= 1, "the promote event was never drained"
        finally:
            if f is not None:
                f.close()
            engine.stop()


@pytest.fixture(scope="module")
def node():
    """A port node started the way the CLI starts one on the native front
    (``Command(http_front="native")``: the C++ front over the engine's
    native store, a loopback asyncio h2 server as its splice backend)."""
    if native.load() is None:
        pytest.skip("the native host library does not build here")
    from test_torch_api import Node, _free_port

    from patrol_tpu_torch.command import Command

    n = Node(Command(
        api_addr="127.0.0.1:0", node_addr=f"127.0.0.1:{_free_port(socket.SOCK_DGRAM)}",
        config=LimiterConfig(buckets=256, nodes=4), handle_signals=False,
        device="cpu", http_front="native", udp_backend="asyncio",
    ))
    try:
        assert n.cmd.native_front.h2_backend_port > 0
        yield n.cmd
    finally:
        n.close()


def _parse_frames(buf: bytes):
    out, off = [], 0
    while off + 9 <= len(buf):
        ln = int.from_bytes(buf[off : off + 3], "big")
        if off + 9 + ln > len(buf):
            break
        sid = int.from_bytes(buf[off + 5 : off + 9], "big") & 0x7FFFFFFF
        out.append((buf[off + 3], buf[off + 4], sid, buf[off + 9 : off + 9 + ln]))
        off += 9 + ln
    return out


def _req_block(path: bytes) -> bytes:
    return (
        h2._encode_literal(b":method", b"POST")
        + h2._encode_literal(b":scheme", b"http")
        + h2._encode_literal(b":authority", b"x")
        + h2._encode_literal(b":path", path)
    )


def _h2_connect(port):
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    s.sendall(h2.PREFACE + h2.frame(h2.SETTINGS, 0, 0, b""))
    return s


class TestH2NativeHardening:
    def test_rst_stream_then_ring_completion_suppressed(self, node):
        """A fresh bucket's first take rides the Python pump, so its
        completion lands after the RST_STREAM sent with it: the front must
        drop it (HEADERS on a reset stream is a protocol error)."""
        _native_h2()
        s = _h2_connect(node.api_port)
        try:
            s.sendall(
                h2.frame(h2.HEADERS, h2.FLAG_END_HEADERS | h2.FLAG_END_STREAM, 1,
                         _req_block(b"/take/rst-dropped?rate=5:1s"))
                + h2.frame(h2.RST_STREAM, 0, 1, int.to_bytes(8, 4, "big"))
            )
            # Stream 3 goes out once stream 1's take has completed (and been
            # dropped): its bucket exists and its ticket is done.
            deadline = time.monotonic() + 10
            while node.engine.directory.lookup("rst-dropped") is None or \
                    node.engine.directory.pins.any():
                assert time.monotonic() < deadline, "the first take never completed"
                time.sleep(0.01)
            s.sendall(h2.frame(h2.HEADERS, h2.FLAG_END_HEADERS | h2.FLAG_END_STREAM, 3,
                               _req_block(b"/take/rst-live?rate=5:1s")))
            s.settimeout(0.5)
            buf, frames = b"", []
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                try:
                    buf += s.recv(65536)
                except socket.timeout:
                    continue
                frames = _parse_frames(buf)
                if any(t == h2.DATA and sid == 3 and fl & h2.FLAG_END_STREAM
                       for t, fl, sid, _p in frames):
                    break
            assert any(t == h2.DATA and sid == 3 for t, _f, sid, _p in frames)
            leaked = [(t, sid) for t, _f, sid, _p in frames
                      if sid == 1 and t in (h2.HEADERS, h2.DATA)]
            assert leaked == [], f"a response leaked onto the reset stream: {leaked}"
        finally:
            s.close()

    def test_upload_larger_than_stream_window(self, node):
        """A request body past 64 KiB does not wedge its stream: the front
        credits the stream window beside the connection one. The client
        keeps both windows like a conforming peer."""
        _native_h2()
        total = 200_000
        s = _h2_connect(node.api_port)
        try:
            s.sendall(h2.frame(h2.HEADERS, h2.FLAG_END_HEADERS, 1,
                               _req_block(b"/take/bigupload?rate=5:1s")))
            s.settimeout(0.3)
            conn_win = stream_win = 65535
            sent = 0
            body_done = got_stream_update = response = False
            buf = b""
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline and not (body_done and response):
                while sent < total and min(conn_win, stream_win) > 0:
                    n = min(16384, total - sent, conn_win, stream_win)
                    s.sendall(h2.frame(h2.DATA, 0, 1, b"x" * n))
                    sent += n
                    conn_win -= n
                    stream_win -= n
                if sent >= total and not body_done:
                    s.sendall(h2.frame(h2.DATA, h2.FLAG_END_STREAM, 1, b""))
                    body_done = True
                try:
                    buf += s.recv(65536)
                except socket.timeout:
                    continue
                frames = _parse_frames(buf)
                buf = buf[sum(9 + len(p) for *_x, p in frames):]
                for ftype, _fl, sid, payload in frames:
                    if ftype == h2.WINDOW_UPDATE and len(payload) == 4:
                        incr = int.from_bytes(payload, "big") & 0x7FFFFFFF
                        if sid == 0:
                            conn_win += incr
                        elif sid == 1:
                            stream_win += incr
                            got_stream_update = True
                    elif ftype == h2.HEADERS and sid == 1:
                        response = True
            assert got_stream_update, "no per-stream WINDOW_UPDATE credit"
            assert body_done, "the upload wedged behind the spent stream window"
            assert response
        finally:
            s.close()


def curl_h2(port, *args):
    out = subprocess.run(
        [CURL, "-s", "--http2-prior-knowledge", "-w", "\n%{http_code} %{http_version}"]
        + list(args),
        capture_output=True, timeout=30, text=True,
    )
    assert out.returncode == 0, out.stderr
    *body, tail = out.stdout.rsplit("\n", 1)
    code, version = tail.split(" ")
    return int(code), version, body[0] if body else ""


@pytest.mark.skipif(CURL is None, reason="curl unavailable")
class TestH2OverNativeFront:
    """curl --http2-prior-knowledge against the native front of a node
    (native h2 when libnghttp2 loads, else the splice to its asyncio h2
    backend): the API's behaviour table over h2, and state shared with
    h1 on the same port."""

    def _url(self, node, path):
        return f"http://127.0.0.1:{node.api_port}{path}"

    def test_take_success(self, node):
        code, version, body = curl_h2(node.api_port, "-X", "POST",
                                      self._url(node, "/take/nh2?rate=5:1s"))
        assert version == "2" and (code, body) == (200, "4")

    def test_name_too_long_400(self, node):
        code, version, _ = curl_h2(node.api_port, "-X", "POST",
                                   self._url(node, f"/take/{'x' * 240}?rate=5:1s"))
        assert version == "2" and code == 400

    def test_missing_rate_429_zero(self, node):
        code, version, body = curl_h2(node.api_port, "-X", "POST",
                                      self._url(node, "/take/nh2norate"))
        assert version == "2" and (code, body) == (429, "0")

    def test_zero_rate_429(self, node):
        code, version, body = curl_h2(node.api_port, "-X", "POST",
                                      self._url(node, "/take/nh2zero?rate=0:1s"))
        assert version == "2" and (code, body) == (429, "0")

    def test_default_count_one(self, node):
        url = self._url(node, "/take/nh2count?rate=10:1s")
        code, version, body = curl_h2(node.api_port, "-X", "POST", url)
        assert version == "2" and (code, body) == (200, "9")
        code, version, body = curl_h2(node.api_port, "-X", "POST", url + "&count=3")
        assert version == "2" and (code, body) == (200, "6")

    def test_h1_unaffected_on_same_port(self, node):
        conn = http.client.HTTPConnection("127.0.0.1", node.api_port, timeout=10)
        try:
            conn.request("POST", "/take/nh1?rate=5:1s")
            resp = conn.getresponse()
            assert resp.status == 200 and resp.read() == b"4"
        finally:
            conn.close()

    def test_state_shared_between_protocols(self, node):
        url = self._url(node, "/take/nhshared?rate=2:1h")
        for want in ("1", "0"):
            code, _, body = curl_h2(node.api_port, "-X", "POST", url)
            assert (code, body) == (200, want)
        conn = http.client.HTTPConnection("127.0.0.1", node.api_port, timeout=10)
        try:
            conn.request("POST", "/take/nhshared?rate=2:1h")
            resp = conn.getresponse()
            assert resp.status == 429 and resp.read() == b"0"
        finally:
            conn.close()

    def test_metrics_and_tokens_over_h2(self, node):
        code, version, body = curl_h2(node.api_port, self._url(node, "/metrics"))
        assert version == "2" and code == 200 and "engine_ticks" in body
        curl_h2(node.api_port, "-X", "POST", self._url(node, "/take/nhtok?rate=5:1h&count=2"))
        code, _, body = curl_h2(node.api_port, self._url(node, "/tokens/nhtok"))
        assert (code, body) == (200, "3")


def test_h2_window_of_data_in_the_first_read(front):
    """A client may send a whole 64 KiB stream window of DATA right behind
    the preface, and the front's first read can hold all of it: the
    connection is still an h2 one and must not meet the h1 read cap."""
    _native_h2()
    msg = (
        h2.PREFACE + h2.frame(h2.SETTINGS, 0, 0, b"")
        + h2.frame(h2.HEADERS, h2.FLAG_END_HEADERS, 1, _req_block(b"/take/firstread?rate=5:1s"))
        + b"".join(h2.frame(h2.DATA, 0, 1, b"x" * n) for n in (16384, 16384, 16384, 16383))
    )
    s = socket.create_connection(("127.0.0.1", front.port), timeout=10)
    try:
        s.sendall(msg)
        s.settimeout(0.2)
        buf, frames = b"", []
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            try:
                chunk = s.recv(65536)
            except socket.timeout:
                continue
            assert chunk, "the front closed the h2 connection"
            buf += chunk
            frames = _parse_frames(buf)
            if any(t == h2.HEADERS and sid == 1 for t, _f, sid, _p in frames):
                break
        assert any(t == h2.HEADERS and sid == 1 for t, _f, sid, _p in frames)
        assert any(t == h2.WINDOW_UPDATE and sid == 1 for t, _f, sid, _p in frames)
    finally:
        s.close()


def test_mixed_cluster_on_native_fronts_converges():
    """A port node on the native front with host lanes in its C++ store
    (native UDP backend), peered with a JAX node at its defaults (its
    native front and store): takes through both fronts, most answered in
    C++, converge to equal state, one token in a lane per admitted take.
    Frozen clocks; both CPU."""
    from test_torch_replication import (
        BUCKETS, BUDGET_S, FROZEN, NODES, Node, converge, free_port, taken_tokens,
        wait_capable,
    )

    from patrol_tpu import native as jnative
    from patrol_tpu.command import Command as JCommand
    from patrol_tpu.models.limiter import LimiterConfig as JConfig
    from patrol_tpu_torch.command import Command as TCommand

    if jnative.load() is None:
        pytest.skip("the JAX package's native library does not load here")
    budget = time.monotonic() + BUDGET_S
    addrs = [f"127.0.0.1:{free_port()}" for _ in range(2)]
    jport = free_port(socket.SOCK_STREAM)
    nodes = []
    try:
        nodes.append(Node(JCommand(
            api_addr=f"127.0.0.1:{jport}", node_addr=addrs[0], peer_addrs=addrs,
            clock=lambda: FROZEN, config=JConfig(BUCKETS, NODES), handle_signals=False,
            shutdown_timeout_s=5.0,
        )))
        nodes.append(Node(TCommand(
            api_addr="127.0.0.1:0", node_addr=addrs[1], peer_addrs=addrs,
            clock=lambda: FROZEN, config=LimiterConfig(BUCKETS, NODES),
            handle_signals=False, shutdown_timeout_s=5.0, device="cpu",
            http_front="native",
        )))
        cmds = [n.cmd for n in nodes]
        assert all(c.engine._native_store is not None for c in cmds)
        wait_capable(cmds, budget)
        # Each node hosts its own names (a bucket is hosted where it is
        # first taken; one created by a peer's replication is not), then
        # both take the other's.
        own = {jport: [f"j{i}" for i in range(6)],
               cmds[1].api_port: [f"p{i}" for i in range(6)]}
        names = own[jport] + own[cmds[1].api_port]
        admitted = 0
        for rnd in range(4):
            for port in own:
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
                try:
                    for nm in own[port] if rnd < 3 else names:
                        conn.request("POST", f"/take/{nm}?rate=100:1h")
                        resp = conn.getresponse()
                        assert resp.status in (200, 429)
                        resp.read()
                        admitted += resp.status == 200
                finally:
                    conn.close()
        view = converge(cmds, names, budget)
        assert admitted == 2 * 3 * 6 + 2 * len(names)
        assert taken_tokens(view) == admitted
        assert all(c.engine._native_store.native_takes > 0 for c in cmds)
    finally:
        for n in nodes:
            n.close()
