"""The port's native host-lane store (``runtime/hoststore.py`` over the
C++ ``HostStore`` of ``native/patrol_http.cpp``), twin of
``tests/test_native_hls.py``.

Host-resident takes are served in C++ on the native front's epoll thread.
The invariant, extended from the fast-path tests: a bucket answers the same
whether the take is served by Python ``HostLanes``, by the C++ in-front
path or on the device, and the engine's Python paths see exactly the bytes
the C++ side wrote, because they are the same bytes. The C++ take is also
held to the JAX package's ``HostLanes.take``. Every engine runs on
``device="cpu"``; every front and engine is stopped by its fixture.
"""

import ctypes
import http.client
import threading
import time

import numpy as np
import pytest

from patrol_tpu.runtime.engine import HostLanes as JHostLanes
from patrol_tpu.ops.rate import Rate as JRate
from patrol_tpu_torch import native
from patrol_tpu_torch.models.limiter import NANO, LimiterConfig
from patrol_tpu_torch.net import h2 as h2mod
from patrol_tpu_torch.net.api import API
from patrol_tpu_torch.ops.rate import Rate
from patrol_tpu_torch.runtime import engine as engine_mod
from patrol_tpu_torch.runtime import hoststore
from patrol_tpu_torch.runtime.engine import DeviceEngine, HostLanes
from patrol_tpu_torch.runtime.repo import TPURepo

CFG = LimiterConfig(buckets=64, nodes=4)
RATE = Rate(freq=10, per_ns=NANO)


@pytest.fixture(autouse=True)
def _needs_native():
    if native.load() is None:
        pytest.skip("the native host library does not build here")


class FakeClock:
    def __init__(self, start_ns: int = 0):
        self.now = start_ns

    def __call__(self) -> int:
        return self.now

    def advance(self, ns: int) -> None:
        self.now += ns


def _probe(eng, name: str, rate: Rate, count: int, now: int):
    """Run the C++ in-front take path (resolve + residency +
    hls_take_locked) with an explicit clock; → (remaining, ok), or None
    when the bucket is not servable in front."""
    st = eng._native_store
    raw = name.encode()
    buf = np.zeros(256, np.uint8)
    buf[: len(raw)] = np.frombuffer(raw, np.uint8)
    rem = ctypes.c_int64(0)
    rc = st.lib.pt_hls_take_probe(
        st.h, eng.directory._ptdir, buf, len(raw),
        rate.freq, rate.per_ns, count, now, ctypes.byref(rem),
    )
    if rc < 0:
        return None
    return rem.value, bool(rc)


def _engine(clock=None):
    eng = DeviceEngine(CFG, node_slot=0, clock=clock or FakeClock(), device="cpu",
                       native_host=True)
    assert eng._native_store is not None
    return eng


@pytest.fixture
def engine():
    eng = _engine()
    yield eng
    eng.stop()


class TestTakeParity:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_randomized_differential(self, engine, seed):
        """The C++ take against ``HostLanes.take`` (the port's and the JAX
        package's) on the same state: refill, over-take, forfeits and the
        zero-rate edge, over random rates, counts and clock steps."""
        clock = engine.clock
        clock.now = 1000
        engine.take("k", RATE, 1)  # binds and hosts through the Python path
        row = engine.directory.lookup("k")
        cap = int(engine.directory.cap_base_nt[row])
        created = int(engine.directory.created_ns[row])
        shadows = (HostLanes(CFG.nodes), JHostLanes(CFG.nodes))
        with engine._host_mu:
            lanes = engine._hosted[row]
            for sh in shadows:
                sh.added[:] = lanes.added
                sh.taken[:] = lanes.taken
                sh.elapsed_ns = lanes.elapsed_ns
        rng = np.random.default_rng(seed)
        now = clock.now
        for i in range(300):
            now += int(rng.integers(0, NANO // 2))
            freq = int(rng.integers(0, 30))  # 0 is the zero-rate edge
            count = int(rng.integers(1, 4))
            got = _probe(engine, "k", Rate(freq=freq, per_ns=NANO), count, now)
            assert got is not None, f"step {i}: the row is no longer served in front"
            want = shadows[0].take(cap, created, now, Rate(freq=freq, per_ns=NANO), count, 0)
            ref = shadows[1].take(cap, created, now, JRate(freq=freq, per_ns=NANO), count, 0)
            assert got == want == ref, f"seed {seed} step {i}: {got} {want} {ref}"
        with engine._host_mu:
            lanes = engine._hosted[row]
            for sh in shadows:
                assert lanes.added.tolist() == sh.added.tolist()
                assert lanes.taken.tolist() == sh.taken.tolist()
                assert lanes.elapsed_ns == sh.elapsed_ns

    def test_probe_misses_unbound_and_device_rows(self, engine):
        assert _probe(engine, "ghost", RATE, 1, 0) is None
        n = engine_mod.HOST_PROMOTE_TAKES + 5
        for _ in range(n):
            engine.take("dev", Rate(freq=2 * n, per_ns=NANO), 1)
        assert engine.flush()
        assert engine.hosted_buckets == 0
        assert _probe(engine, "dev", RATE, 1, 0) is None

    def test_native_takes_counted(self, engine):
        engine.take("c", RATE, 1)
        base = engine.host_takes
        _probe(engine, "c", RATE, 1, engine.clock.now)
        assert engine.host_takes == base + 1
        assert engine._native_store.stats()["native_host_takes"] == 1

    def test_eviction_stops_in_front_serving(self, engine):
        engine.take("gone", RATE, 1)
        assert _probe(engine, "gone", RATE, 1, engine.clock.now) is not None
        assert engine.release_bucket("gone")
        assert _probe(engine, "gone", RATE, 1, engine.clock.now) is None

    def test_demoted_row_is_served_in_front_again(self, engine):
        """Promote, idle a demote window, demote: the C++ path serves the
        row again from lanes seeded by the device gather."""
        n = engine_mod.HOST_PROMOTE_TAKES + 5
        rate = Rate(freq=4 * n, per_ns=NANO)
        for _ in range(n):
            engine.take("back", rate, 1)
        assert engine.flush()
        assert _probe(engine, "back", rate, 1, engine.clock.now) is None
        engine.clock.advance(engine_mod.HOST_DEMOTE_WINDOW_NS + 1)
        engine.take("back", rate, 1)
        engine.clock.advance(engine_mod.HOST_DEMOTE_WINDOW_NS + 1)
        engine.take("back", rate, 1)  # ends the idle window: demoted, host-served
        assert engine.demotions == 1
        got = _probe(engine, "back", rate, 1, engine.clock.now)
        assert got is not None and got[1]
        assert engine.tokens_if_known("back") == got[0]

    def test_drain_emits_coalesced_broadcast(self, engine):
        got = []
        engine.on_broadcast = got.append
        engine.take("bc", RATE, 2)  # the Python-path take broadcasts itself
        got.clear()
        _probe(engine, "bc", RATE, 3, engine.clock.now)
        _probe(engine, "bc", RATE, 1, engine.clock.now)
        engine.drain_native_broadcasts()
        # Two in-front takes coalesce into ONE latest-state broadcast.
        assert len(got) == 1 and len(got[0]) == 1
        st = got[0][0]
        assert st.name == "bc"
        assert st.lane_taken_nt == 6 * NANO  # 2 + 3 + 1
        assert st.cap_nt == 10 * NANO
        got.clear()
        engine.drain_native_broadcasts()
        assert got == []  # drained clean

    def test_native_take_pressure_promotes_when_enabled(self, monkeypatch):
        monkeypatch.setattr(hoststore, "NATIVE_PROMOTE_TAKES", 8)
        eng = _engine()
        try:
            eng.take("hot", Rate(freq=1000, per_ns=NANO), 1)
            for _ in range(12):
                _probe(eng, "hot", Rate(freq=1000, per_ns=NANO), 1, 0)
            assert eng._native_store.events > 0
            eng.drain_native_promotions()  # marks the promotion
            assert eng.flush()  # the feeder joins it
            assert eng.hosted_buckets == 0
            assert eng.promotions == 1
            pn, _ = eng.read_rows([eng.directory.lookup("hot")])
            assert int(pn[0][:, 1].sum()) == 13 * NANO  # nothing lost
        finally:
            eng.stop()


@pytest.fixture
def stack():
    """A CPU engine with a native store behind the native front."""
    from patrol_tpu_torch.net.native_http import NativeHTTPFront

    eng = DeviceEngine(CFG, node_slot=0, device="cpu", native_host=True)
    front = None
    try:
        front = NativeHTTPFront(API(TPURepo(eng), stats=lambda: {}), "127.0.0.1", 0)
        yield eng, front
    finally:
        if front is not None:
            front.close()
        eng.stop()


def _take(port, name, rate="5:1h", count=None):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        q = f"/take/{name}?rate={rate}" + (f"&count={count}" if count else "")
        c.request("POST", q)
        r = c.getresponse()
        return r.status, r.read()
    finally:
        c.close()


class TestInFrontEndToEnd:
    def test_sequence_and_in_front_counter(self, stack):
        eng, front = stack
        results = [_take(front.port, "seq") for _ in range(7)]
        assert [r[0] for r in results] == [200] * 5 + [429] * 2
        assert [r[1] for r in results] == [b"4", b"3", b"2", b"1", b"0", b"0", b"0"]
        # Everything after the binding first take was served in front.
        assert eng._native_store.native_takes >= 5
        assert eng.ticks == 0  # and nothing reached the device

    def test_broadcast_flows_from_in_front_takes(self, stack):
        eng, front = stack
        got = []
        lock = threading.Lock()

        def collect(states):
            with lock:
                got.extend(states)

        eng.on_broadcast = collect
        for _ in range(4):
            _take(front.port, "flow", rate="100:1h")
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            with lock:
                if any(s.name == "flow" and s.taken_nt == 4 * NANO for s in got):
                    break
            time.sleep(0.01)
        with lock:
            final = [s for s in got if s.name == "flow"]
        assert final, "no broadcast drained from the in-front takes"
        assert final[-1].taken_nt == 4 * NANO
        assert final[-1].cap_nt == 100 * NANO

    def test_api_behavior_table_over_native_h2(self, stack):
        """The API's behaviour table over the front's own h2c: name too
        long → 400, no rate → 429 "0", default count, zero rate → 429, a
        non-POST → 405, as over h1."""
        import socket as sk

        from patrol_tpu_torch.net.native_http import native_h2

        if not (h2mod.available() and native_h2()):
            pytest.skip("libnghttp2 unavailable")
        eng, front = stack
        assert front.h2_mode == "native"

        def req_headers(method: str, path: str) -> bytes:
            return (
                h2mod._encode_literal(b":method", method.encode())
                + h2mod._encode_literal(b":scheme", b"http")
                + h2mod._encode_literal(b":authority", b"x")
                + h2mod._encode_literal(b":path", path.encode())
            )

        requests = [
            ("POST", "/take/" + "x" * 240),       # 400 name too long
            ("POST", "/take/h2tbl-norate"),       # 429 body "0"
            ("POST", "/take/h2tbl-a?rate=2:1h"),  # 200 "1" (count=1)
            ("POST", "/take/h2tbl-a?rate=2:1h"),  # 200 "0"
            ("POST", "/take/h2tbl-a?rate=2:1h"),  # 429 "0"
            ("POST", "/take/h2tbl-z?rate=0:1s"),  # 429 zero rate
            ("GET", "/take/h2tbl-g?rate=5:1s"),   # 405
        ]
        dec = h2mod.HpackDecoder()
        s = sk.create_connection(("127.0.0.1", front.port), timeout=10)
        try:
            s.sendall(h2mod.PREFACE + h2mod.frame(h2mod.SETTINGS, 0, 0, b""))
            for i, (method, path) in enumerate(requests):
                s.sendall(h2mod.frame(
                    h2mod.HEADERS, h2mod.FLAG_END_HEADERS | h2mod.FLAG_END_STREAM,
                    1 + 2 * i, req_headers(method, path),
                ))
            out, status_of, buf = {}, {}, b""
            while len(out) < len(requests):
                chunk = s.recv(65536)
                assert chunk, f"closed with {len(out)} responses"
                buf += chunk
                while len(buf) >= 9:
                    ln = (buf[0] << 16) | (buf[1] << 8) | buf[2]
                    if len(buf) < 9 + ln:
                        break
                    ftype, flags = buf[3], buf[4]
                    sid = int.from_bytes(buf[5:9], "big") & 0x7FFFFFFF
                    payload = buf[9 : 9 + ln]
                    if ftype == h2mod.SETTINGS and not (flags & 1):
                        s.sendall(h2mod.frame(h2mod.SETTINGS, 1, 0, b""))
                    elif ftype == h2mod.HEADERS:
                        status_of[sid] = int(dict(dec.decode(payload))[b":status"])
                    elif ftype == h2mod.DATA and flags & h2mod.FLAG_END_STREAM:
                        out[sid] = (status_of[sid], payload)
                    buf = buf[9 + ln :]
        finally:
            s.close()
        results = [out[1 + 2 * i] for i in range(len(requests))]
        assert [r[0] for r in results] == [400, 429, 200, 200, 429, 429, 405]
        assert results[1][1] == b"0"
        assert [r[1] for r in results[2:5]] == [b"1", b"0", b"0"]

    def test_mixed_residency_fallthrough(self, stack, monkeypatch):
        """Device-resident buckets ride the take-n tick, host-resident ones
        are answered in front, in one keep-alive session."""
        eng, front = stack
        # A real clock: hold both windows open so the Python loop's takes
        # cross the promote threshold and nothing demotes mid-test.
        monkeypatch.setattr(engine_mod, "HOST_PROMOTE_WINDOW_NS", 10**15)
        monkeypatch.setattr(engine_mod, "HOST_DEMOTE_WINDOW_NS", 10**15)
        n = engine_mod.HOST_PROMOTE_TAKES + 5
        for _ in range(n):
            eng.take("ringy", Rate(freq=4 * n, per_ns=NANO), 1)
        assert eng.flush()
        assert eng.hosted_buckets == 0  # promoted: device-resident
        ticks = eng.ticks
        s1, b1 = _take(front.port, "ringy", rate=f"{4 * n}:1s")
        assert s1 == 200 and eng.ticks > ticks
        s2, b2 = _take(front.port, "hosty", rate="3:1h")
        assert (s2, b2) == (200, b"2")
        assert eng.hosted_buckets == 1


def test_directory_arrays_held_by_the_store_stay_put(engine):
    """``pt_hls_create`` keeps pointers to three directory arrays: binding,
    evicting and releasing rows never rebinds them."""
    d = engine.directory
    held = [a.ctypes.data for a in (d.cap_base_nt, d.created_ns, d.last_used_ns)]
    for i in range(CFG.buckets + 8):  # past capacity: evictions
        engine.take(f"n{i}", RATE, 1)
    engine.release_bucket(f"n{CFG.buckets + 7}")
    assert [a.ctypes.data for a in (d.cap_base_nt, d.created_ns, d.last_used_ns)] == held
