"""The port's native host library (``patrol_tpu_torch/native``): where it is
built, and its codec, sockets, rx ring and resolver against the port's
Python code and the JAX package.

* the loader builds ``libpatrolhost.so`` from the port's own copies of
  the C++ sources into ``patrol_tpu_torch/_build/host-<key>/`` and
  nowhere else, several processes may start the build at once, a failed
  build raises with g++'s output, and every bound symbol has an entry in
  ``NATIVE_EFFECTS``;
* twins of ``tests/test_native.py``: the C++ batch codec agrees bit for
  bit with the port's ``ops/wire.py`` (golden states and a garbage fuzz),
  the recvmmsg/sendmmsg socket path moves real packets on loopback,
  multi-lane trailers decode to their flags, duplicate lane deltas fold
  to their max in ``pt_rx_classify`` (on the port's engine, against the
  JAX engine's state), and the resolver keeps its collision discipline;
* the rx ring leases, commits and recycles planes zero-copy, and a ring
  closed with a plane still leased is released by that plane's commit.

All on the CPU; the library is required here (no skip): g++ builds it.
"""

import ctypes
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from patrol_tpu_torch import native
from patrol_tpu_torch.models.limiter import LimiterConfig
from patrol_tpu_torch.ops import wire
from patrol_tpu_torch.runtime.engine import DeviceEngine

PKG_DIR = Path(native.__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def lib():
    return native.load(required=True)


# -- the build -----------------------------------------------------------------


def test_library_builds_under_the_ignored_build_dir_only(lib):
    so = Path(lib._name).resolve()
    assert so == native.lib_path().resolve()
    assert so.parent.parent == (PKG_DIR / "_build").resolve()
    assert so.parent.name.startswith("host-") and so.name == "libpatrolhost.so"
    # Built from the port's own sources, never beside them, never from
    # the JAX package's.
    assert {p.parent for p in native.SOURCES} == {PKG_DIR / "native"}
    assert not list((PKG_DIR / "native").glob("*.so"))
    ignore = (PKG_DIR.parent / ".gitignore").read_text().split()
    assert "patrol_tpu_torch/_build/" in ignore, "the build directory is not git-ignored"


def test_concurrent_builds_share_one_library(tmp_path):
    # Three processes build the same sources into an empty build dir at
    # once: one compiles under the lock, the others load its result.
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from patrol_tpu_torch import native\n"
        "native.BUILD_DIR = Path(sys.argv[1])\n"
        "so = native.build()\n"
        "native.load(required=True)\n"
        "print(so)\n"
    )
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", code, str(tmp_path)], cwd=PKG_DIR.parent,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for _ in range(3)
    ]
    outs = [p.communicate(timeout=600) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1
    built = list(tmp_path.rglob("libpatrolhost.so*"))
    assert [p.name for p in built] == ["libpatrolhost.so"]  # no temporaries left


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(native, "SOURCES", (bad,))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(native.NativeBuildError) as exc:
        native.build()
    assert "broken.cpp" in str(exc.value)
    assert not list((tmp_path / "build").rglob("*.so"))


def test_required_load_raises_after_a_failed_build(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_error", None)

    def fail():
        raise native.NativeBuildError("g++ failed (rc 1):\nbroken")

    monkeypatch.setattr(native, "build", fail)
    assert native.load() is None  # auto callers take the Python path
    with pytest.raises(native.NativeBuildError, match="broken"):
        native.load(required=True)


def test_every_bound_symbol_declares_its_effects(lib):
    src = Path(native.__file__).read_text()
    bound = set()
    for line in src.splitlines():
        line = line.strip()
        if line.startswith("lib.pt_") and ".argtypes" in line:
            bound.add(line.split(".")[1])
    assert bound == set(native.NATIVE_EFFECTS)
    for name in bound:
        assert getattr(lib, name) is not None


# -- codec cross-validation (twins of tests/test_native.py) --------------------


def test_encode_matches_python(lib):
    states = [
        wire.WireState("bucket-a", 5.25, 1.5, 12345, origin_slot=3),
        wire.WireState("b", 0.0, 0.0, 0, origin_slot=0),
        wire.WireState("no-trailer", 9.0, 2.0, -5),
        wire.WireState("µ≠ascii", 1.0, 1.0, 7, origin_slot=65535),
        wire.WireState("with-cap", 12.0, 3.0, 55, origin_slot=9, cap_nt=10 * wire.NANO),
        wire.WireState("cap-zero", 1.0, 0.0, 1, origin_slot=2, cap_nt=0),
        wire.WireState(
            "lane", 12.0, 3.0, 55, origin_slot=1, cap_nt=10 * wire.NANO,
            lane_added_nt=2 * wire.NANO, lane_taken_nt=wire.NANO,
        ),
    ]
    packets, sizes = native.encode_batch(
        [s.added for s in states],
        [s.taken for s in states],
        [s.elapsed_ns for s in states],
        [s.name for s in states],
        [s.origin_slot if s.origin_slot is not None else -1 for s in states],
        [s.cap_nt if s.cap_nt is not None else -1 for s in states],
        [s.lane_added_nt if s.lane_added_nt is not None else -1 for s in states],
        [s.lane_taken_nt if s.lane_taken_nt is not None else -1 for s in states],
    )
    for i, s in enumerate(states):
        assert bytes(packets[i, : sizes[i]]) == wire.encode(s), f"state {i}"


def _same_float(a, b):
    return a == b or (a != a and b != b)


def _check_against_python(pkts, sizes, out, idx):
    added, taken, elapsed, names, slots, valid, caps, la, lt = out
    for i in idx:
        data = bytes(pkts[i, : sizes[i]])
        try:
            ref = wire.decode(data)
        except ValueError:
            assert not valid[i], f"pkt {i}: python rejects, C++ accepts"
            continue
        assert valid[i], f"pkt {i}: python accepts, C++ rejects"
        assert names[i] == ref.name
        assert _same_float(added[i], ref.added), f"pkt {i} added"
        assert _same_float(taken[i], ref.taken), f"pkt {i} taken"
        assert int(elapsed[i]) == ref.elapsed_ns
        want = [-1 if v is None else v for v in
                (ref.origin_slot, ref.cap_nt, ref.lane_added_nt, ref.lane_taken_nt)]
        assert [int(slots[i]), int(caps[i]), int(la[i]), int(lt[i])] == want, f"pkt {i}"


def test_decode_matches_python(lib):
    raw_states = [
        wire.WireState("x" * 100, 1e9, 2.5, 99, origin_slot=12),
        wire.WireState("", 0.5, 0.25, 2**40),
        wire.WireState("k", -3.0, float("inf"), -1),
        wire.WireState("capped", 7.0, 1.0, 3, origin_slot=4, cap_nt=5 * wire.NANO),
        wire.WireState(
            "laned", 7.0, 1.0, 3, origin_slot=4, cap_nt=5 * wire.NANO,
            lane_added_nt=wire.NANO, lane_taken_nt=2 * wire.NANO,
        ),
        # Hostile bit-63 trailer fields: both decoders drop the WHOLE
        # trailer (all-or-nothing).
        wire.WireState(
            "evil-lane", 7.0, 1.0, 3, origin_slot=4, cap_nt=5 * wire.NANO,
            lane_added_nt=1 << 63, lane_taken_nt=2 * wire.NANO,
        ),
        wire.WireState(
            "evil-cap", 7.0, 1.0, 3, origin_slot=4, cap_nt=1 << 63,
            lane_added_nt=wire.NANO, lane_taken_nt=2 * wire.NANO,
        ),
        wire.WireState("evil-caponly", 7.0, 1.0, 3, origin_slot=4, cap_nt=1 << 63),
    ]
    pkts = np.zeros((len(raw_states), native.PACKET), np.uint8)
    sizes = np.zeros(len(raw_states), np.int32)
    for i, s in enumerate(raw_states):
        data = wire.encode(s)
        pkts[i, : len(data)] = np.frombuffer(data, np.uint8)
        sizes[i] = len(data)
    out = native.decode_batch(pkts, sizes)
    assert out[5].all()
    _check_against_python(pkts, sizes, out, range(len(raw_states)))


def test_malformed_marked_invalid(lib):
    pkts = np.zeros((2, native.PACKET), np.uint8)
    sizes = np.array([10, 25], np.int32)  # short; header claims name > len
    pkts[1, 24] = 200
    valid = native.decode_batch(pkts, sizes)[5]
    assert not valid[0] and not valid[1]


def test_garbage_packet_differential_fuzz(lib):
    """Arbitrary byte packets decode IDENTICALLY in C++ and the port's
    Python codec: 2000 random packets, with truncations and planted
    trailer magic that reach the deep trailer-validation branches."""
    rng = np.random.default_rng(99)
    n = 2000
    pkts = np.zeros((n, native.PACKET), np.uint8)
    sizes = np.zeros(n, np.int32)
    for i in range(n):
        sz = int(rng.integers(0, native.PACKET + 1))
        body = rng.integers(0, 256, sz, dtype=np.uint8)
        if sz > 30 and i % 3 == 0:
            body[24] = int(rng.integers(0, sz - 25 + 1))
            tpos = 25 + int(body[24])
            if tpos + 6 <= sz:
                body[tpos : tpos + 2] = (ord("P"), ord("2"))
                body[tpos + 2] = int(rng.integers(0, 4))
        pkts[i, :sz] = body
        sizes[i] = sz
    out = native.decode_batch(pkts, sizes)
    _check_against_python(pkts, sizes, out, range(n))
    assert 0 < out[5].sum() < n  # both verdicts occur


def test_roundtrip_random(lib):
    rng = np.random.default_rng(5)
    n = 200
    added = rng.uniform(0, 1e6, n)
    taken = rng.uniform(0, 1e6, n)
    elapsed = rng.integers(0, 2**62, n)
    names = [f"bucket-{i}-{'x' * int(rng.integers(0, 100))}" for i in range(n)]
    slots = rng.integers(0, 256, n).astype(np.int32)
    pkts, sizes = native.encode_batch(added, taken, elapsed, names, slots)
    a2, t2, e2, n2, s2, valid, *_ = native.decode_batch(pkts, sizes)
    assert valid.all() and n2 == names
    np.testing.assert_array_equal(added, a2)
    np.testing.assert_array_equal(taken, t2)
    np.testing.assert_array_equal(elapsed, e2.astype(np.uint64))
    np.testing.assert_array_equal(slots, s2)


def test_codec_matches_the_jax_packages_library(lib):
    """The port's copy of the sources decodes as the JAX package's build
    does, byte for byte, on the fuzz corpus."""
    from patrol_tpu import native as jnative

    if jnative.load() is None:
        pytest.fail("the JAX package's native library did not build")
    rng = np.random.default_rng(7)
    n = 300
    pkts = rng.integers(0, 256, (n, native.PACKET), dtype=np.uint8)
    sizes = rng.integers(0, native.PACKET + 1, n).astype(np.int32)
    for i in range(0, n, 2):  # half of them valid states
        data = wire.encode(wire.WireState(f"n{i}", float(i), 0.5, i, origin_slot=i % 7))
        pkts[i] = 0
        pkts[i, : len(data)] = np.frombuffer(data, np.uint8)
        sizes[i] = len(data)
    a, _ = native.decode_batch_raw(pkts, sizes)
    b, _ = jnative.decode_batch_raw(pkts, sizes)
    for field in ("added", "taken", "elapsed", "names", "name_lens", "slots",
                  "caps", "lane_a", "lane_t", "hashes", "multi"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)


# -- sockets -------------------------------------------------------------------


def test_loopback_fanout_and_recv(lib):
    rx = native.NativeSocket("127.0.0.1", 0)
    tx = native.NativeSocket("127.0.0.1", 0)
    try:
        states = [wire.WireState(f"k{i}", float(i), 0.5, i, origin_slot=i) for i in range(20)]
        pkts, sizes = native.encode_batch(
            [s.added for s in states], [s.taken for s in states],
            [s.elapsed_ns for s in states], [s.name for s in states],
            [s.origin_slot for s in states],
        )
        ip = np.array([0x7F000001], np.uint32)  # 127.0.0.1
        assert tx.send_fanout(pkts, sizes, ip, np.array([rx.port], np.uint16)) == 20
        got = {}
        deadline = time.monotonic() + 5
        while len(got) < 20 and time.monotonic() < deadline:
            packets, szs, _, _, _ = rx.recv_batch(timeout_ms=200)
            a, _, _, names, slots, valid, *_ = native.decode_batch(packets, szs)
            for i in range(len(names)):
                if valid[i]:
                    got[names[i]] = (a[i], int(slots[i]))
        assert len(got) == 20 and got["k7"] == (7.0, 7)
    finally:
        rx.close()
        tx.close()


def test_fanout_to_multiple_peers(lib):
    rx1 = native.NativeSocket("127.0.0.1", 0)
    rx2 = native.NativeSocket("127.0.0.1", 0)
    tx = native.NativeSocket("127.0.0.1", 0)
    try:
        pkts, sizes = native.encode_batch([1.0], [0.0], [0], ["m"], [0])
        ips = np.array([0x7F000001, 0x7F000001], np.uint32)
        ports = np.array([rx1.port, rx2.port], np.uint16)
        assert tx.send_fanout(pkts, sizes, ips, ports) == 2
        for rx in (rx1, rx2):
            packets, szs, _, _, _ = rx.recv_batch(timeout_ms=2000)
            assert len(packets) == 1
            _, _, _, names, _, valid, *_ = native.decode_batch(packets, szs)
            assert valid[0] and names[0] == "m"
    finally:
        rx1.close()
        rx2.close()
        tx.close()


def test_recv_into_a_ring_plane_takes_full_delta_datagrams(lib):
    # The ring rows are DELTA_PACKET_SIZE wide: an 8 KiB dv2 interval
    # lands whole in the leased plane, not truncated at the v1 size.
    assert native.RX_RING_ROW == wire.DELTA_PACKET_SIZE
    ring = native.RxRing(n_planes=1, max_batch=4)
    rx = native.NativeSocket("127.0.0.1", 0)
    tx = native.NativeSocket("127.0.0.1", 0)
    try:
        ents = [wire.DeltaEntry(f"name-{i:04d}", 1, 0, i, i, i) for i in range(400)]
        data, packed = wire.encode_delta_packet(1, 1, (), ents)
        assert len(data) > 4096 and packed > 100
        idx = ring.lease()
        plane = ring.plane(idx)
        got = None
        deadline = time.monotonic() + 20
        while got is None:  # resend until it lands: loopback under load
            assert tx.send_fanout(
                np.frombuffer(data, np.uint8).reshape(1, -1), np.array([len(data)], np.int32),
                np.array([0x7F000001], np.uint32), np.array([rx.port], np.uint16),
            ) == 1
            packets, sizes, _, _, _ = rx.recv_batch_into(plane, timeout_ms=500)
            for i in range(len(packets)):
                if int(sizes[i]) == len(data) and bytes(plane[i, : len(data)]) == data:
                    got = i
            assert time.monotonic() < deadline, "the datagram never arrived whole"
        pkt = wire.decode_delta_packet(bytes(packets[got, : sizes[got]]))
        assert list(pkt.entries) == ents[:packed]
        ring.commit(idx)
    finally:
        ring.close()
        rx.close()
        tx.close()


# -- multi-lane trailers -------------------------------------------------------


def test_multi_trailer_flags(lib):
    multi = wire.encode(wire.WireState(
        "m", 9.0, 1.0, 7, origin_slot=3, cap_nt=5, lanes=((0, 10, 20), (2, 30, 40)),
    ))
    advert = wire.encode(wire.WireState("a", 0.0, 0.0, 0, origin_slot=1, multi_ok=True))
    plain = wire.encode(wire.WireState("p", 1.0, 0.0, 0, origin_slot=2))
    lane = wire.encode(wire.WireState(
        "l", 2.0, 0.0, 0, origin_slot=4, cap_nt=1, lane_added_nt=6, lane_taken_nt=7,
    ))
    pkts = np.zeros((4, 256), np.uint8)
    sizes = np.zeros(4, np.int32)
    for i, b in enumerate([multi, advert, plain, lane]):
        pkts[i, : len(b)] = np.frombuffer(b, np.uint8)
        sizes[i] = len(b)
    buf, _ = native.decode_batch_raw(pkts, sizes)
    assert list(buf.multi[:4]) == [2, 1, 0, 0]
    assert buf.slots[0] == 3 and buf.caps[0] == 5
    assert buf.lane_a[0] == -1  # lanes NOT expanded by the batch path
    assert buf.slots[1] == 1 and buf.slots[2] == 2
    assert buf.lane_a[3] == 6 and buf.lane_t[3] == 7


def test_corrupt_multi_checksum_degrades_to_v1(lib):
    data = bytearray(wire.encode(wire.WireState(
        "m", 9.0, 1.0, 7, origin_slot=3, cap_nt=5, lanes=((0, 10, 20),),
    )))
    data[-1] ^= 0xFF
    pkts = np.zeros((1, 256), np.uint8)
    pkts[0, : len(data)] = np.frombuffer(bytes(data), np.uint8)
    buf, _ = native.decode_batch_raw(pkts, np.array([len(data)], np.int32))
    assert buf.multi[0] == 0 and buf.slots[0] == -1 and buf.caps[0] == -1
    assert buf.name_lens[0] == 1  # the packet itself is still valid (v1)


# -- rx dedup in pt_rx_classify, on the port's engine --------------------------


def _hot_states(w):
    return [
        w.from_nanotokens(
            "hot", 10**9 * (i + 1), 0, 100 + i, origin_slot=3, cap_nt=5 * 10**9,
            lane_added_nt=10**9 * (i + 1), lane_taken_nt=i,
        )
        for i in range(32)
    ] + [
        w.from_nanotokens(
            "hot", 7, 0, 7, origin_slot=5, cap_nt=5 * 10**9, lane_added_nt=7,
            lane_taken_nt=0,
        )
    ]


def test_rx_dedup_folds_duplicates_to_max_like_the_jax_engine(lib):
    from patrol_tpu.models.limiter import LimiterConfig as JConfig
    from patrol_tpu.ops import wire as jw
    from patrol_tpu.runtime.engine import DeviceEngine as JEngine

    views = {}
    for pkg, Eng, Cfg, w, kw in (
        ("port", DeviceEngine, LimiterConfig, wire, {"device": "cpu"}),
        ("jax", JEngine, JConfig, jw, {}),
    ):
        eng = Eng(Cfg(buckets=64, nodes=8), node_slot=0, clock=lambda: 10**12, **kw)
        try:
            # Bind the bucket first: the dedup lives in the native resolve
            # pass, which sees directory HITS only.
            eng.ingest_delta(w.from_nanotokens(
                "hot", 1, 0, 1, origin_slot=3, cap_nt=5 * 10**9, lane_added_nt=1,
                lane_taken_nt=0,
            ), slot=3)
            assert eng.flush(timeout=30)
            states = _hot_states(w)
            pkts, sizes = native.encode_batch(
                [s.added for s in states], [s.taken for s in states],
                [s.elapsed_ns for s in states], [s.name for s in states],
                [s.origin_slot for s in states], [s.cap_nt for s in states],
                [s.lane_added_nt for s in states], [s.lane_taken_nt for s in states],
            )
            dbuf, n = native.decode_batch_raw(pkts, sizes)
            accepted = eng.ingest_wire_batch(
                dbuf, n, dbuf.slots[:n].astype(np.int64), np.zeros(n, np.uint8)
            )
            assert accepted == 2  # the 32 same-lane packets fold into one
            assert eng.flush(timeout=30)
            pn, el = eng.read_rows([eng.directory.lookup("hot")])
            views[pkg] = (np.asarray(pn), np.asarray(el))
            assert int(eng.directory.pins.sum()) == 0
        finally:
            eng.stop()
    pn, el = views["port"]
    assert int(pn[0][3, 0]) == 32 * 10**9 and int(pn[0][3, 1]) == 31
    assert int(pn[0][5, 0]) == 7 and int(el[0]) == 131
    np.testing.assert_array_equal(pn, views["jax"][0])
    np.testing.assert_array_equal(el, views["jax"][1])


def test_many_rows_few_slots_dedup_table_stays_linear(lib):
    n = 4096
    eng = DeviceEngine(LimiterConfig(buckets=2 * n, nodes=4), node_slot=0, device="cpu")
    try:
        names = [f"b{i}" for i in range(n)]
        pkts, sizes = native.encode_batch(
            [2.0] * n, [1.0] * n, [10] * n, names, [i % 4 for i in range(n)],
        )
        dbuf, nd = native.decode_batch_raw(pkts, sizes)
        eng.ingest_wire_batch(dbuf, nd, dbuf.slots[:nd].astype(np.int64), np.zeros(nd, np.uint8))
        assert eng.flush(timeout=60)
        # All hits now: 4096 distinct (row, slot) keys over only 4 slots.
        t0 = time.perf_counter()
        accepted = eng.ingest_wire_batch(
            dbuf, nd, dbuf.slots[:nd].astype(np.int64), np.zeros(nd, np.uint8)
        )
        dt = time.perf_counter() - t0
        assert accepted == n  # distinct rows: nothing folds away
        assert dt < 0.5, f"classify took {dt:.3f}s: dedup probing degenerated"
        assert eng.flush(timeout=60)
        assert int(eng.directory.pins.sum()) == 0
    finally:
        eng.stop()


# -- resolver collisions -------------------------------------------------------


def test_resolve_probes_past_same_hash_different_len(lib):
    cap = 8
    name_bytes = np.zeros((cap, native.PACKET), np.uint8)
    name_len = np.zeros(cap, np.int32)
    for row, nm in enumerate((b"aa", b"bbb", b"ccc")):
        name_bytes[row, : len(nm)] = np.frombuffer(nm, np.uint8)
        name_len[row] = len(nm)
    h = lib.pt_dir_create(cap, name_bytes, name_len)
    assert h >= 0
    try:
        H = 0x12345678ABCDEF01  # forged: all three collide
        for row in (0, 1, 2):
            lib.pt_dir_insert(h, H, row)

        def resolve(name: bytes):
            buf = np.zeros((1, native.PACKET), np.uint8)
            buf[0, : len(name)] = np.frombuffer(name, np.uint8)
            rows = np.full(1, -1, np.int64)
            lib.pt_dir_resolve(
                h, 1, np.array([H], np.uint64), buf, np.array([len(name)], np.int32),
                rows, np.zeros(cap, np.int32), np.zeros(cap, np.int64), 7,
            )
            return int(rows[0])

        assert resolve(b"bbb") == 1  # length mismatches are skipped
        assert resolve(b"aa") == 0
        assert resolve(b"zzz") == -1  # (hash, len) match, wrong bytes: a miss
        assert resolve(b"dddd") == -1
    finally:
        lib.pt_dir_destroy(h)


# -- the rx ring ---------------------------------------------------------------


def test_ring_lease_commit_zero_copy(lib):
    ring = native.RxRing(n_planes=2, max_batch=4, row=512)
    try:
        a, b = ring.lease(), ring.lease()
        assert (a, b) == (0, 1)
        assert ring.lease() is None  # exhausted
        view = ring.plane(a)
        view[0, :4] = [1, 2, 3, 4]
        raw = (ctypes.c_uint8 * 4).from_address(lib.pt_rx_ring_plane(ring.h, a))
        assert list(raw) == [1, 2, 3, 4]  # the native pointer sees the write
        ring.commit(a)
        assert ring.lease() == 0  # recycled, lowest first
        st = ring.stats()
        assert st["rx_ring_lease_reuse"] == 1 and st["rx_ring_exhausted"] == 1
        assert st["rx_ring_leases"] == 3 and st["rx_ring_commits"] == 1
        assert not ring.pinned  # only a CUDA node registers its planes
    finally:
        ring.commit(0)
        ring.commit(1)
        ring.close()


def test_ring_closed_while_leased_is_released_by_the_last_commit(lib):
    ring = native.RxRing(n_planes=2, max_batch=2, row=512)
    a = ring.lease()
    ring.close()
    assert ring.lease() is None  # closing: no new lease
    assert ring.stats()["rx_ring_leases"] == 1  # not released yet
    ring.commit(a)
    assert ring._destroyed  # released; its counters stay readable
    assert ring.stats()["rx_ring_leases"] == ring.stats()["rx_ring_commits"] == 1
    ring.close()  # idempotent


def test_import_builds_nothing():
    # Importing the loader runs no compiler and loads no library.
    code = (
        "import sys, patrol_tpu_torch.native as n\n"
        "print(n._lib is None, 'torch' in sys.modules)\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=PKG_DIR.parent, capture_output=True,
        text=True, timeout=120, env={**os.environ, "PATH": "/nonexistent"},
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["True", "False"]
