"""The port's vectorized hash-table directory with the C++ table on: twins
of ``tests/test_hashdir.py`` on ``patrol_tpu_torch.runtime.directory``.

* FNV-1a parity between the directory's Python hash and the port's C++
  decoder;
* batch lookup and verify semantics, unbind, eviction churn, malformed
  rows and post-close degradation — each against both resolve tables
  (the C++ ``pt_dir``, which a port directory now takes whenever the
  native library loads, and the numpy fallback);
* ``assign_many_wire`` atomicity on a full pool;
* raw ingest: the port engine's ``ingest_deltas_batch_raw`` lands the
  same state as its string path and as the JAX engine's
  ``ingest_deltas_batch_raw`` on the same inputs, including v1 scalar
  deltas and malformed rows, and ``ingest_wire_batch`` (the fused native
  classify) agrees with both.

The reference's checkpoint-restore case has its twin in
``tests/test_torch_checkpoint.py``.
"""

import numpy as np
import pytest

from patrol_tpu.models.limiter import LimiterConfig as JConfig
from patrol_tpu.ops.rate import Rate as JRate
from patrol_tpu.runtime.engine import DeviceEngine as JEngine
from patrol_tpu_torch import native
from patrol_tpu_torch.models.limiter import NANO, LimiterConfig
from patrol_tpu_torch.ops import wire
from patrol_tpu_torch.ops.rate import Rate
from patrol_tpu_torch.runtime.directory import NAME_BYTES_MAX, BucketDirectory, _fnv1a64
from patrol_tpu_torch.runtime.engine import DeviceEngine

CFG = LimiterConfig(buckets=64, nodes=4)
RATE = Rate(freq=10, per_ns=NANO)


def _buf(names):
    """Zero-padded byte rows + lens + hashes for a list of names: the
    shape native.decode_batch_raw produces."""
    n = len(names)
    buf = np.zeros((n, NAME_BYTES_MAX), np.uint8)
    lens = np.zeros(n, np.int32)
    hashes = np.zeros(n, np.uint64)
    for i, nm in enumerate(names):
        raw = nm.encode("utf-8", "surrogateescape")
        lens[i] = len(raw)
        buf[i, : len(raw)] = np.frombuffer(raw, np.uint8)
        hashes[i] = _fnv1a64(raw)
    return buf, lens, hashes


def test_fnv_python_matches_cpp():
    names = ["a", "bucket-42", "", "x" * 231, "üñíçødé-名前"]
    pkts, sizes = native.encode_batch(
        [1.0] * len(names), [0.0] * len(names), [1] * len(names), names,
        [-1] * len(names),
    )
    assert (sizes >= 0).all()
    buf, _ = native.decode_batch_raw(pkts, sizes)
    for i, nm in enumerate(names):
        assert int(buf.hashes[i]) == _fnv1a64(nm.encode("utf-8", "surrogateescape")), nm


def test_fnv_known_vector():
    assert _fnv1a64(b"") == 0xCBF29CE484222325
    assert _fnv1a64(b"a") == 0xAF63DC4C8601EC8C


@pytest.fixture(params=["native", "numpy"])
def make_dir(request, monkeypatch):
    """Directory factory: each test runs against the C++ table and the
    numpy fallback."""
    if request.param == "numpy":
        monkeypatch.setattr(native, "load", lambda required=False: None)
    else:
        native.load(required=True)

    def make(capacity):
        d = BucketDirectory(capacity)
        assert (d._ptlib is not None) == (request.param == "native")
        return d

    return make


def test_hit_pins_and_misses_stay_unpinned(make_dir):
    d = make_dir(8)
    row, _ = d.assign("alpha", 100)
    buf, lens, hashes = _buf(["alpha", "ghost"])
    rows = d.lookup_hashed_pinned(hashes, buf, lens, 200)
    assert rows[0] == row and rows[1] == -1
    assert d.pins[row] == 1 and d.last_used_ns[row] == 200
    d.unpin_rows([row])


def test_hash_match_wrong_bytes_is_miss(make_dir):
    d = make_dir(8)
    row, _ = d.assign("alpha", 100)
    buf, lens, _ = _buf(["bravo"])
    rows = d.lookup_hashed_pinned(np.array([_fnv1a64(b"alpha")], np.uint64), buf, lens, 200)
    assert rows[0] == -1 and d.pins[row] == 0


def test_unbind_removes_from_table(make_dir):
    d = make_dir(8)
    d.assign("gone", 100)
    d.release("gone")
    buf, lens, hashes = _buf(["gone"])
    assert d.lookup_hashed_pinned(hashes, buf, lens, 200)[0] == -1
    row2, _ = d.assign("gone", 300)  # rebinding resolves again
    assert d.lookup_hashed_pinned(hashes, buf, lens, 400)[0] == row2
    d.unpin_rows([row2])


def test_eviction_cycle_keeps_table_consistent(make_dir):
    """Churn far past capacity: every live name resolves, every evicted
    name misses, across tombstone-triggered rebuilds."""
    d = make_dir(16)
    live = {}
    for gen in range(20):
        for i in range(8):
            nm = f"g{gen}-n{i}"
            try:
                row, _ = d.assign(nm, gen * 100 + i)
            except Exception:
                victims = d.pick_victims(8)
                live = {k: r for k, r in live.items() if r not in set(victims.tolist())}
                d.recycle(victims)
                row, _ = d.assign(nm, gen * 100 + i)
            live = {k: r for k, r in live.items() if r != row}
            live[nm] = row
    names = list(live) + [f"g0-n{i}" for i in range(8)]
    buf, lens, hashes = _buf(names)
    rows = d.lookup_hashed_pinned(hashes, buf, lens, 10**6)
    for i, nm in enumerate(names):
        assert rows[i] == live.get(nm, -1), nm
    d.unpin_rows(rows[rows >= 0])


def test_batch_with_malformed_rows_skipped(make_dir):
    d = make_dir(8)
    row, _ = d.assign("ok", 1)
    buf, lens, hashes = _buf(["ok", "bad"])
    lens[1] = -1  # malformed packet marker
    rows = d.lookup_hashed_pinned(hashes, buf, lens, 2)
    assert rows[0] == row and rows[1] == -1
    d.unpin_rows([row])


def test_post_close_degrades_not_raises(make_dir):
    d = make_dir(8)
    row, _ = d.assign("pre", 1)
    d.close()
    buf, lens, hashes = _buf(["pre", "post"])
    assert (d.lookup_hashed_pinned(hashes, buf, lens, 2) == -1).all()
    r2, created = d.assign("post", 3)  # binds still work (no table)
    assert created and d.lookup("post") == r2
    assert d.lookup("pre") == row  # the string path is unaffected
    d.release("pre")
    d.close()  # idempotent


def test_rx_classify_answers_with_the_native_table_only(make_dir):
    d = make_dir(8)
    row, _ = d.assign("alpha", 1)
    d.init_cap_base(row, 5 * NANO)
    buf, lens, hashes = _buf(["alpha", "ghost"])
    n = 2
    res = d.rx_classify(
        n, hashes, np.pad(buf, ((0, 0), (0, 256 - NAME_BYTES_MAX))), lens,
        np.array([7.0, 1.0]), np.array([1.0, 0.0]), np.array([9, 9], np.uint64),
        np.array([1, 1], np.int64), 4, np.full(n, 5 * NANO, np.int64),
        np.array([2 * NANO, 1], np.int64), np.array([NANO, 0], np.int64),
        np.zeros(n, np.uint8), 2,
    )
    if d._ptlib is None:
        assert res is None
        return
    rows, out_a, out_t, out_e, out_s = res
    assert rows.tolist() == [row, -1]  # a hit (pinned), a miss
    assert (out_a[0], out_t[0], out_e[0], out_s[0]) == (2 * NANO, NANO, 9, 0)
    assert d.pins[row] == 1
    d.unpin_rows([row])


def test_full_pool_assigns_and_pins_nothing(make_dir):
    d = make_dir(2)
    d.assign("a", 0)
    d.assign("b", 0)
    names = ["c", "d"]
    buf, lens, hashes = _buf(names)
    with pytest.raises(Exception) as exc:
        d.assign_many_wire(names, buf, lens, hashes, 1, pin=True)
    assert "pool spent" in str(exc.value)
    assert d.lookup("c") is None and d.lookup("d") is None
    assert d.pins.sum() == 0 and len(d) == 2


def test_duplicate_names_bind_once_and_pin_per_entry(make_dir):
    d = make_dir(4)
    names = ["dup", "dup", "solo"]
    buf, lens, hashes = _buf(names)
    rows = d.assign_many_wire(names, buf, lens, hashes, 5, pin=True)
    assert rows[0] == rows[1] != rows[2] and len(d) == 2
    assert d.pins[rows[0]] == 2 and d.pins[rows[2]] == 1
    r2 = d.lookup_hashed_pinned(hashes, buf, lens, 6)  # resolvable at once
    assert (r2 == rows).all()
    d.unpin_rows(rows)
    d.unpin_rows(r2)


def test_wire_retry_path_drops_batch_when_all_pinned():
    eng = DeviceEngine(LimiterConfig(buckets=2, nodes=4), node_slot=0, clock=lambda: 0,
                       device="cpu")
    try:
        assert eng.directory._ptlib is not None  # the C++ table is on
        eng.directory.assign("a", 0, pin=True)
        eng.directory.assign("b", 0, pin=True)
        buf, lens, hashes = _buf(["c"])
        before = eng.directory.pins.sum()
        assert eng._assign_many_pinned_wire(["c"], buf, lens, hashes, 1) is None
        assert eng.directory.pins.sum() == before  # no pin leak
    finally:
        eng.directory.unpin_rows([0, 1])
        eng.stop()


# -- raw ingest, port against the JAX engine -----------------------------------


@pytest.fixture
def engines():
    """A port engine and a JAX engine on the same config and clock."""
    pair = (
        DeviceEngine(CFG, node_slot=0, clock=lambda: 0, device="cpu"),
        JEngine(JConfig(buckets=64, nodes=4), node_slot=0, clock=lambda: 0),
    )
    yield pair
    for e in pair:
        e.stop()


def _views(eng, names):
    eng.flush()
    return {n: sorted((s.origin_slot, s.lane_added_nt, s.lane_taken_nt, s.elapsed_ns)
                      for s in eng.snapshot(n)) for n in names}


def test_raw_matches_string_path_and_the_jax_engine(engines):
    names = ["rawa", "rawb", "rawa"]
    slots = np.array([1, 2, 3], np.int64)
    taken = np.array([NANO, 0, 0], np.int64)
    elapsed = np.array([5, 7, 9], np.int64)
    none = np.full(3, -1, np.int64)
    buf, lens, hashes = _buf(names)
    views = []
    for eng in engines:
        for added in ([2 * NANO, 3 * NANO, NANO], [4 * NANO, 3 * NANO, NANO]):
            # The second round resolves through the hash table (hits).
            eng.ingest_deltas_batch_raw(
                3, buf, lens, hashes, slots, np.array(added, np.int64), taken,
                elapsed, none, none, none, np.zeros(3, bool),
            )
            eng.flush()
        views.append(_views(eng, ["rawa", "rawb"]))
        assert eng.directory.pins.sum() == 0  # every pin released
    assert views[0] == views[1]
    assert views[0]["rawa"] == [(1, 4 * NANO, NANO, 9), (3, NANO, 0, 9)]
    # The string path lands the same state on a fresh port engine.
    eng = DeviceEngine(CFG, node_slot=0, clock=lambda: 0, device="cpu")
    try:
        for added in ([2 * NANO, 3 * NANO, NANO], [4 * NANO, 3 * NANO, NANO]):
            eng.ingest_deltas_batch(names, slots, added, taken, elapsed)
        assert _views(eng, ["rawa", "rawb"]) == views[0]
    finally:
        eng.stop()


def test_raw_v1_scalar_classification(engines):
    views = []
    for eng, rate in zip(engines, (RATE, JRate(freq=10, per_ns=NANO))):
        eng.take("rawv1", rate, 1)  # cap known, own taken = 1
        buf, lens, hashes = _buf(["rawv1"])
        none = np.full(1, -1, np.int64)
        eng.ingest_deltas_batch_raw(
            1, buf, lens, hashes, np.array([1], np.int64),
            np.array([13 * NANO], np.int64), np.array([4 * NANO], np.int64),
            np.array([0], np.int64), none, none, none, np.ones(1, bool),
        )
        views.append(_views(eng, ["rawv1"]))
    assert views[0] == views[1]
    by_slot = {s[0]: s for s in views[0]["rawv1"]}
    assert by_slot[1][1:3] == (3 * NANO, 3 * NANO)


def test_raw_drops_invalid_rows(engines):
    for eng in engines:
        buf, lens, hashes = _buf(["dropme", "keepme"])
        lens[0] = -1  # malformed
        none = np.full(2, -1, np.int64)
        accepted = eng.ingest_deltas_batch_raw(
            2, buf, lens, hashes, np.array([1, 1], np.int64),
            np.array([NANO, NANO], np.int64), np.zeros(2, np.int64),
            np.zeros(2, np.int64), none, none, none, np.zeros(2, bool),
        )
        eng.flush()
        assert accepted == 1
        assert eng.snapshot("keepme") and not eng.snapshot("dropme")


def test_wire_batch_matches_the_jax_engine(engines):
    """``ingest_wire_batch`` (the fused native classify, with misses bound
    through the numpy tail) on a mixed batch: lane trailers, cap-only
    trailers, v1 states with known and unknown capacity, an out-of-range
    slot and a malformed packet."""
    states = [
        wire.from_nanotokens("wa", 9 * NANO, NANO, 5, origin_slot=1, cap_nt=5 * NANO,
                             lane_added_nt=4 * NANO, lane_taken_nt=NANO),
        wire.from_nanotokens("wb", 8 * NANO, 2 * NANO, 6, origin_slot=2, cap_nt=5 * NANO),
        wire.WireState("wa", 12.0, 3.0, 7),  # v1: cap known once wa binds
        wire.WireState("wc", 12.0, 3.0, 7),  # v1: cap unknown, dropped
        wire.from_nanotokens("wd", NANO, 0, 1, origin_slot=9, cap_nt=NANO,
                             lane_added_nt=1, lane_taken_nt=0),
    ]
    pkts = np.zeros((len(states) + 1, 256), np.uint8)
    sizes = np.zeros(len(states) + 1, np.int32)
    for i, s in enumerate(states):
        b = wire.encode(s)
        pkts[i, : len(b)] = np.frombuffer(b, np.uint8)
        sizes[i] = len(b)
    sizes[-1] = 7  # malformed
    views = []
    for eng in engines:
        for _ in range(2):  # first sight (misses), then hits
            dbuf, n = native.decode_batch_raw(pkts, sizes)
            slots = np.where(dbuf.slots[:n] >= 0, dbuf.slots[:n], 3).astype(np.int64)
            no_trailer = (dbuf.slots[:n] < 0).astype(np.uint8)
            eng.ingest_wire_batch(dbuf, n, slots, no_trailer)
            eng.flush()
        views.append(_views(eng, ["wa", "wb", "wc", "wd"]))
        assert eng.directory.pins.sum() == 0
        assert eng.directory._ptlib is not None
    assert views[0] == views[1]
    assert views[0]["wa"] and views[0]["wb"] and not views[0]["wd"]
