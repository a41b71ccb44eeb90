"""Raw wire-v2 ingest of the port against the JAX package's.

The same seeded datagram corpus (valid packets mixed with the hostile
kinds of ``tests/test_ingest.py``: flips, truncations, trailing garbage,
random blobs, bit-63 values with a fixed-up checksum, all over stale
``0xAB`` ring bytes) goes through both packages:

* the host half (``host_walk``, ``dv2_mask``, ``gather_name_rows``) must
  equal the JAX package's field for field;
* ``decode_fold_raw_plain`` (the plain version of the ``decode_fold``
  kernel) must equal ``decode_fold_raw_jit`` and the Pallas twin in
  interpret mode bit for bit — state, ``ok``, ``entry_ok`` and
  ``hosted_mask`` everywhere, the decoded fields under ``entry_ok`` (the
  reference leaves them unspecified elsewhere) — with random ``hosted``,
  sentinel rows, rows under dead entries and lying framing proposals.
  Tolerance 0: every value is an exact integer. The same holds on a
  corpus at the kernel's alignment edges (datagram lengths at every
  residue mod 16, entry tails at every residue mod 4, count 0 and the
  row's maximum count), and the kernel's bulk-copy contract is checked;
* the engine seam: the port's ``ingest_raw_planes``, its
  ``ingest_interval`` and its queued bulk path (``ingest_deltas_batch``)
  give the same planes as the JAX engine's ``ingest_raw_planes`` (host
  fast path off);
* ``DeltaPlane``'s counters on the raw path equal those on the python
  decode path.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from patrol_tpu.models.limiter import LimiterConfig as JConfig
from patrol_tpu.models.limiter import init_state as jinit
from patrol_tpu.ops import ingest as jingest
from patrol_tpu.ops import wire as jwire
from patrol_tpu.runtime import engine as jengine_mod
from patrol_tpu_torch.models.limiter import NANO
from patrol_tpu_torch.models.limiter import LimiterConfig as TConfig
from patrol_tpu_torch.models.limiter import init_state as tinit
from patrol_tpu_torch.ops import ingest as tingest
from patrol_tpu_torch.ops import ingest_kernel
from patrol_tpu_torch.ops import wire as twire
from patrol_tpu_torch.runtime import engine as tengine_mod
from patrol_tpu_torch.utils import profiling

ROW = 2048
E = tingest.max_entries(ROW)
BUCKETS, NODES = 256, 4
PAD = 1 << 30


def mk_packet(rng, n_entries, name_pool=200, slot_max=NODES, big=False, wire=twire):
    hi = (1 << 62) if big else (1 << 50)
    ents = [
        wire.DeltaEntry(
            f"bkt{int(rng.integers(0, name_pool))}",
            int(rng.integers(0, slot_max)),
            *(int(x) for x in rng.integers(0, hi, 4)),
        )
        for _ in range(n_entries)
    ]
    acks = [int(x) for x in rng.integers(0, 1 << 32, int(rng.integers(0, 6)))]
    data, n = wire.encode_delta_packet(
        3, int(rng.integers(1, 1 << 32)), acks, ents, max_size=ROW
    )
    assert n == n_entries
    return data


def hostile_corpus(seed, n):
    """Packet i is of kind i % 8: 0 valid, 1 byte flip, 2 truncation, 3
    trailing garbage, 4 random blob, 5 values up to 2^62 on slots up to
    NODES + 2, 6 a bit-63 value with its checksum fixed up, 7 valid (the
    framing proposal lies about it, see ``lying_proposal``)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kind = i % 8
        b = bytearray(
            mk_packet(rng, int(rng.integers(0, 40)), big=kind == 5,
                      slot_max=NODES + 2 if kind == 5 else NODES)
        )
        if kind == 1:
            b[int(rng.integers(0, len(b)))] ^= 0x41
        elif kind == 2:
            b = b[: int(rng.integers(1, len(b)))]
        elif kind == 3:
            b += bytes(rng.integers(0, 256, int(rng.integers(1, 6))).astype(np.uint8))
        elif kind == 4:
            b = bytearray(rng.integers(0, 256, int(rng.integers(1, 300))).astype(np.uint8))
        elif kind == 6:
            off = 32 + 8 + 4 * b[39] + 2
            off += 1 + b[off] + 2  # name_len + name + slot
            if off + 8 < len(b):
                b[off] |= 0x80
                b[-1] = sum(b[32:-1]) & 0xFF
        out.append(bytes(b))
    return out


def planes_of(raw, stale=0xAB):
    planes = np.full((len(raw), ROW), stale, np.uint8)  # stale ring bytes
    lengths = np.zeros(len(raw), np.int32)
    for i, b in enumerate(raw):
        planes[i, : len(b[:ROW])] = np.frombuffer(b[:ROW], np.uint8)
        lengths[i] = min(len(b), ROW)
    return planes, lengths


def lying_proposal(planes, lengths, seed):
    """The walk's framing proposal, with one offset of every kind-7 packet
    that has two or more entries moved (+1, back one entry, or swapped)."""
    walk = tingest.host_walk(planes, lengths)
    eoff = np.maximum(walk.name_off - 1, 0).astype(np.int32)
    rng = np.random.default_rng(seed)
    liars = [p for p in range(7, len(lengths), 8) if walk.count[p] >= 2]
    for j, p in enumerate(liars):
        k = int(rng.integers(1, walk.count[p]))
        if j % 3 == 0:
            eoff[p, k] += 1
        elif j % 3 == 1:
            eoff[p, k] -= 35
        else:
            eoff[p, k - 1], eoff[p, k] = eoff[p, k], eoff[p, k - 1]
    return eoff, liars


def test_host_half_matches_reference():
    raw = hostile_corpus(20260805, 80) + [b"", b"\x00" * 31, b"\x00" * 40]
    planes, lengths = planes_of(raw)
    tw = tingest.host_walk(planes, lengths)
    jw = jingest.host_walk(planes, lengths)
    assert tw._fields == jw._fields
    for field in tw._fields:
        np.testing.assert_array_equal(getattr(tw, field), getattr(jw, field), err_msg=field)
    np.testing.assert_array_equal(
        tingest.dv2_mask(planes, lengths), jingest.dv2_mask(planes, lengths)
    )
    pi, ei = np.nonzero(tw.ok[:, None] & (np.arange(E)[None, :] < tw.count[:, None]))
    assert pi.size > 100
    np.testing.assert_array_equal(
        tingest.gather_name_rows(planes, pi, tw.name_off[pi, ei], tw.name_len[pi, ei]),
        jingest.gather_name_rows(planes, pi, jw.name_off[pi, ei], jw.name_len[pi, ei]),
    )
    # The verdicts are the python decoder's.
    for i, b in enumerate(raw):
        assert tw.ok[i] == (twire.decode_delta_packet(b[:ROW]) is not None), i
    assert tingest.MAX_RAW_ENTRIES == jingest.MAX_RAW_ENTRIES


def _corpus_inputs(seed, n):
    raw = hostile_corpus(seed, n)
    planes, lengths = planes_of(raw)
    eoff, liars = lying_proposal(planes, lengths, seed)
    rng = np.random.default_rng(seed + 1)
    rows = rng.integers(0, BUCKETS, (len(raw), E)).astype(np.int32)
    rows[rng.random(rows.shape) < 0.1] = PAD
    hosted = rng.random(rows.shape) < 0.3
    return raw, planes, lengths, eoff, rows, hosted, liars


@pytest.mark.parametrize("impl", ["jit", "pallas"])
def test_decode_fold_plain_matches_reference(impl):
    raw, planes, lengths, eoff, rows, hosted, liars = _corpus_inputs(99, 48)
    jargs = (jnp.asarray(planes), jnp.asarray(lengths), jnp.asarray(eoff),
             jnp.asarray(rows), jnp.asarray(hosted))
    jst = jinit(JConfig(buckets=BUCKETS, nodes=NODES))
    if impl == "jit":
        want = jingest.decode_fold_raw_jit(jst, *jargs)
    else:
        want = jingest.decode_fold_raw_pallas(jst, *jargs, interpret=True)
    tst = tinit(TConfig(buckets=BUCKETS, nodes=NODES), device="cpu")
    got = tingest.decode_fold_raw_plain(
        tst, *(torch.from_numpy(x) for x in (planes, lengths, eoff, rows, hosted))
    )
    assert got[0] is tst  # in place
    np.testing.assert_array_equal(tst.pn.numpy(), np.asarray(want[0].pn))
    np.testing.assert_array_equal(tst.elapsed.numpy(), np.asarray(want[0].elapsed))
    for i in (1, 2, 3):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]), err_msg=str(i))
    eok = np.asarray(want[2])
    for i in range(4, 9):
        np.testing.assert_array_equal(got[i].numpy()[eok], np.asarray(want[i])[eok])
    # Non-vacuous: packets pass and fold, hosted entries stay out, and a
    # lying proposal rejects a packet the decoder accepts.
    ok = got[1].numpy()
    assert ok.sum() >= 8 and eok.sum() > 50 and np.asarray(want[3]).sum() > 5
    assert liars and all(
        not ok[p] and jwire.decode_delta_packet(raw[p]) is not None for p in liars
    )
    assert (tst.pn.numpy() > 0).sum() > 50


def test_decode_fold_wraps_negative_plan_rows_like_the_reference():
    # The reference's scatter wraps a plan row in [-B, 0) (ROADMAP C1);
    # the kernel drops every row outside [0, B), so the wrapper wraps.
    raw, planes, lengths, eoff, rows, hosted, _ = _corpus_inputs(77, 32)
    rng = np.random.default_rng(78)
    pick = rng.random(rows.shape)
    rows = np.where(pick < 0.3, rows - BUCKETS, rows)  # wraps back to itself
    rows = np.where(pick > 0.95, -BUCKETS - 1 - rows, rows).astype(np.int32)  # dropped
    jargs = (jnp.asarray(planes), jnp.asarray(lengths), jnp.asarray(eoff),
             jnp.asarray(rows), jnp.asarray(hosted))
    want = jingest.decode_fold_raw_jit(jinit(JConfig(buckets=BUCKETS, nodes=NODES)), *jargs)
    tst = tinit(TConfig(buckets=BUCKETS, nodes=NODES), device="cpu")
    got = tingest.decode_fold_raw(
        tst, *(torch.from_numpy(x) for x in (planes, lengths, eoff, rows, hosted))
    )
    np.testing.assert_array_equal(tst.pn.numpy(), np.asarray(want[0].pn))
    np.testing.assert_array_equal(tst.elapsed.numpy(), np.asarray(want[0].elapsed))
    for i in (1, 2, 3):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]), err_msg=str(i))
    # Non-vacuous: folded entries sat under wrapped rows.
    eok = np.asarray(want[2]) & ~hosted
    assert (eok & (rows < 0) & (rows >= -BUCKETS)).sum() > 10
    assert (eok & (rows < -BUCKETS)).sum() > 0


def _entry(rng, name_len, wire=twire):
    return wire.DeltaEntry(
        "".join(chr(97 + int(c)) for c in rng.integers(0, 26, name_len)),
        int(rng.integers(0, NODES)),
        *(int(x) for x in rng.integers(0, 1 << 50, 4)),
    )


def residue_corpus(part, seed=31):
    """Valid datagrams at the kernel's alignment edges (it stages a plane
    in 16-byte vectors and decodes entry tails from 4-byte words):

    * ``lengths``: one entry with a name of every length 0..17 under 0..3
      acks, so datagram lengths end at every residue mod 16;
    * ``names``: 2..6 entries a packet with names of mixed lengths 0..17,
      so later entries' tails start at every residue mod 4;
    * ``counts``: ``count = 0`` packets under 0..3 acks, and packets at
      the row's maximum entry count ``E`` (empty names) under 0..2 acks.

    Every third packet is followed by a copy with one payload byte
    flipped, which the checksum must reject."""
    rng = np.random.default_rng(seed)
    out = []
    if part == "lengths":
        specs = [([L], a) for L in range(18) for a in range(4)]
    elif part == "names":
        specs = [(list(rng.integers(0, 18, int(rng.integers(2, 7)))), int(rng.integers(0, 4)))
                 for _ in range(24)]
    else:
        specs = [([], a) for a in range(4)] + [([0] * E, a) for a in range(3)]
    for i, (name_lens, n_acks) in enumerate(specs):
        ents = [_entry(rng, int(L)) for L in name_lens]
        acks = [int(x) for x in rng.integers(0, 1 << 32, n_acks)]
        data, n = twire.encode_delta_packet(2, i + 1, acks, ents, max_size=ROW)
        assert n == len(ents)
        out.append(data)
        if i % 3 == 0:
            b = bytearray(data)
            b[int(rng.integers(32, len(b) - 1))] ^= 0x10
            out.append(bytes(b))
    return out


@pytest.mark.parametrize("impl", ["jit", "pallas"])
@pytest.mark.parametrize("part", ["lengths", "names", "counts"])
def test_decode_fold_alignment_edges_match_reference(part, impl):
    raw = residue_corpus(part)
    rng = np.random.default_rng(7)
    # Random stale bytes past every datagram: a ragged vector edge that
    # let one into the checksum would reject a valid packet.
    planes = rng.integers(0, 256, (len(raw), ROW)).astype(np.uint8)
    lengths = np.array([len(b) for b in raw], np.int32)
    for i, b in enumerate(raw):
        planes[i, : len(b)] = np.frombuffer(b, np.uint8)
    walk = tingest.host_walk(planes, lengths)
    eoff = np.maximum(walk.name_off - 1, 0).astype(np.int32)
    rows = rng.integers(0, BUCKETS, eoff.shape).astype(np.int32)
    rows[rng.random(rows.shape) < 0.1] = PAD
    hosted = rng.random(rows.shape) < 0.2
    jst = jinit(JConfig(buckets=BUCKETS, nodes=NODES))
    jargs = [jnp.asarray(x) for x in (planes, lengths, eoff, rows, hosted)]
    if impl == "jit":
        want = jingest.decode_fold_raw_jit(jst, *jargs)
    else:
        want = jingest.decode_fold_raw_pallas(jst, *jargs, interpret=True)
    tst = tinit(TConfig(buckets=BUCKETS, nodes=NODES), device="cpu")
    got = tingest.decode_fold_raw_plain(
        tst, *(torch.from_numpy(x) for x in (planes, lengths, eoff, rows, hosted))
    )
    np.testing.assert_array_equal(tst.pn.numpy(), np.asarray(want[0].pn))
    np.testing.assert_array_equal(tst.elapsed.numpy(), np.asarray(want[0].elapsed))
    for i in (1, 2, 3):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]), err_msg=str(i))
    eok = np.asarray(want[2])
    for i in range(4, 9):
        np.testing.assert_array_equal(got[i].numpy()[eok], np.asarray(want[i])[eok])
    # The verdicts are the decoder's, and the corpus reaches its edges.
    ok = got[1].numpy()
    for i, b in enumerate(raw):
        assert ok[i] == (twire.decode_delta_packet(b) is not None), i
    assert 0 < (~ok).sum() < ok.sum()
    if part == "lengths":
        assert set((lengths[ok] % 16).tolist()) == set(range(16))
    elif part == "names":
        live = np.arange(E)[None, :] < walk.count[:, None]
        assert set(walk.name_len[live].tolist()) == set(range(18))
        tails = (walk.name_off + walk.name_len)[np.asarray(want[2])]
        assert set((tails % 4).tolist()) == {0, 1, 2, 3}
    else:
        assert set(walk.count[ok].tolist()) == {0, E}


@pytest.mark.parametrize(
    "offset,row,ok",
    [(0, ROW, True), (16, 64, True), (1, ROW, False), (0, 2047, False)],
)
def test_bulk_copy_contract(offset, row, ok):
    # The kernel's bulk copy needs a 16-byte-aligned plane base and a row
    # width that is a multiple of 16; a CUDA call raises on anything else.
    buf = torch.zeros(offset + 2 * row + 64, dtype=torch.uint8)
    base = buf.data_ptr() % 16
    planes = buf[(16 - base) % 16 + offset :][: 2 * row].view(2, row)
    if ok:
        ingest_kernel.check_bulk_copy(planes)
    else:
        with pytest.raises(ValueError):
            ingest_kernel.check_bulk_copy(planes)


def test_decode_fold_wrapper_contract():
    raw, planes, lengths, eoff, rows, hosted, _ = _corpus_inputs(5, 16)
    args = [torch.from_numpy(x) for x in (planes, lengths, eoff, rows, hosted)]
    a = tinit(TConfig(buckets=BUCKETS, nodes=NODES), device="cpu")
    b = tinit(TConfig(buckets=BUCKETS, nodes=NODES), device="cpu")
    out = ingest_kernel.decode_fold(a.pn, a.elapsed, *args)
    ref = ingest_kernel.decode_fold_plain(b.pn, b.elapsed, *args)
    for x, y in zip(out, ref):
        assert torch.equal(x, y)
    assert torch.equal(a.pn, b.pn) and torch.equal(a.elapsed, b.elapsed)
    bad = [
        (1, args[1].to(torch.int64)),  # lengths must be int32
        (0, args[0].to(torch.int32)),  # planes must be uint8
        (4, args[4].to(torch.uint8)),  # hosted must be bool
        (2, args[2][:, :-1].contiguous()),  # entry_off shape
        (3, args[3].t().contiguous().t()),  # rows not contiguous
    ]
    for i, t in bad:
        broken = list(args)
        broken[i] = t
        with pytest.raises((TypeError, ValueError)):
            ingest_kernel.decode_fold(a.pn, a.elapsed, *broken)


# -- the engine seam ---------------------------------------------------------


def _feed_raw(eng, raw):
    planes, lengths = planes_of(raw)
    released = []
    n = eng.ingest_raw_planes(planes, lengths, release=lambda: released.append(1))
    assert eng.flush(timeout=30)
    assert released == [1], "release must run exactly once"
    return n


def _feed_interval(eng, raw, decode):
    for b in raw:
        pk = decode(b)
        if pk is None or not pk.entries:
            continue
        ents = [e for e in pk.entries if e.slot < NODES]
        eng.ingest_interval(
            [e.name for e in ents], [e.slot for e in ents], [e.cap_nt for e in ents],
            [e.added_nt for e in ents], [e.taken_nt for e in ents],
            [e.elapsed_ns for e in ents],
        )
    assert eng.flush(timeout=30)


def _view(eng, names):
    out = {}
    for nm in names:
        row = eng.directory.lookup(nm)
        assert row is not None, nm
        pn, el = eng.row_view(row)
        out[nm] = (pn.tolist(), int(el), int(eng.directory.cap_base_nt[row]))
    return out


def test_engine_raw_seam_matches_interval_path_and_reference(monkeypatch):
    monkeypatch.setattr(jengine_mod, "HOST_FASTPATH", False)
    monkeypatch.setattr(tengine_mod, "HOST_FASTPATH", False)
    rng = np.random.default_rng(12)
    raw = [mk_packet(rng, 30, name_pool=40) for _ in range(12)]
    raw += hostile_corpus(3, 16)  # invalid riders change nothing
    names = {
        e.name
        for b in raw
        if (pk := twire.decode_delta_packet(b)) is not None
        for e in pk.entries
        if e.slot < NODES
    }
    assert len(names) > 30

    def t_engine():
        return tengine_mod.DeviceEngine(
            TConfig(BUCKETS, NODES), node_slot=0, clock=lambda: NANO, device="cpu"
        )

    views = {}
    jeng = jengine_mod.DeviceEngine(JConfig(BUCKETS, NODES), node_slot=0, clock=lambda: NANO)
    try:
        _feed_raw(jeng, raw)
        views["jax raw"] = _view(jeng, names)
    finally:
        jeng.stop()
    for label in ("raw", "interval", "queued"):
        eng = t_engine()
        # "queued": an engine that does not fold on the rx thread hands the
        # intervals to ingest_deltas_batch and the feeder's tick instead.
        eng._interval_fold_capable = label != "queued"
        try:
            before = profiling.COUNTERS.get("ingest_raw_device_dispatches")
            if label == "raw":
                accepted = _feed_raw(eng, raw)
                assert profiling.COUNTERS.get("ingest_raw_device_dispatches") == before + 1
                assert accepted == sum(
                    len([e for e in pk.entries if e.slot < NODES])
                    for b in raw
                    if (pk := twire.decode_delta_packet(b)) is not None
                )
            else:
                _feed_interval(eng, raw, twire.decode_delta_packet)
            views[label] = _view(eng, names)
        finally:
            eng.stop()
    assert views["raw"] == views["jax raw"]
    assert views["interval"] == views["jax raw"]
    assert views["queued"] == views["jax raw"]
    assert any(pn != [[0, 0]] * NODES for pn, _, _ in views["raw"].values())


def test_raw_ingest_reuses_one_hosted_operand_per_shape():
    # Host lanes are not ported, so ``hosted`` is all false: one tensor
    # per entry width E, as deep as the widest batch yet, is made once and
    # its [:P] prefix serves every later launch of that width.
    eng = tengine_mod.DeviceEngine(TConfig(BUCKETS, NODES), device="cpu")
    try:
        rng = np.random.default_rng(4)
        for _ in range(3):
            _feed_raw(eng, [mk_packet(rng, 5)])
        first = eng._no_hosted[E]
        _feed_raw(eng, [mk_packet(rng, 5), mk_packet(rng, 5)])
        deep = eng._no_hosted[E]
        _feed_raw(eng, [mk_packet(rng, 5)])
        assert sorted(eng._no_hosted) == [E]
        assert tuple(first.shape) == (1, E) and tuple(deep.shape) == (2, E)
        assert eng._no_hosted[E] is deep
        assert not any(t.any() for t in eng._no_hosted.values())
    finally:
        eng.stop()


def test_raw_planes_with_no_valid_packets_release_inline():
    eng = tengine_mod.DeviceEngine(TConfig(BUCKETS, NODES), device="cpu")
    try:
        planes, lengths = planes_of([b"garbage!", b"\x00" * 60])
        released = []
        before = profiling.COUNTERS.get("ingest_raw_device_dispatches")
        assert eng.ingest_raw_planes(
            planes, lengths, release=lambda: released.append(1)
        ) == 0
        assert released == [1]
        assert profiling.COUNTERS.get("ingest_raw_device_dispatches") == before
    finally:
        eng.stop()


# -- DeltaPlane: raw path vs python decode path -----------------------------


class _Slots:
    self_slot = 0
    max_slots = NODES


class _StubAE:
    inflight = frozenset()

    def inflight_buckets(self, addr):
        return self.inflight

    def trigger(self, addr, force=False):
        pass


class FakeRep:
    log = None

    def __init__(self, repo):
        from patrol_tpu_torch.net.replication import ReplyGate

        self.wire_mode = "delta"
        self.peers = [("127.0.0.1", 1234)]
        self.slots = _Slots()
        self.repo = repo
        self.antientropy = _StubAE()
        self.reply_gate = ReplyGate()
        self.sent = []

    def unicast(self, data, addr):
        self.sent.append((data, addr))


def test_delta_plane_counters_match_python_path(monkeypatch):
    from patrol_tpu_torch.net import delta as delta_mod
    from patrol_tpu_torch.runtime.repo import TPURepo

    peer = ("127.0.0.1", 1234)
    good = mk_packet(np.random.default_rng(5), 20, name_pool=10)
    bad = bytearray(good)
    bad[40] ^= 0xFF
    oob = twire.encode_delta_packet(
        1, 3, (),
        [
            twire.DeltaEntry("x", 99, 0, 5, 5, 0),  # slot out of range
            twire.DeltaEntry("x", 1, 0, 5 * NANO, 0, 0),
            twire.DeltaEntry("\x00pt!x", 1, 0, 5, 5, 0),  # control-channel name
        ],
        max_size=ROW,
    )[0]
    traffic = [good, bytes(bad), oob]
    stats, planes = {}, {}
    for raw_mode in (True, False):
        monkeypatch.setattr(delta_mod, "RAW_INGEST", raw_mode)
        eng = tengine_mod.DeviceEngine(
            TConfig(64, NODES), node_slot=0, clock=lambda: NANO, device="cpu"
        )
        rep = FakeRep(TPURepo(eng, send_incast=None))
        plane = delta_mod.DeltaPlane(rep, flush_interval_s=0)
        try:
            assert (plane.raw_engine() is not None) == raw_mode
            before = profiling.COUNTERS.get("ingest_raw_device_dispatches")
            assert [plane.on_packet(bytes(b), peer) for b in traffic] == [True, False, True]
            assert eng.flush(timeout=30)
            launched = profiling.COUNTERS.get("ingest_raw_device_dispatches") - before
            assert launched == (2 if raw_mode else 0)
            stats[raw_mode] = {
                k: v for k, v in plane.stats().items() if k.startswith("wire_delta_rx")
            }
            stats[raw_mode]["acked"] = len(plane._peers[peer].pending_acks)
            row = eng.directory.lookup("x")
            pn, _ = eng.row_view(row)
            assert int(pn[1, 0]) == 5 * NANO and int(pn[:, 0].sum()) == 5 * NANO
            assert eng.directory.lookup("\x00pt!x") is None
            planes[raw_mode] = eng.snapshot_planes()
        finally:
            eng.stop()
    assert stats[True] == stats[False]
    assert stats[True]["wire_delta_rx_errors"] == 3
    for a, b in zip(planes[True], planes[False]):
        np.testing.assert_array_equal(a, b)
