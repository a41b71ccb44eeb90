"""The port's delta plane (``patrol_tpu_torch/net/delta.py``) without
sockets: a fake replicator records what the plane sends, and every flush
tick is driven by hand (``flush_interval_s=0``).

* Before any ack, the port resends exactly as the JAX package does (the
  same datagrams, byte for byte).
* The retransmit timeout adapts per peer: each ack is a round-trip
  sample in flush ticks (every interval seq is sent once, so no sample
  is ambiguous), smoothed as in RFC 6298, floored at
  ``retransmit_ticks`` and capped at ``max_retransmit_ticks``; each
  retransmit round doubles it until the next sample.
* A peer whose acks come later than ``retransmit_ticks``: with the timer
  held fixed, every interval is resent before its ack lands and the log
  never empties (the storm of ROADMAP §C); the adaptive timer ends it.
* ``scripts/delta_timer.py`` runs two port nodes on the CPU at a small
  size and reports every chunk drained.
"""

import json

import pytest

from patrol_tpu.net import delta as jdelta
from patrol_tpu.net.replication import ReplyGate as JReplyGate
from patrol_tpu.ops import wire as jwire
from patrol_tpu_torch.models.limiter import NANO
from patrol_tpu_torch.net import delta as tdelta
from patrol_tpu_torch.net.replication import ReplyGate as TReplyGate
from patrol_tpu_torch.ops import wire
from patrol_tpu_torch.scripts import delta_timer

PEER = ("127.0.0.1", 1234)


class _Slots:
    self_slot = 0
    max_slots = 4


class _StubAE:
    def inflight_buckets(self, addr):
        return frozenset()

    def trigger(self, addr, force=False):
        pass


class FakeRep:
    log = None

    def __init__(self, reply_gate):
        self.wire_mode = "delta"
        self.peers = [PEER]
        self.slots = _Slots()
        self.repo = None
        self.antientropy = _StubAE()
        self.reply_gate = reply_gate
        self.sent = []

    def unicast(self, data, addr):
        self.sent.append((data, addr))


PACKAGES = {
    "jax": (jdelta, jwire, JReplyGate),
    "port": (tdelta, wire, TReplyGate),
}


def make_plane(package="port", max_retransmit_ticks=None, **kw):
    mod, _, gate = PACKAGES[package]
    rep = FakeRep(gate())
    kw.setdefault("flush_interval_s", 0)  # manual ticks
    plane = mod.DeltaPlane(rep, **kw)
    if max_retransmit_ticks is not None:
        plane.max_retransmit_ticks = max_retransmit_ticks
    plane.mark_capable(PEER, wire.DELTA_PACKET_SIZE)
    return rep, plane


def offered(w, name, taken):
    cap = 10 * NANO
    return w.from_nanotokens(
        name, cap + 5, taken, 0, origin_slot=0, cap_nt=cap,
        lane_added_nt=5, lane_taken_nt=taken,
    )


def data_seqs(rep):
    """Seqs of the data-bearing delta datagrams sent since the last call."""
    out = []
    for data, _ in rep.sent:
        pkt = wire.decode_delta_packet(data)
        if pkt is not None and pkt.seq:
            out.append(pkt.seq)
    rep.sent.clear()
    return out


def ack(seq):
    return wire.encode_delta_packet(1, 0, [seq], ())[0]


def timeout_ticks(plane):
    return plane.lag_stats()[PEER]["retransmit_timeout_ticks"]


def test_resends_like_the_reference_before_any_ack():
    """No ack yet: both packages send the same datagrams on the same
    ticks, the resend under a fresh seq with the current value."""
    sent = {}
    for package, (_, w, _) in PACKAGES.items():
        rep, plane = make_plane(package, retransmit_ticks=2)
        plane.offer([offered(w, "b", 1)])
        for _ in range(3):
            plane.flush()
        plane.offer([offered(w, "c", 4)])
        plane.flush()
        sent[package] = [data for data, _ in rep.sent]
        assert plane.stats()["wire_interval_retransmits"] == 1
    assert sent["port"] == sent["jax"]
    assert [wire.decode_delta_packet(d).seq for d in sent["port"]] == [1, 2, 3]


@pytest.mark.parametrize(
    "max_retransmit_ticks, resend_ticks",
    [(500, [3, 7, 15, 31]), (6, [3, 7, 13, 19]), (0, [3, 5, 7, 9])],
    ids=["doubling", "capped", "fixed"],
)
def test_unacked_rounds_back_off(max_retransmit_ticks, resend_ticks):
    """An interval never acked is resent after 2, then 4, 8, 16 ticks —
    never past the cap; a cap under the floor holds the timer fixed."""
    rep, plane = make_plane(
        retransmit_ticks=2, max_retransmit_ticks=max_retransmit_ticks
    )
    plane.offer([offered(wire, "b", 1)])
    plane.flush()
    assert data_seqs(rep) == [1]
    got = []
    for tick in range(2, resend_ticks[-1] + 1):
        plane.flush()
        if data_seqs(rep):
            got.append(tick)
    assert got == resend_ticks
    assert plane.stats()["wire_interval_retransmits"] == len(resend_ticks)


def test_ack_round_trip_sets_the_timeout():
    """Acks of intervals sent at tick 1 and acked at 7, then at 8 and
    acked at 14: srtt 6 and rttvar 3 → 6 + 4·3 = 18 ticks, then srtt
    6, rttvar 2.25 → 15. A floor above that wins."""
    for floor, want in ((8, [18, 15]), (20, [20, 20])):
        rep, plane = make_plane(retransmit_ticks=floor)
        assert timeout_ticks(plane) == floor
        got = []
        for seq, (sent_at, acked_at) in enumerate(((1, 7), (8, 14)), start=1):
            while plane._tick < sent_at - 1:
                plane.flush()
            plane.offer([offered(wire, f"b{seq}", seq)])
            plane.flush()
            assert data_seqs(rep) == [seq]
            while plane._tick < acked_at:
                plane.flush()
            plane.on_packet(ack(seq), PEER)
            got.append(timeout_ticks(plane))
        assert got == want
        assert plane.lag_stats()[PEER]["srtt_ticks"] == 6.0
        assert plane.stats()["wire_interval_retransmits"] == 0


@pytest.mark.parametrize("timer", ["fixed", "adaptive"])
def test_acks_later_than_the_floor(timer):
    """The peer acks each seq 6 ticks after it was sent; new state is
    offered on each of the first 20 ticks, and the floor is 2 ticks.
    Held fixed, the timer resends every interval before its ack lands:
    the log never empties and resends never stop. The adaptive timer
    backs off until an ack matches, then waits out the measured round
    trip: two resends, and the log drains."""
    rep, plane = make_plane(
        retransmit_ticks=2, max_retransmit_ticks=0 if timer == "fixed" else 500
    )
    delay, acks_due = 6, {}
    for tick in range(1, 81):
        for seq in acks_due.pop(tick, ()):
            plane.on_packet(ack(seq), PEER)
        if tick <= 20:
            plane.offer([offered(wire, f"b{tick}", tick)])
        plane.flush()
        acks_due.setdefault(tick + delay, []).extend(data_seqs(rep))
    st = plane.stats()
    if timer == "fixed":
        assert st["wire_intervals_unacked"] > 0
        assert st["wire_interval_retransmits"] >= 30
    else:
        assert st["wire_intervals_unacked"] == 0
        assert st["wire_interval_retransmits"] == 2
        # Each ack is read before the flush that ends its tick.
        assert plane.lag_stats()[PEER]["srtt_ticks"] == float(delay - 1)


def test_delta_timer_script_on_cpu(tmp_path):
    """Two CPU nodes, 1,000 paced takes, the adaptive timer: both chunks
    drain, and the rows file holds one row per chunk with the plane's
    round trip and timeout."""
    out = tmp_path / "rows.jsonl"
    (summary,) = delta_timer.main([
        "--device", "cpu", "--timer", "adaptive", "--buckets", "4096",
        "--lanes", "8", "--takes", "1000", "--out", str(out),
    ])
    assert summary["timer"] == "adaptive" and summary["card"] == "cpu"
    assert summary["drained"] and summary["chunks"] == 2
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["chunk"] for r in rows] == [0, 1]
    for r in rows:
        assert len(r["timeout_ticks"]) == 2 and min(r["timeout_ticks"]) >= 8
        assert r["data_datagrams"][0] > 0 and r["data_datagrams"][1] > 0
