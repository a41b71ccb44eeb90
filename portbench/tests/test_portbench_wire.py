"""The benchmark's dv2 framing and streams against the program's codec."""

import types

import numpy as np
import pytest

from portbench import dv2, peers, streams


@pytest.mark.parametrize("dist", ["uniform", "zipf"])
def test_datagrams_decode_in_the_programs_codec(dist):
    wire = pytest.importorskip("patrol_tpu_torch.ops.wire")
    e = dv2.capacity(8192, streams.NAME_LEN)
    st = streams.Stream(2**31 + 5, 1, 3, 7, 10_000, e, dist)
    for lo in (0, st.n_bind - 1, st.n_bind + 70):
        idx = np.arange(lo, lo + 2)
        keys = st.names(lo, lo + 2)
        added, taken, el = st.values(idx[:, None], keys)
        raw = dv2.encode(7, idx + 1, streams.name_bytes(keys), 7, 10**11, added, taken, el)
        assert raw.shape == (2, dv2.datagram_size(e, streams.NAME_LEN)) and raw.shape[1] <= 8192
        for d in range(2):
            pkt = wire.decode_delta_packet(raw[d].tobytes())
            assert pkt is not None and pkt.sender_slot == 7 and pkt.seq == lo + d + 1
            assert [x.name for x in pkt.entries] == [f"k{k:07d}" for k in keys[d]]
            assert [(x.slot, x.cap_nt, x.added_nt, x.taken_nt, x.elapsed_ns)
                    for x in pkt.entries] == [
                (7, 10**11, int(a), int(t), int(v))
                for a, t, v in zip(added[d], taken[d], el[d])]


def test_acks_of_reads_the_programs_ack_vectors():
    wire = pytest.importorskip("patrol_tpu_torch.ops.wire")
    bare, _ = wire.encode_delta_packet(0, 0, [1, 9, 2**32 - 1], [])
    assert dv2.acks_of(bare) == [1, 9, 2**32 - 1]
    data, _ = wire.encode_delta_packet(3, 4, [5], [wire.DeltaEntry("a", 1, 2, 3, 4, 5)])
    assert dv2.acks_of(data) == [5]
    bad = bytearray(bare)
    bad[-1] ^= 1
    assert dv2.acks_of(bytes(bad)) is None
    assert dv2.acks_of(b"\x00" * 10) is None


def test_streams_are_a_function_of_seed_peer_and_interval():
    a = streams.Stream(99, 2, 5, 3, 50_000, 189, "uniform")
    b = streams.Stream(99, 2, 5, 3, 50_000, 189, "uniform")
    assert np.array_equal(a.names(a.n_bind + 100, a.n_bind + 300), b.names(a.n_bind + 100, a.n_bind + 300))
    assert np.array_equal(a.names(0, a.n_bind + 70)[5:], b.names(5, a.n_bind + 70))
    c = streams.Stream(100, 2, 5, 3, 50_000, 189, "uniform")
    assert not np.array_equal(a.names(a.n_bind, a.n_bind + 4), c.names(c.n_bind, c.n_bind + 4))


def test_the_bind_pass_covers_every_key_once_across_peers():
    keys, npeers, e = 10_007, 6, 189
    seen = np.concatenate([streams.Stream(1, q, npeers, q + 1, keys, e).bind.ravel()
                           for q in range(npeers)])
    assert np.array_equal(np.unique(seen), np.arange(keys))


def test_zipf_keys_are_skewed():
    st = streams.Stream(3, 0, 2, 1, 10_000, 189, "zipf", 0.99)
    n = st.names(st.n_bind, st.n_bind + 256).ravel()
    counts = np.sort(np.bincount(n, minlength=10_000))[::-1]
    assert counts[0] == 256  # the hottest key is in every interval, once
    assert counts[:100].sum() > 0.25 * n.size
    assert (counts > 0).sum() > 2_000


def test_counters_stay_within_int64_and_above_float64s_exact_range():
    added, taken, el = streams.values(2**31 + 9, 63, np.array([10**8]), np.arange(1000))
    for v in (added, taken, el):
        assert v.min() > 2**56 and v.max() < 2**62
    assert (added.astype(np.float64).astype(np.int64) != added).mean() > 0.9


@pytest.mark.parametrize("dist,keys", [("uniform", 1_000_000), ("zipf", 10_000)])
def test_each_interval_holds_distinct_keys(dist, keys):
    st = streams.Stream(2**33 + 7, 1, 2, 3, keys, 189, dist)
    names = st.names(0, st.n_bind + 3 * streams.BLOCK)
    assert all(np.unique(row).size == 189 for row in names)
    again = streams.Stream(2**33 + 7, 1, 2, 3, keys, 189, dist)
    assert np.array_equal(again.names(st.n_bind + 64, st.n_bind + 130),
                          names[st.n_bind + 64 : st.n_bind + 130])


@pytest.mark.parametrize("srtt,rttvar,backoff", [
    (None, 0.0, 0), (None, 0.0, 3), (3.0, 0.2, 0), (9.6, 2.4, 0), (9.6, 2.4, 2),
    (30.2, 11.0, 1), (12.0, 0.1, 6)])
def test_the_peers_retransmit_timer_is_the_ports(srtt, rttvar, backoff):
    delta = pytest.importorskip("patrol_tpu_torch.net.delta")
    st = delta._PeerDelta()
    st.srtt, st.rttvar, st.backoff = srtt, rttvar, backoff
    plane = types.SimpleNamespace(retransmit_ticks=8, max_retransmit_ticks=delta.MAX_RETRANSMIT_TICKS)
    want = delta.DeltaPlane._timeout_locked(plane, st)
    peer = peers.Peer(None, types.SimpleNamespace(n_bind=0), None, 4,
                      (0.02, 8, delta.MAX_RETRANSMIT_TICKS), 1)
    peer.srtt, peer.rttvar, peer.backoff = srtt, rttvar, backoff
    assert peer.rto() == pytest.approx(want * 0.02)


class _Sock:
    """A socket stand-in that keeps what is sent."""

    def __init__(self):
        self.sent = []

    def sendto(self, data, addr):
        self.sent.append(data)


def _paced_peer(seed, q, window=64, per_tick=10):
    st = streams.Stream(seed, q, 2, q, 10_000, 189, "zipf")
    return peers.Peer(_Sock(), st, None, window, (0.02, 8, 500), 1, per_tick)


@pytest.mark.parametrize("q", [0, 1])
def test_every_seed_gets_the_same_ticks_in_another_order(q):
    a, b = _paced_peer(2**31 + 1, q), _paced_peer(2**40 + 7, q)
    a.schedule(100.0, 54.0, [10, 30], q, 2, 2**31 + 1)
    b.schedule(100.0, 54.0, [10, 30], q, 2, 2**40 + 7)
    gaps_a, gaps_b = np.diff(a.ticks), np.diff(b.ticks)
    assert len(a.ticks) == len(b.ticks) == int(54.0 / 0.02)
    assert not np.allclose(gaps_a, gaps_b)
    assert np.allclose(np.sort(np.append(gaps_a, 54.0 - gaps_a.sum())),
                       np.sort(np.append(gaps_b, 54.0 - gaps_b.sum())))
    assert gaps_a.min() >= 0.01 - 1e-12 and gaps_a.max() <= 0.03 + 1e-12
    assert a.ticks[0] == pytest.approx(100.0 + 0.02 * q / 2)


def test_a_paced_peer_sends_each_tick_its_burst_and_holds_what_the_window_will_not_take():
    p = _paced_peer(2**31 + 3, 0, window=15, per_tick=10)
    n_bind = p.stream.n_bind
    p.next_i, p.bound_left = n_bind, 0  # past the bind pass
    p.schedule(10.0, 1.0, [10, 30], 0, 2, 2**31 + 3)
    t0, t1 = 10.0, 11.0
    p.fill(9.99, True, t0, t1)
    assert not p.sock.sent  # nothing before its first tick
    p.fill(p.ticks[1] + 1e-4, True, t0, t1)
    assert len(p.sock.sent) == 15  # 20 due, the window takes 15
    assert p.next_due() == float("inf")  # only an ack frees a place
    at = p.ticks[1] + 0.002  # before the third tick, at least 10 ms on
    p.on_acks(list(range(n_bind + 1, n_bind + 16)), at, t0, t1)
    p.fill(at, True, t0, t1)
    assert len(p.sock.sent) == 20
    p.on_acks(list(range(n_bind + 16, n_bind + 21)), at + 0.001, t0, t1)
    # The first tick's ten and the second's first five, then the held
    # five, which count from their tick, not from when they went.
    want = [at - p.ticks[0]] * 10 + [at - p.ticks[1]] * 5 + [at + 0.001 - p.ticks[1]] * 5
    assert p.w_latency == pytest.approx(want)
    # Past t1 nothing due at or after t1 is sent, and nothing is pending.
    assert p.next_due() == p.ticks[2]
    p.fill(12.0, False, t0, t1)
    while p.unacked:
        p.on_acks(list(p.unacked), 12.0, t0, t1)
        p.fill(12.0, False, t0, t1)
    assert not p.pending(t1)
    assert p.next_i == n_bind + 10 * int(np.searchsorted(p.ticks, t1))


def test_latency_percentiles():
    got = peers.percentiles([0.001 * k for k in range(1, 101)])
    assert got["n"] == 100 and got["p50"] == pytest.approx(50.5)
    assert got["p95"] == pytest.approx(95.05) and got["max"] == pytest.approx(100.0)
    assert peers.percentiles([]) == {"n": 0}
