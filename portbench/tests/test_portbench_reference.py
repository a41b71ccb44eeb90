"""The plain reference against a plain loop over the same intervals."""

import numpy as np

from portbench import streams
from portbench.reference import fold


def loop_state(seed, peers, keys, lanes, cap_nt):
    pn = np.zeros((keys, lanes, 2), np.int64)
    el = np.zeros(keys, np.int64)
    touched = np.zeros(keys, bool)
    for st, n in peers:
        names = st.names(0, n)
        for i in range(n):
            for k in names[i]:
                a, t, e = (int(x) for x in streams.values(seed, st.lane, i, k))
                pn[k, st.lane, 0] = max(pn[k, st.lane, 0], a)
                pn[k, st.lane, 1] = max(pn[k, st.lane, 1], t)
                el[k] = max(el[k], e)
                touched[k] = True
    return pn, el, touched


def test_expected_state_matches_a_plain_loop():
    seed, keys, lanes = 2**31 + 3, 300, 8
    peers = [(streams.Stream(seed, q, 3, q + 2, keys, 7, "zipf"), n)
             for q, n in ((0, 20), (1, 0), (2, 31))]
    want = fold.expected(seed, peers, keys, lanes, 10**11)
    pn, el, touched = loop_state(seed, peers, keys, lanes, 10**11)
    assert np.array_equal(want["pn"], pn)
    assert np.array_equal(want["elapsed"], el)
    assert np.array_equal(want["touched"], touched)
    assert np.array_equal(want["cap"], np.where(touched, 10**11, 0))


def _node_view(want, keys, rows):
    b = rows.max() + 1
    pn = np.zeros((b, want["pn"].shape[1], 2), np.int64)
    el = np.zeros(b, np.int64)
    cap = np.zeros(b, np.int64)
    row_of_key = np.full(keys, -1, np.int64)
    hit = np.flatnonzero(want["touched"])
    row_of_key[hit] = rows[hit]
    pn[rows[hit]], el[rows[hit]], cap[rows[hit]] = want["pn"][hit], want["elapsed"][hit], want["cap"][hit]
    return pn, el, cap, row_of_key


def test_compare_counts_each_kind_of_difference():
    seed, keys = 11, 500
    peers = [(streams.Stream(seed, q, 2, q + 1, keys, 9), 80) for q in range(2)]
    want = fold.expected(seed, peers, keys, 4, 10**11)
    rows = np.random.default_rng(0).permutation(keys) + 3
    pn, el, cap, row_of_key = _node_view(want, keys, rows)
    assert all(v == 0 for v in fold.compare(want, pn, el, cap, row_of_key, 0, 0).values())
    k = int(np.flatnonzero(want["touched"])[7])
    pn[rows[k], 1, 1] += 1
    el[rows[k]] -= 1
    cap[rows[k]] = 0
    got = fold.compare(want, pn, el, cap, row_of_key, 2, 3)
    assert got == {"lane_mismatches": 1, "elapsed_mismatches": 1, "cap_mismatches": 1,
                   "stray_rows": 2, "unacked_intervals": 3}
    row_of_key[k] = -1
    assert fold.compare(want, pn, el, cap, row_of_key, 0, 0)["lane_mismatches"] == 4


def test_the_float64_control_fails():
    seed, keys = 2**31 + 1, 2_000
    peers = [(streams.Stream(seed, q, 3, q + 1, keys, 50), 60) for q in range(3)]
    want = fold.expected(seed, peers, keys, 4, 10**11)
    low = fold.expected(seed, peers, keys, 4, 10**11, dtype=np.float64)
    keyed = np.where(want["touched"], np.arange(keys), -1)
    got = fold.compare(want, low["pn"], low["elapsed"], low["cap"], keyed, 0, 0)
    assert got["lane_mismatches"] > 0.9 * 3 * want["touched"].sum() / 1.5
    assert got["elapsed_mismatches"] > 0
