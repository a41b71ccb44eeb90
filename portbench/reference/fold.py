"""The plain reference for the delta cells: what the node's state must be.

patrol's replicated state is a PN-counter CRDT: for every bucket, one
(added, taken) pair of lifetime counters a node lane, and one ``elapsed``
G-counter a bucket; joining a delta takes the elementwise maximum. So once
a peer's intervals are all acknowledged, the node holds, for every key a
peer sent and that peer's lane, the values of the last interval of that
peer that carried the key; ``elapsed`` is the largest any peer sent; the
capacity base is the one every entry carries; lanes that no peer owns,
the node's own among them, hold nothing; and no other key is bound.

This module works that out again from the streams the peers sent (how many
intervals each one sent is all it takes from the run) with numpy alone,
and counts where the node's planes differ. It imports nothing of the
program. ``dtype`` is the precision of the join: ``int64``, as patrol
states it, or ``float64`` for the control, which rounds counters above
2^53 and must fail.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from portbench import streams

LIMITS = {
    "lane_mismatches": 0,
    "elapsed_mismatches": 0,
    "cap_mismatches": 0,
    "stray_rows": 0,
    "unacked_intervals": 0,
}


def last_interval(stream: streams.Stream, n_sent: int, chunk: int = 4096,
                  used: Optional[int] = None) -> np.ndarray:
    """int64[keys]: the last of a peer's first ``n_sent`` intervals that
    carried each key among its first ``used`` entries (all of them by
    default), or -1."""
    last = np.full(stream.keys, -1, np.int64)
    for lo in range(0, n_sent, chunk):
        hi = min(lo + chunk, n_sent)
        names = stream.names(lo, hi)[:, :used]
        idx = np.repeat(np.arange(lo, hi, dtype=np.int64), names.shape[1])
        np.maximum.at(last, names.ravel(), idx)
    return last


def _join(vals: np.ndarray, dtype) -> np.ndarray:
    """The values as a join in ``dtype`` leaves them."""
    if np.dtype(dtype) == np.int64:
        return vals
    return vals.astype(dtype).astype(np.int64)


def expected(seed: int, peers: Iterable[Tuple[streams.Stream, int]], keys: int, lanes: int,
             cap_nt: int, dtype=np.int64, used: Optional[int] = None) -> Dict[str, np.ndarray]:
    """The state the node must hold after ``peers`` — (stream, intervals
    sent) pairs — were all acknowledged: ``pn`` int64[keys, lanes, 2],
    ``elapsed`` and ``cap`` int64[keys], ``touched`` bool[keys]. ``used``
    folds only each interval's first ``used`` entries (a fault)."""
    pn = np.zeros((keys, lanes, 2), np.int64)
    elapsed = np.zeros(keys, np.int64)
    touched = np.zeros(keys, bool)
    for stream, n_sent in peers:
        last = last_interval(stream, n_sent, used=used)
        hit = np.flatnonzero(last >= 0)
        added, taken, el = streams.values(seed, stream.lane, last[hit], hit)
        pn[hit, stream.lane, 0] = _join(added, dtype)
        pn[hit, stream.lane, 1] = _join(taken, dtype)
        np.maximum.at(elapsed, hit, _join(el, dtype))
        touched[hit] = True
    cap = np.where(touched, _join(np.full(keys, cap_nt, np.int64), dtype), 0)
    return {"pn": pn, "elapsed": elapsed, "cap": cap, "touched": touched}


def faulted(seed: int, peers, keys: int, lanes: int, cap_nt: int) -> Dict[str, dict]:
    """The reference with a fault planted, each in the program's place:
    ``state_unchanged``, every fold of the window leaving the state as the
    bind pass left it; ``half_the_batch``, each interval folding only its
    first half of entries."""
    peers = list(peers)
    return {
        "state_unchanged": expected(seed, [(st, min(n, st.n_bind)) for st, n in peers],
                                    keys, lanes, cap_nt),
        "half_the_batch": expected(seed, peers, keys, lanes, cap_nt,
                                   used=max(1, peers[0][0].entries // 2)),
    }


def compare(want: Dict[str, np.ndarray], pn: np.ndarray, elapsed: np.ndarray,
            cap: np.ndarray, row_of_key: np.ndarray, stray_rows: int,
            unacked: int) -> Dict[str, int]:
    """Counts of what differs between ``want`` and the node's planes
    (``pn[B, N, 2]``, ``elapsed[B]``, ``cap[B]``) read through
    ``row_of_key`` (int64[keys], -1 where the node bound no row).
    ``stray_rows`` counts rows the node bound for no key the peers sent;
    ``unacked`` the intervals it never acknowledged."""
    touched = want["touched"]
    keys = np.flatnonzero(touched)
    rows = row_of_key[keys]
    bound = rows >= 0
    missing = int((~bound).sum())
    unwanted = int(((row_of_key >= 0) & ~touched).sum())
    r = rows[bound]
    k = keys[bound]
    lane_bad = (pn[r] != want["pn"][k]).any(axis=2)
    return {
        "lane_mismatches": int(lane_bad.sum()) + missing * pn.shape[1],
        "elapsed_mismatches": int((elapsed[r] != want["elapsed"][k]).sum()) + missing,
        "cap_mismatches": int((cap[r] != want["cap"][k]).sum()) + missing,
        "stray_rows": int(stray_rows) + unwanted,
        "unacked_intervals": int(unacked),
    }
