"""The interval streams that the simulated peers send, made from ``--seed``.

Each simulated peer owns one PN lane and sends a stream of delta
intervals, numbered from 0. Interval ``i`` of peer ``q`` is a pure
function of (seed, q, i): its names and its values can be made again at
any time, by the peer as it sends and by the plain reference after the
run, so the only thing a peer has to report is how many intervals it sent.

* The bind pass comes first: the peers share out every key of the
  configuration, each key to exactly one peer, so that the node binds
  all of them before the window (the last interval of a peer is filled up
  with its own keys again).
* Then random intervals, drawn in blocks of ``BLOCK`` intervals from a
  generator seeded with (seed, q, block): uniform over the keys, or
  Zipf(s) over their ranks, the ranks laid over the keys by a permutation
  drawn from the seed. An interval holds distinct keys, as a node's flush
  sends each dirty (bucket, lane) once: it takes the first ``entries``
  distinct keys of its draws, so under Zipf a hot key is in most
  intervals, once.

Values are absolute lifetime counters in nanotokens, as patrol ships
them. A (key, lane) pair's ``added`` and ``taken`` rise by one token with
every interval of its peer, ``elapsed`` by 20 ms, from bases between 2^56
and 2^61 drawn from the seed: the counters of buckets that have served
for months at 100 tokens a second (2^61 nanotokens is 0.7 years of them),
which a float64 cannot hold to the nanotoken.
"""

from __future__ import annotations

import numpy as np

NANO = 1_000_000_000
BLOCK = 64
NAME_PREFIX = b"k"
NAME_DIGITS = 7
NAME_LEN = len(NAME_PREFIX) + NAME_DIGITS
ADD_STEP = NANO
TAKE_STEP = NANO
ELAPSED_STEP = 20_000_000
BASE = 1 << 56
BASE_SPAN_SHIFT = 4  # bases below 2^56 + 2^60

_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)
_GOLD = np.uint64(0x9E3779B97F4A7C15)


def _mix(x: np.ndarray) -> np.ndarray:
    """splitmix64's finalizer, elementwise on uint64 (wrapping)."""
    x = np.asarray(x, np.uint64)
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * _M1
        x = (x ^ (x >> np.uint64(27))) * _M2
        return x ^ (x >> np.uint64(31))


def seed_word(seed: int, salt: int) -> np.uint64:
    return np.uint64((seed * 0x9E3779B97F4A7C15 + salt * 0xD1B54A32D192ED03) & ((1 << 64) - 1))


def name_bytes(keys: np.ndarray) -> np.ndarray:
    """Key indices → uint8[..., NAME_LEN]: ``k`` and seven decimal digits."""
    keys = np.asarray(keys, np.int64)
    out = np.empty(keys.shape + (NAME_LEN,), np.uint8)
    out[..., 0] = NAME_PREFIX[0]
    rest = keys.copy()
    for d in range(NAME_DIGITS - 1, -1, -1):
        out[..., len(NAME_PREFIX) + d] = 48 + rest % 10
        rest //= 10
    return out


def key_of(name: str) -> int:
    """The key index of a name made by :func:`name_bytes`, or -1."""
    if len(name) != NAME_LEN or not name.startswith("k") or not name[1:].isdigit():
        return -1
    return int(name[1:])


class Stream:
    """Peer ``q`` of ``npeers``, on lane ``lane``: its intervals of
    ``entries`` entries each over ``keys`` keys."""

    def __init__(self, seed: int, q: int, npeers: int, lane: int, keys: int,
                 entries: int, dist: str = "uniform", zipf_s: float = 0.99):
        if keys >= 10 ** NAME_DIGITS:
            raise ValueError(f"{keys} keys do not fit {NAME_DIGITS}-digit names")
        if keys < 2 * entries:
            raise ValueError(f"{keys} keys are too few for intervals of {entries} distinct keys")
        self.seed, self.q, self.lane = seed, q, lane
        self.keys, self.entries, self.dist = keys, entries, dist
        own = np.arange(q, keys, npeers, dtype=np.int64)
        n_bind = -(-own.size // entries)
        pad = n_bind * entries - own.size
        self.bind = np.concatenate([own, own[:pad]]).reshape(n_bind, entries)
        self.n_bind = n_bind
        if dist == "zipf":
            w = 1.0 / np.arange(1, keys + 1, dtype=np.float64) ** zipf_s
            self._cdf = np.cumsum(w) / w.sum()
            self._perm = np.random.default_rng([seed, 1]).permutation(keys)
        elif dist != "uniform":
            raise ValueError(f"unknown key distribution {dist!r}")
        self._blocks: dict = {}

    def _block(self, b: int) -> np.ndarray:
        got = self._blocks.get(b)
        if got is None:
            got = self._distinct(np.random.default_rng([self.seed, 2, self.q, b]))
            if len(self._blocks) > 64:
                self._blocks.clear()
            self._blocks[b] = got
        return got

    def _draw(self, rng, n: int) -> np.ndarray:
        """int64[BLOCK, n]: keys drawn independently from the distribution."""
        if self.dist == "uniform":
            return rng.integers(0, self.keys, (BLOCK, n), dtype=np.int64)
        ranks = np.minimum(np.searchsorted(self._cdf, rng.random((BLOCK, n))), self.keys - 1)
        return self._perm[ranks]

    def _distinct(self, rng) -> np.ndarray:
        """int64[BLOCK, entries]: each interval the first ``entries``
        distinct keys of its draws, in the order drawn, drawing more where
        a row has too few."""
        draws = self._draw(rng, 2 * self.entries)
        while True:
            order = np.argsort(draws, axis=1, kind="stable")
            ranked = np.take_along_axis(draws, order, axis=1)
            first_ranked = np.ones(ranked.shape, bool)
            first_ranked[:, 1:] = ranked[:, 1:] != ranked[:, :-1]
            first = np.empty_like(first_ranked)
            np.put_along_axis(first, order, first_ranked, axis=1)
            if (first.sum(axis=1) >= self.entries).all():
                break
            draws = np.concatenate([draws, self._draw(rng, 2 * self.entries)], axis=1)
        keep = first & (np.cumsum(first, axis=1) <= self.entries)
        return draws[keep].reshape(BLOCK, self.entries)

    def names(self, lo: int, hi: int) -> np.ndarray:
        """Key indices of intervals ``lo`` .. ``hi - 1``: int64[hi - lo, entries]."""
        out = np.empty((hi - lo, self.entries), np.int64)
        at = lo
        while at < hi:
            if at < self.n_bind:
                stop = min(hi, self.n_bind)
                out[at - lo : stop - lo] = self.bind[at:stop]
            else:
                b, off = divmod(at - self.n_bind, BLOCK)
                stop = min(hi, self.n_bind + (b + 1) * BLOCK)
                out[at - lo : stop - lo] = self._block(b)[off : off + stop - at]
            at = stop
        return out

    def values(self, idx: np.ndarray, keys: np.ndarray):
        """(added, taken, elapsed) int64 arrays of this lane's entries for
        keys ``keys`` in intervals ``idx`` (broadcast against each other)."""
        return values(self.seed, self.lane, idx, keys)


def values(seed: int, lane, idx, keys):
    """(added, taken, elapsed) of lane ``lane``'s entries for ``keys`` in
    its peer's intervals ``idx``, as int64 arrays (broadcast together)."""
    keys = np.asarray(keys, np.uint64)
    lane_u = np.asarray(lane, np.uint64)
    n = np.asarray(idx, np.int64) + 1
    with np.errstate(over="ignore"):
        h = _mix(keys * _GOLD ^ (lane_u << np.uint64(40)) ^ seed_word(seed, 3))
        g = _mix(h ^ seed_word(seed, 4))
        e = _mix(keys * _GOLD ^ seed_word(seed, 5))
    span = np.uint64(BASE_SPAN_SHIFT)
    taken = (BASE + (h >> span).astype(np.int64)) + n * TAKE_STEP
    added = (BASE + (g >> span).astype(np.int64)) + n * ADD_STEP
    elapsed = (BASE + (e >> span).astype(np.int64)) + n * ELAPSED_STEP + np.asarray(lane, np.int64)
    return added, taken, elapsed
