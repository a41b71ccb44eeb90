"""The raw-plane structure walk, numpy against C++, on one host.

    python3 -m patrol_tpu_torch.scripts.walk_ab [--out FILE] [--seed N]

Times ``ops/ingest.py``'s ``host_walk_plain`` (numpy, one loop step per
entry ordinal) against the native walk (``pt_walk_batch``) on batches of
P = 1, 4, 16 and 512 rx ring rows (8 KiB each, random stale bytes past
every datagram). Each row is one dv2 interval of 189 distinct keys drawn
Zipf(0.99) over 10,000 keys, named ``k`` and seven digits, with lifetime
counters between 2^56 and 2^61 nanotokens and two acks: the intervals
the deltas benchmark's peers send. A time is the median over 5 loops of
the mean wall time of a call, in ms; both walks must give the same walk
on every batch (exit 1 otherwise). Host code only: no card is used.
Prints one JSON object and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import statistics
import sys
import time

import numpy as np

from patrol_tpu_torch.ops import ingest, wire

KEYS, ENTRIES, ZIPF_S = 10_000, 189, 0.99
SIZES = (1, 4, 16, 512)
LOOPS = 5


def intervals(seed: int, n: int) -> list:
    """``n`` encoded dv2 intervals of ``ENTRIES`` distinct Zipf keys."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, KEYS + 1, dtype=np.float64) ** ZIPF_S
    cdf = np.cumsum(w) / w.sum()
    perm = rng.permutation(KEYS)
    out = []
    for i in range(n):
        keys: list = []
        while len(keys) < ENTRIES:
            for k in perm[np.minimum(np.searchsorted(cdf, rng.random(2 * ENTRIES)), KEYS - 1)]:
                if k not in keys and len(keys) < ENTRIES:
                    keys.append(int(k))
        vals = rng.integers(1 << 56, 1 << 61, (ENTRIES, 4))
        ents = [wire.DeltaEntry(f"k{k:07d}", 1, *map(int, v)) for k, v in zip(keys, vals)]
        data, got = wire.encode_delta_packet(1, i + 1, [i, i + 1], ents)
        if got != ENTRIES:
            raise RuntimeError(f"an interval held {got} of {ENTRIES} entries")
        out.append(data)
    return out


def batch(rng, pool: list, P: int):
    planes = rng.integers(0, 256, (P, ingest.RAW_PLANE_BYTES)).astype(np.uint8)
    lengths = np.zeros(P, np.int32)
    for i in range(P):
        b = pool[int(rng.integers(0, len(pool)))]
        planes[i, : len(b)] = np.frombuffer(b, np.uint8)
        lengths[i] = len(b)
    return planes, lengths


def per_call_ms(fn, planes, lengths, calls: int) -> float:
    fn(planes, lengths)
    loops = []
    for _ in range(LOOPS):
        t0 = time.perf_counter_ns()
        for _ in range(calls):
            fn(planes, lengths)
        loops.append((time.perf_counter_ns() - t0) / calls / 1e6)
    return statistics.median(loops)


def native_walk(planes, lengths):
    walk = ingest._host_walk_native(planes, lengths)
    if walk is None:
        raise RuntimeError("the native library did not load")
    return walk


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=20261019)
    args = ap.parse_args(argv)
    pool = intervals(args.seed, 64)
    rng = np.random.default_rng(args.seed + 1)
    rows, same = [], True
    for P in SIZES:
        planes, lengths = batch(rng, pool, P)
        a, b = native_walk(planes, lengths), ingest.host_walk_plain(planes, lengths)
        same &= all(np.array_equal(x, y) and x.dtype == y.dtype for x, y in zip(a, b))
        same &= bool(b.ok.all())
        calls = max(1, 64 // P)
        plain = per_call_ms(ingest.host_walk_plain, planes, lengths, calls)
        nat = per_call_ms(native_walk, planes, lengths, 16 * calls)
        rows.append({"P": P, "entries": int(b.count.sum()), "plain_ms": plain,
                     "native_ms": nat, "speedup": plain / nat})
    out = {"host": platform.processor() or platform.machine(), "cpus": os.cpu_count(),
           "python": sys.version.split()[0], "numpy": np.__version__,
           "same_walk": same, "rows": rows}
    text = json.dumps(out)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
